"""Untrimmed long-video chunk enumeration for the eval galleries.

The reference's LongVideoDataset (dataloader_baseline.py:33-76) splits every
gallery video's full frame range into contiguous ``test_frames``-size chunks
(last chunk partial, padded at read time by the repeat policy), reads each
with CenterCrop, and tags it (long_video_id, seg_id) so per-chunk features can
be re-concatenated into one [C, T_total] feature tape per video.

Note the upstream indexing subtlety preserved by sampling.sample_frame_indices:
chunk starts are 0-based offsets handed to read_video as ``start_frame_idx``,
so full chunks read files [start, start+n-1] (clamped ≥ 1) while partial
chunks read [start+1, ...] via the repeat branch.

A copy of vqwild_tpu/data/longvideo.py (host code).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from vqwild_tpu_torch.data.clips import (
    batch_cropped_clips,
    batch_cropped_clips_yuv,
    read_clip_raw,
    read_clip_yuv,
)
from vqwild_tpu_torch.data.frames import FrameStore
from vqwild_tpu_torch.data.sampling import chunk_ranges
from vqwild_tpu_torch.data.schema import VideoRecord


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    video_idx: int  # index into the gallery list
    seg_id: int  # chunk position within the video
    start_frame_idx: int  # 0-based chunk start
    gt_frame_num: int  # frames actually inside the chunk


def enumerate_chunks(
    gallery: Sequence[VideoRecord], store: FrameStore, test_frames: int
) -> List[ChunkRef]:
    refs: List[ChunkRef] = []
    for vi, rec in enumerate(gallery):
        total = store.num_frames(rec.activitynet_subset, rec.video_id)
        for seg_id, (start, n) in enumerate(chunk_ranges(total, test_frames)):
            refs.append(ChunkRef(vi, seg_id, start, n))
    return refs


def read_chunk_batch(
    refs: Sequence[ChunkRef],
    gallery: Sequence[VideoRecord],
    store: FrameStore,
    test_frames: int,
    crop_size: int = 112,
    fps: int = 3,
) -> np.ndarray:
    """Batch of chunks → cropped uint8 clips [N,T,s,s,C] (CenterCrop)."""
    clips = [
        read_clip_raw(
            store,
            gallery[r.video_idx],
            test_frames,
            fps=fps,
            rng=None,  # CenterCrop at eval
            crop_size=crop_size,
            start_frame_idx=r.start_frame_idx,
            gt_frame_num=r.gt_frame_num,
        )
        for r in refs
    ]
    return batch_cropped_clips(clips)


def read_chunk_batch_yuv(
    refs: Sequence[ChunkRef],
    gallery: Sequence[VideoRecord],
    store: FrameStore,
    test_frames: int,
    crop_size: int = 112,
    fps: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """YUV-native chunk batch → (y [N,T,s,s], uv [N,T,s/2,s/2,2]) uint8."""
    clips = [
        read_clip_yuv(
            store,
            gallery[r.video_idx],
            test_frames,
            fps=fps,
            rng=None,
            crop_size=crop_size,
            start_frame_idx=r.start_frame_idx,
            gt_frame_num=r.gt_frame_num,
        )
        for r in refs
    ]
    return batch_cropped_clips_yuv(clips, crop_size)


def concat_video_tapes(
    chunk_feats: np.ndarray, refs: Sequence[ChunkRef], num_videos: int
) -> List[np.ndarray]:
    """Per-chunk [N, C, T_chunk] features → per-video [C, T_total] tapes,
    chunks ordered by seg_id (dataloader_baseline.py:778-784)."""
    per_video: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(num_videos)]
    for feat, ref in zip(chunk_feats, refs):
        per_video[ref.video_idx].append((ref.seg_id, feat))
    tapes = []
    for segs in per_video:
        segs.sort(key=lambda p: p[0])
        tapes.append(
            np.concatenate([f for _, f in segs], axis=1)
            if segs
            else np.zeros((0, 0), dtype=np.float32)
        )
    return tapes
