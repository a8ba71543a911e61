"""Clip reading: record → uint8 frame stack (+ crop params).

Composes FrameStore + sampling policy + transform parameterization into the
single host-side operation the loaders use. Decoding stays uint8 end-to-end;
crop/flip/normalize run fused on device (ops/preprocess.py). A float parity
path (`read_clip_normalized`) reproduces the reference's host-side pipeline
(utils_dataset.py:96-147) bit-for-bit for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from vqwild_tpu_torch.data import transforms
from vqwild_tpu_torch.data.frames import FrameStore
from vqwild_tpu_torch.data.sampling import sample_frame_indices, segment_to_frames
from vqwild_tpu_torch.data.schema import VideoRecord


@dataclasses.dataclass
class RawClip:
    """Device-ready raw clip: uint8 frames + crop/flip to apply on device."""

    frames: np.ndarray  # [T, H, W, C] uint8
    crop: transforms.CropParams
    label: int = -1


def read_clip_raw(
    store: FrameStore,
    record: VideoRecord,
    out_frames: int,
    fps: int = 3,
    rng: Optional[np.random.Generator] = None,
    crop_size: int = 112,
    start_frame_idx: Optional[int] = None,
    gt_frame_num: Optional[int] = None,
) -> RawClip:
    """Read a clip's raw frames; sample crop params (random iff rng given).

    start_frame_idx/gt_frame_num override the segment-derived range — used by
    the long-video chunker which addresses explicit frame windows.
    """
    if start_frame_idx is None or gt_frame_num is None:
        start_frame_idx, gt_frame_num = segment_to_frames(record.segment, fps)
    total = store.num_frames(record.activitynet_subset, record.video_id)
    idx = sample_frame_indices(start_frame_idx, gt_frame_num, out_frames, total)
    frames = store.read_frames(record.activitynet_subset, record.video_id, idx)
    h, w = frames.shape[1], frames.shape[2]
    if rng is not None:
        crop = transforms.random_crop_params(rng, h, w, crop_size)
    else:
        crop = transforms.center_crop_params(h, w, crop_size)
    return RawClip(frames=frames, crop=crop)


def draw_crop_unread(
    store: FrameStore,
    record: VideoRecord,
    out_frames: int,
    fps: int = 3,
    rng: Optional[np.random.Generator] = None,
    crop_size: int = 112,
    yuv: bool = False,
) -> transforms.CropParams:
    """The crop that ``read_clip_raw`` (``read_clip_yuv`` when ``yuv``)
    would draw from ``rng`` for this clip, without reading its frames: the
    generator advances as the read would advance it. The frame size comes
    from the store's ``real_dims`` (YUV stores) or from the clip's first
    frame."""
    if yuv:
        h, w = store.real_dims(record.activitynet_subset)
    else:
        start_frame_idx, gt_frame_num = segment_to_frames(record.segment, fps)
        total = store.num_frames(record.activitynet_subset, record.video_id)
        idx = sample_frame_indices(start_frame_idx, gt_frame_num, out_frames, total)
        h, w = store.read_frames(record.activitynet_subset, record.video_id, idx[:1]).shape[1:3]
    if rng is not None:
        return transforms.random_crop_params(rng, h, w, crop_size)
    return transforms.center_crop_params(h, w, crop_size)


def read_clip_normalized(
    store: FrameStore,
    record: VideoRecord,
    out_frames: int,
    fps: int = 3,
    rng: Optional[np.random.Generator] = None,
    crop_size: int = 112,
    start_frame_idx: Optional[int] = None,
    gt_frame_num: Optional[int] = None,
) -> np.ndarray:
    """Host-side parity path: [T, crop, crop, C] float32 normalized."""
    clip = read_clip_raw(
        store, record, out_frames, fps, rng, crop_size, start_frame_idx, gt_frame_num
    )
    cropped = transforms.apply_crop(clip.frames, clip.crop)
    return transforms.normalize_imagenet(cropped)


@dataclasses.dataclass
class RawClipYUV:
    """Device-ready clip in 4:2:0 planes (even-padded); crop params are in
    real-frame coordinates and never reach the padding."""

    y: np.ndarray  # [T, hp, wp] uint8
    uv: np.ndarray  # [T, hp/2, wp/2, 2] uint8
    crop: transforms.CropParams
    label: int = -1


def read_clip_yuv(
    store: FrameStore,
    record: VideoRecord,
    out_frames: int,
    fps: int = 3,
    rng: Optional[np.random.Generator] = None,
    crop_size: int = 112,
    start_frame_idx: Optional[int] = None,
    gt_frame_num: Optional[int] = None,
) -> RawClipYUV:
    """YUV-native read (stores with ``supports_yuv``): same sampling policy
    and crop parameterization as read_clip_raw, zero RGB materialization."""
    if start_frame_idx is None or gt_frame_num is None:
        start_frame_idx, gt_frame_num = segment_to_frames(record.segment, fps)
    subset = record.activitynet_subset
    total = store.num_frames(subset, record.video_id)
    idx = sample_frame_indices(start_frame_idx, gt_frame_num, out_frames, total)
    y, uv = store.read_frames_yuv(subset, record.video_id, idx)
    h, w = store.real_dims(subset)
    if rng is not None:
        crop = transforms.random_crop_params(rng, h, w, crop_size)
    else:
        crop = transforms.center_crop_params(h, w, crop_size)
    return RawClipYUV(y=y, uv=uv, crop=crop)


def batch_cropped_clips_yuv(clips, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stack RawClipYUVs with crop/flip applied in the planes →
    (y [B,T,s,s], uv [B,T,s/2,s/2,2]) uint8."""
    from vqwild_tpu_torch.ops.preprocess import crop_yuv420_host

    offsets = np.array([[c.crop.top, c.crop.left] for c in clips], np.int32)
    flips = np.array([c.crop.flip for c in clips], bool)
    return crop_yuv420_host([c.y for c in clips], [c.uv for c in clips], offsets, flips, size)


def batch_raw_clips(clips) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack RawClips → (frames [B,T,H,W,C] u8, offsets [B,2] i32, flips [B] bool)."""
    frames = np.stack([c.frames for c in clips], axis=0)
    offsets = np.array([[c.crop.top, c.crop.left] for c in clips], dtype=np.int32)
    flips = np.array([c.crop.flip for c in clips], dtype=bool)
    return frames, offsets, flips


def batch_cropped_clips(clips) -> np.ndarray:
    """Stack RawClips with their crop/flip applied on host → [B,T,s,s,C] u8.

    The production path: cropped uint8 is the smallest host→device transfer,
    and normalization runs on the device (ops/preprocess.py)."""
    return np.stack(
        [transforms.apply_crop(c.frames, c.crop) for c in clips], axis=0
    )
