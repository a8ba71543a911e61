"""Frame sampling policy as pure functions.

Mirrors the reference's segment→frame math and temporal sampling exactly
(utils_dataset.py:77-141):

* ``segment_to_frames``: seconds → (start_frame_idx, frame_count) at fps=3.
* ``sample_frame_indices``: if the GT segment has fewer frames than requested,
  cycle-repeat from the start; else uniform ``np.linspace`` subsample. Indices
  are 1-based file numbers clamped to [1, total_frames].

These are pure so they can be property-tested and reused on host (JPEG reader)
or device (packed-array gather) identically.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def segment_to_frames(segment: Tuple[float, float], fps: int = 3) -> Tuple[int, int]:
    """(start_frame_idx, frame_duration_num) — utils_dataset.py:77-85."""
    start = int(segment[0] * fps)
    count = int((segment[1] - segment[0]) * fps)
    return start, count


def sample_frame_indices(
    start_frame_idx: int,
    gt_frame_num: int,
    out_frame_num: int,
    total_frames: int,
) -> np.ndarray:
    """1-based frame file indices, shape [out_frame_num] (utils_dataset.py:104-141).

    gt_frame_num must be >= 1 (the reference raises on 0-frame segments,
    dataloader_baseline.py:274-275).
    """
    if gt_frame_num <= 0:
        raise ValueError("segment has no frames")
    if gt_frame_num < out_frame_num:
        # repeat from start: frame i uses offset i % gt_frame_num, +1 (1-based)
        locs = start_frame_idx + (np.arange(out_frame_num) % gt_frame_num) + 1
    else:
        # uniform subsample over [start, start+gt-1]; floor to int like read_img
        locs = np.floor(
            np.linspace(
                start_frame_idx,
                start_frame_idx + gt_frame_num - 1,
                num=out_frame_num,
            )
        ).astype(np.int64)
    # clamp into [1, total_frames] (utils_dataset.py:108-113)
    return np.clip(locs, 1, total_frames).astype(np.int64)


def temporal_iou(min1, max1, min2, max2) -> float:
    """calculate_iou (dataloader_baseline.py:1095-1097): plain interval IoU,
    union spans min..max even when disjoint. Lives here (dependency-free)
    so offline tools (datagen stats) share the retrieval engine's exact
    interval math with no framework import."""
    overlap = max(0.0, min(max1, max2) - max(min1, min2))
    return overlap * 1.0 / (max(max2, max1) - min(min1, min2))


def chunk_ranges(total: int, chunk: int) -> list:
    """Contiguous [start, length] chunks covering range(total), last partial —
    the LongVideoDataset chunking (dataloader_baseline.py:40-56, :256-260).

    Returns a list of (start_frame_idx, gt_frame_num) pairs where
    start_frame_idx is the 0-based first frame of the chunk (the reference
    passes ``chunk[0]`` — a 0-based offset — as start_frame_idx).
    """
    out = []
    for s in range(0, total, chunk):
        out.append((s, min(chunk, total - s)))
    return out
