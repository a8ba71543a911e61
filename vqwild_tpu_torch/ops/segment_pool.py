"""Windowed temporal pooling over long-video feature tapes.

The untrimmed evaluators score every clip window / moment as the *mean* of the
per-frame feature tape over the window (dataloader_baseline.py:819-823,
:1139-1144 — upstream slices and means per window in Python). On the device
this is a cumulative sum along time followed by two gathers per window:

    mean[a:b) = (cumsum[b] − cumsum[a]) / (b − a)

which turns the O(windows × window_len) pooling into O(T + windows).

Counterpart of vqwild_tpu/ops/segment_pool.py: ``window_mean_from_cumsum``
and ``sliding_window_mean`` are torch ops on the tensor's device; the host
half (``window_mean_np``, ``HostWindowPooler``, the window enumerators) is
a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from vqwild_tpu_torch.ops.hostmem import alloc_array


def window_mean_from_cumsum(cum: torch.Tensor, starts: torch.Tensor,
                            ends: torch.Tensor) -> torch.Tensor:
    """cum [T+1, C] (leading zero row); starts/ends [W] → [W, C] means.

    Windows are half-open [start, end), end > start.
    """
    starts = starts.long()
    ends = ends.long()
    total = cum[ends] - cum[starts]
    return total / torch.clamp_min(ends - starts, 1)[:, None].to(cum.dtype)


def sliding_window_mean(tape: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """tape [T, C] per-frame features; starts/ends [W] → [W, C] window means."""
    cum = torch.cat([tape.new_zeros((1, tape.shape[1])), torch.cumsum(tape, dim=0)], dim=0)
    return window_mean_from_cumsum(cum, starts, ends)


def window_mean_np(tape: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Host variant for gallery building: per-video tapes come in thousands of
    distinct (T, W) shapes. One cumsum pass + two gathers is trivially cheap
    on host."""
    cum = np.concatenate(
        [np.zeros((1, tape.shape[1]), np.float64), np.cumsum(tape, axis=0, dtype=np.float64)],
        axis=0,
    )
    total = cum[ends] - cum[starts]
    return (total / np.maximum(ends - starts, 1)[:, None]).astype(tape.dtype)


class HostWindowPooler:
    """Allocation-free window means over [C, T] tapes.

    Page faults on fresh allocations are pathologically expensive in some
    containers (measured ~0.1-2 ms per 4 KB page), so the cumsum scratch and
    gather buffers are grown once and reused; results are written into a
    caller-provided output block. Used by the gallery builders which loop
    over thousands of per-video tapes.
    """

    def __init__(self):
        self._cum = np.empty((0, 0), np.float64)
        self._gather = np.empty((0, 0), np.float64)

    def _ensure(self, c: int, t: int, w: int):
        if self._cum.shape[0] < c or self._cum.shape[1] < t + 1:
            self._cum = alloc_array(
                (c, max(t + 1, 2 * self._cum.shape[1] + 1)), np.float64
            )
        if self._gather.shape[0] < 2 * c or self._gather.shape[1] < w:
            self._gather = alloc_array(
                (2 * c, max(w, 2 * self._gather.shape[1] + 1)), np.float64
            )

    def __call__(self, tape_ct: np.ndarray, starts, ends, out: np.ndarray):
        """tape_ct [C, T]; writes means into out [W, C] (a view is fine)."""
        c, t = tape_ct.shape
        w = len(starts)
        self._ensure(c, t, w)
        cum = self._cum[:c, : t + 1]
        cum[:, 0] = 0.0
        np.cumsum(tape_ct, axis=1, out=cum[:, 1:])
        hi = self._gather[:c, :w]
        lo = self._gather[c : 2 * c, :w]
        np.take(cum, np.asarray(ends, np.int64), axis=1, out=hi)
        np.take(cum, np.asarray(starts, np.int64), axis=1, out=lo)
        hi -= lo
        hi /= np.maximum(np.asarray(ends) - np.asarray(starts), 1)[None, :]
        out[:, :] = hi.T
        return out


def enumerate_clip_windows(
    duration_sec: float,
    feat_len: int,
    clip_sec: int,
    fps: int,
    temporal_stride: int,
):
    """Non-overlapping clip windows (ARV_Retrieval_Clip.garner_feat,
    dataloader_baseline.py:807-818): starts every clip_sec seconds from 0,
    window [t, t+clip_sec) seconds → feature frames [t·fps/stride,
    (t+clip_sec)·fps/stride), skipped when exceeding the tape.

    Returns (starts, ends, loc_secs) as numpy arrays.
    """
    starts, ends, locs = [], [], []
    for clip_start in range(0, int(duration_sec), clip_sec):
        f0 = clip_start * fps // temporal_stride
        f1 = (clip_start + clip_sec) * fps // temporal_stride
        if f1 > feat_len:
            continue
        starts.append(f0)
        ends.append(f1)
        locs.append((clip_start, clip_start + clip_sec))
    return (
        np.asarray(starts, np.int32),
        np.asarray(ends, np.int32),
        np.asarray(locs, np.float64).reshape(-1, 2),
    )


def enumerate_moment_windows(
    duration_sec: float,
    feat_len: int,
    clip_sec: int,
    max_clips: int,
    fps: int,
    temporal_stride: int,
):
    """Variable-length moment windows (ARV_Retrieval_Moment.garner_feat,
    dataloader_baseline.py:1117-1151): for n in 1..max_clips, starts every
    clip_sec seconds in range(0, int(duration) − clip_sec·n), window length
    clip_sec·n seconds; skipped when the feature window exceeds the tape.

    Note upstream's ``range`` bound excludes a start exactly at
    duration − length (python range semantics) — preserved.
    """
    starts, ends, locs = [], [], []
    for n in range(1, max_clips + 1):
        length = clip_sec * n
        for t0 in range(0, int(duration_sec) - length, clip_sec):
            f0 = t0 * fps // temporal_stride
            f1 = (t0 + length) * fps // temporal_stride
            if f1 > feat_len:
                continue
            starts.append(f0)
            ends.append(f1)
            locs.append((t0, t0 + length))
    return (
        np.asarray(starts, np.int32),
        np.asarray(ends, np.int32),
        np.asarray(locs, np.float64).reshape(-1, 2),
    )
