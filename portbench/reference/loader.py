"""The training batches against the store they were read from.

The reference's sampling (utils_dataset.py): a segment [s0, s1] at ``fps``
gives frames from int(s0 * fps), int((s1 - s0) * fps) of them; a clip of T
frames repeats them from the start when there are fewer, and otherwise takes
floor(linspace) over them; indices are 1-based and clamped to the video.
A training clip is one crop of those frames, its offsets rounded down to
even on the 4:2:0 wire, with no flip. This finds, for every clip of a
batch, the crop that its first frame matches and holds the whole clip, luma
and chroma, to it.
"""

from __future__ import annotations

import numpy as np


def frame_indices(segment, fps: int, out_frames: int, total: int) -> np.ndarray:
    start, count = int(segment[0] * fps), int((segment[1] - segment[0]) * fps)
    if count < out_frames:
        locs = start + (np.arange(out_frames) % count) + 1
    else:
        locs = np.floor(np.linspace(start, start + count - 1, num=out_frames)).astype(np.int64)
    return np.clip(locs, 1, total).astype(np.int64)


def clip_matches(y, uv, vy, vuv, h: int, w: int) -> bool:
    """y [T, s, s], uv [T, s/2, s/2, 2]: the clip; vy, vuv: the video's
    planes at the clip's frame indices. True if some even crop holds it."""
    s = y.shape[-1]
    for top in range(0, h - s + 1, 2):
        for left in range(0, w - s + 1, 2):
            if not np.array_equal(vy[0, top:top + s, left:left + s], y[0]):
                continue
            if (np.array_equal(vy[:, top:top + s, left:left + s], y)
                    and np.array_equal(vuv[:, top // 2:top // 2 + s // 2,
                                           left // 2:left // 2 + s // 2], uv)):
                return True
    return False


def batch_mismatches(y, uv, labels, store_y, store_uv, doc, records, fps: int) -> int:
    """Clips of a batch that no crop of their class's video holds."""
    meta, videos = doc["_meta"], doc["videos"]
    bad = 0
    for i, lab in enumerate(np.asarray(labels)):
        _, vid, seg = records[int(lab)]
        v = videos[vid]
        idx = frame_indices(seg, fps, y.shape[1], v["n"]) - 1 + v["offset"]
        if not clip_matches(y[i], uv[i], store_y[idx], store_uv[idx], meta["h"], meta["w"]):
            bad += 1
    return bad
