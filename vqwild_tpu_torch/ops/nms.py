"""1-D temporal non-maximum suppression (a host copy of vqwild_tpu/ops/nms.py).

Greedy score-ordered NMS over [start, end, score] rows with the reference's
+1 length convention (utils_models.py:153-174): length = end − start + 1,
intersection = max(0, min(e_i, e_j) − max(s_i, s_j) + 1).

Tie order: equal scores process in index-ascending order (stable descending
sort) in BOTH the numpy and native paths, so the two are bit-identical. The
reference's ``np.argsort(scores)[::-1]`` leaves tie order unspecified
(quicksort) — a documented divergence on exact score ties only.

Dispatches to the port's native C++ engine (vqwild_tpu_torch/native) when it
builds, else to vectorized numpy. Returns kept row indices in
descending-score order, exactly like the reference's ``keep`` list.
"""

from __future__ import annotations

from typing import List

import numpy as np

from vqwild_tpu_torch.native import lib as native_lib


def temporal_nms_np(dets: np.ndarray, thresh: float) -> List[int]:
    x1 = dets[:, 0].astype(np.float64)
    x2 = dets[:, 1].astype(np.float64)
    scores = dets[:, 2]
    length = x2 - x1 + 1.0
    order = np.argsort(-scores, kind="stable")
    keep: List[int] = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        rest = order[1:]
        inter = np.maximum(
            0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1.0
        )
        iou = inter / (length[i] + length[rest] - inter)
        order = rest[iou < thresh]
    return keep


def temporal_nms(dets: np.ndarray, thresh: float) -> List[int]:
    dets = np.ascontiguousarray(dets, dtype=np.float32)
    if dets.shape[0] == 0:
        return []
    if native_lib.available():
        return native_lib.temporal_nms(dets, thresh)
    return temporal_nms_np(dets, thresh)
