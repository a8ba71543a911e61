"""Host (numpy) mirror of the ranked-retrieval metrics.

Used by the moment evaluator's host-side postprocess (ranking → per-video
clustering → temporal NMS → AP), by the native C++ engine as its reference
implementation, and by tests as an independent oracle for ops/ranking.py.

Semantics identical to ops.ranking.ranked_retrieval_metrics; see that module
for the sklearn-AP/tie-handling and robust-mAP notes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn.metrics.average_precision_score for binary labels, with
    identical tie handling (threshold groups at distinct scores)."""
    order = np.argsort(-y_score, kind="stable")
    y = np.asarray(y_true, dtype=np.float64)[order]
    s = np.asarray(y_score, dtype=np.float64)[order]
    npos = y.sum()
    if npos == 0:
        return 0.0
    cum_tp = np.cumsum(y)
    cnt = np.arange(1, len(y) + 1)
    boundary = np.ones(len(y), dtype=bool)
    boundary[:-1] = s[1:] != s[:-1]
    precision = cum_tp / cnt
    # credit each tp with its tie-group's boundary precision
    b_idx = np.where(boundary, np.arange(len(y)), len(y) - 1)
    b_idx = np.minimum.accumulate(b_idx[::-1])[::-1]
    return float(np.sum((y / npos) * precision[b_idx]))


def single_query_metrics(
    scores: np.ndarray,
    tp: np.ndarray,
    ignore: Optional[np.ndarray] = None,
    r_at_n: Sequence[int] = (30, 50, 100),
    robust: bool = True,
) -> Tuple[float, list]:
    """One query against the gallery → (ap, recall_list).

    Mirrors evaluation_metric.add2dict / multiprocess_calculate
    (dataloader_baseline.py:383-401, :429-496).
    """
    scores = np.asarray(scores, dtype=np.float64)
    tp = np.asarray(tp).astype(bool)
    if ignore is not None:
        keep = ~np.asarray(ignore).astype(bool)
        scores, tp = scores[keep], tp[keep]
    order = np.argsort(-scores, kind="stable")
    tp_ranked = tp[order]
    y_true = tp_ranked.astype(np.int64).copy()
    if robust and len(y_true):
        y_true[-1] = 1  # robust-mAP quirk (modifies the copy only)
    ap = average_precision(y_true, scores[order])
    npos = float(tp_ranked.sum()) + 1e-10
    recalls = [float(tp_ranked[:n].sum() / npos) for n in r_at_n]
    return ap, recalls
