"""Retrieval answers judged against plain scores.

Scores are -||q - g||^2, as the clamped expansion in float32 (FAISS's
convention in the reference). An answer is judged by what it says: each
returned row's score against the reference's score of that row
(``score_gap``), and each rank's row against the best row the reference
would still have had to offer there (``rank_gap``): the largest reference
score among the rows not yet returned and, for moments, not suppressed by
a returned window of the same video. A near-tie that the two orders split
reads as the tie's width; a wrong, missing, repeated or suppressed answer
reads large or infinite.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from portbench.reference.arv import tf32_round

INF = float("inf")


def scores(torch, q, g, tf32: bool = False):
    """[Q, D] x [G, D] -> [Q, G] -||q - g||^2 (torch, the inputs' device);
    ``tf32``: the cross term from TF32-rounded operands (reference/arv.py)."""
    q2 = (q * q).sum(-1, keepdim=True)
    g2 = (g * g).sum(-1)[None, :]
    cross = tf32_round(q) @ tf32_round(g).T if tf32 else q @ g.T
    return -(q2 + g2 - 2.0 * cross).clamp_min(0.0)


def judge_topk(rows: Sequence[int], got: Sequence[float], ref_row: np.ndarray,
               k: int) -> Tuple[float, float]:
    """(score_gap, rank_gap) of one top-k answer; ``ref_row`` is the
    reference's scores over the whole gallery."""
    n = ref_row.shape[0]
    if len(rows) != min(k, n) or len(set(rows)) != len(rows):
        return INF, INF
    rows = np.asarray(rows, np.int64)
    if rows.min() < 0 or rows.max() >= n:
        return INF, INF
    score_gap = float(np.max(np.abs(np.asarray(got, np.float64) - ref_row[rows])))
    order = np.argsort(-ref_row, kind="stable")[:2 * k + 1]
    rank_gap, taken = 0.0, set()
    for r in rows:
        best = next(ref_row[c] for c in order if c not in taken)
        rank_gap = max(rank_gap, float(best - ref_row[r]))
        taken.add(int(r))
    return score_gap, rank_gap


def iou_plus1(s0, e0, s1, e1):
    """Temporal IoU with the reference's +1 length convention (utils_models.py)."""
    inter = np.maximum(0.0, np.minimum(e0, e1) - np.maximum(s0, s1) + 1.0)
    return inter / ((e0 - s0 + 1.0) + (e1 - s1 + 1.0) - inter)


def judge_moments(rows: Sequence[int], got: Sequence[float], ref_row: np.ndarray,
                  video: np.ndarray, start: np.ndarray, end: np.ndarray, k: int,
                  nms: float, pool: int) -> Tuple[float, float]:
    """(score_gap, rank_gap) of one moment answer: greedy per-video NMS
    over the reference's ``pool`` best windows. A window is still on offer
    at rank r if it was not returned before and overlaps no returned window
    of its video by ``nms`` or more."""
    n = ref_row.shape[0]
    rows = np.asarray(rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n or len(set(rows.tolist())) != rows.size):
        return INF, INF
    score_gap = float(np.max(np.abs(np.asarray(got, np.float64) - ref_row[rows]))) if rows.size else 0.0
    cand = np.argpartition(-ref_row, min(pool, n) - 1)[:min(pool, n)]
    cand = cand[np.argsort(-ref_row[cand], kind="stable")]
    open_ = np.ones(cand.size, bool)
    rank_gap = 0.0
    for i, r in enumerate(rows):
        prev = rows[:i][video[rows[:i]] == video[r]]
        if np.any(iou_plus1(start[r], end[r], start[prev], end[prev]) >= nms):
            return score_gap, INF  # overlaps a window returned before it
        here = np.nonzero(cand == r)[0]
        if here.size and not open_[here[0]]:
            return score_gap, INF  # suppressed or repeated
        best = ref_row[cand[np.argmax(open_)]] if open_.any() else -INF
        rank_gap = max(rank_gap, float(best - ref_row[r]))
        same = video[cand] == video[r]
        hit = iou_plus1(start[r], end[r], start[cand], end[cand]) >= nms
        open_ &= ~(same & hit)
        open_[here] = False
    if rows.size < k and open_.any():
        return score_gap, INF  # fewer answers than asked while some were on offer
    return score_gap, rank_gap
