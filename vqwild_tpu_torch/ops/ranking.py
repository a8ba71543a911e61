"""Fully-vectorized ranked-retrieval metrics (AP + R@N) on the device.

Counterpart of vqwild_tpu/ops/ranking.py on torch tensors: plain
functions, the device is the tensors' own, nothing is compiled. One batched
computation over [Q, G] score matrices replaces the reference's per-query
Python loop (FAISS full search → dict shuffling → sklearn
average_precision_score, dataloader_baseline.py:1526-1608):

* ignored candidates (the multi-query source videos, dataloader:1532) are
  pushed to −inf so valid items form a sorted prefix;
* AP follows sklearn's uninterpolated definition *including tie handling*:
  precision is evaluated per distinct-score group at the group's last item,
  and every tp in the group is credited with that group precision;
* the reference's "robust mAP" quirk (dataloader:389,:434) — the last-ranked
  *valid* item is forced to a true positive for AP **but not** for the R@N
  numerator/denominator (it mutates the numpy copy only) — is reproduced;
* R@N = (tp among the first N valid) / (tp among all valid + 1e-10)
  (dataloader:393-401).

The sort, the cumulative sums and the gathers are torch ops, as they are
XLA ops in the JAX package; the one hand-written kernel on this path is the
distance (``gather_scores`` → ops.distance.score_matrix → K1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqwild_tpu_torch.ops.distance import score_matrix

_INT32_MAX = torch.iinfo(torch.int32).max


def _reverse_cummin(x: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right along dim 1 (torch.cummin scans from
    the left only)."""
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def ap_from_sorted(s_sorted, tp_ap, valid, nvalid):
    """sklearn-tie average precision over a score-desc-sorted stream.

    ``s_sorted`` [Q,G] scores sorted descending with invalid items pushed to
    −inf (sorted last); ``tp_ap`` [Q,G] the positive labels *including any
    robust-mAP flip, already masked to valid*; ``valid`` [Q,G] the sorted
    validity mask; ``nvalid`` [Q,1] valid counts. Precision is evaluated per
    distinct-score group at the group's last item and every tp in the group
    is credited with that group precision — identical tie handling to
    sklearn.average_precision_score / ops.metrics_np.average_precision.
    """
    q, g = s_sorted.shape
    dev = s_sorted.device
    idx = torch.arange(g, device=dev, dtype=torch.int32)[None, :]
    npos_ap = tp_ap.sum(dim=1, keepdim=True)
    cum_tp = torch.cumsum(tp_ap, dim=1, dtype=torch.int32)
    # distinct-score group boundaries (last item of each tie group)
    nxt = torch.cat(
        [s_sorted[:, 1:], torch.full((q, 1), -torch.inf, dtype=s_sorted.dtype, device=dev)],
        dim=1,
    )
    boundary = valid & ((nxt != s_sorted) | (idx == nvalid - 1))
    # Backfill each item with the precision at b(i), the first boundary
    # at-or-after i (its tie group's last item). cum_tp and position are
    # nondecreasing along the row, so the values AT b(i) are reverse
    # cummins of the boundary-masked streams, with int32 max as "no boundary
    # to the right". precision[b] = cum_tp[b] / (b+1), an int→fp32 true
    # divide at the same operands as the JAX function.
    big = torch.full((), _INT32_MAX, dtype=torch.int32, device=dev)
    bpos_min = _reverse_cummin(torch.where(boundary, idx, big))
    bcum_min = _reverse_cummin(torch.where(boundary, cum_tp, big))
    defined = bpos_min < big
    # items past the last boundary backfill 0, which only occurs in the
    # invalid tail where delta_recall is already 0
    one = torch.ones((), dtype=torch.int32, device=dev)
    group_precision = torch.where(
        defined, bcum_min / torch.where(defined, bpos_min + 1, one), 0.0
    )
    delta_recall = tp_ap / torch.clamp_min(npos_ap, 1)
    return torch.sum(delta_recall * group_precision, dim=1)


def _metrics_from_masks(
    scores,
    tp,
    ignore,
    r_at_n: Tuple[int, ...],
    robust: bool,
    topk: int,
    full_rank: bool,
):
    """Shared metric core; see ranked_retrieval_metrics for the contract."""
    q, g = scores.shape
    dev = scores.device
    s = scores.float().masked_fill(ignore, -torch.inf)
    # One stable ascending sort of the key -s, the payloads gathered by its
    # order: the order equals np.argsort(-s, kind="stable"), so a tie group
    # and the +inf keys of the ignored tail keep gallery order, and
    # s_sorted = -(-s) restores the original bits.
    key_sorted, order = torch.sort(-s, dim=1, stable=True)
    s_sorted = -key_sorted
    valid = torch.gather(~ignore, 1, order)
    tp_sorted = torch.gather(tp & ~ignore, 1, order)

    idx = torch.arange(g, device=dev, dtype=torch.int32)[None, :]
    nvalid = valid.sum(dim=1, keepdim=True)

    # ---- AP with the robust-mAP quirk on a copy of the labels ----
    tp_ap = tp_sorted
    if robust:
        tp_ap = tp_ap | (idx == nvalid - 1)
    tp_ap = tp_ap & valid
    ap = ap_from_sorted(s_sorted, tp_ap, valid, nvalid)

    # ---- R@N on the unmodified labels ----
    npos = (tp_sorted & valid).sum(dim=1)
    recalls = []
    for n in r_at_n:
        hits = (tp_sorted & valid & (idx < n)).sum(dim=1)
        recalls.append(hits / (npos + 1e-10))  # fp32, as JAX's weak typing gives
    out = dict(
        ap=ap,
        recalls=torch.stack(recalls, dim=1),
        npos=npos,
    )
    if topk:
        out["top_idx"] = order[:, :topk]
    if full_rank:
        out["tp_sorted"] = tp_sorted & valid
        out["scores_sorted"] = s_sorted
        out["nvalid"] = nvalid[:, 0]
    return out


def ranked_retrieval_metrics(
    scores,
    tp,
    ignore,
    r_at_n: Tuple[int, ...] = (30, 50, 100),
    robust: bool = True,
    topk: int = 0,
    full_rank: bool = False,
):
    """scores [Q,G] f32; tp/ignore [Q,G] bool (tensors on one device) →
    dict(ap [Q], recalls [Q,len(r_at_n)], npos [Q], top_idx [Q,topk]?).

    ``full_rank`` additionally returns the sorted per-query stream —
    tp_sorted/scores_sorted [Q,G] (pre-robust labels) and nvalid [Q] — for
    the system_ap_dict diagnostics dump (dataloader_baseline.py:448-456).

    Sorting is stable descending, so ties keep gallery order (FAISS likewise
    returns ties in index order).
    """
    return _metrics_from_masks(scores, tp, ignore, tuple(r_at_n), robust, topk, full_rank)


def build_eval_masks(gal_label_ids, gal_vid_ids, q_label_ids, q_src_vids):
    """tp/ignore on the device from integer id tensors, so a chunk uploads
    KB of ids and never two [Q,G] bool masks: gallery columns carry a label
    id and a video id ([G] i32, uploaded once), queries carry a label id and
    their multi-query source-video ids ([Q] + [Q,K] i32).

    tp[q,g]     = gal_label_ids[g] == q_label_ids[q]
    ignore[q,g] = gal_vid_ids[g] ∈ q_src_vids[q]  (the multi-query source
                  videos, dataloader_baseline.py:1532)  |  padded column

    Padded gallery columns are marked with gal_vid_ids == -1 (and label -1);
    q_src_vids pads with -2 so query padding never matches column padding.
    """
    tp = gal_label_ids[None, :] == q_label_ids[:, None]
    pad = gal_vid_ids < 0
    ignore = pad[None, :].expand(tp.shape)
    for k in range(q_src_vids.shape[1]):  # K is small: one [Q,G] compare each
        ignore = ignore | (gal_vid_ids[None, :] == q_src_vids[:, k][:, None])
    return tp & ~pad[None, :], ignore


def gather_scores(q_bank, gallery, q_rows):
    """Masked-mean gather of query features from a device bank, then the
    distance. q_rows [B,query_num] pads with -1 when a query has fewer than
    query_num source clips (np.mean over the short list in the host path).

    The distance is ``ops.distance.score_matrix``: kernel K1 on CUDA tensors,
    its plain version on CPU tensors, nothing to choose. The JAX function
    carries ``use_pallas=False`` because a Pallas call inside the evaluator's
    one compiled program multiplied XLA's compile time; eager PyTorch
    compiles no program, so that reason does not carry over and the chunk is
    scored by the same kernel as every other query."""
    qmask = (q_rows >= 0).to(q_bank.dtype)
    qf = (q_bank[q_rows.clamp_min(0).long()] * qmask[..., None]).sum(dim=1) / qmask.sum(
        dim=1, keepdim=True
    )
    return score_matrix(qf.float().contiguous(), gallery)


def fused_chunk_metrics(
    q_bank,
    gallery,
    gal_label_ids,
    gal_vid_ids,
    q_rows,
    q_label_ids,
    q_src_vids,
    r_at_n: Tuple[int, ...] = (30, 50, 100),
    robust: bool = True,
    topk: int = 0,
    full_rank: bool = False,
):
    """One query chunk, all on the device: gather query features from the
    bank, score against the gallery, build tp/ignore from ids, and reduce to
    the per-query metrics — the per-chunk host↔device traffic is a few KB of
    ids up and the [Q]-sized metric vectors down.

    q_bank [Nq,D] device bank of candidate query features (for trimmed eval
    this IS the gallery — queries are gallery rows, dataloader:1486);
    q_rows [Q,query_num] rows to average per expanded query (pad: -1);
    gallery [G,D]; gal_label_ids/gal_vid_ids [G] i32 (pad: -1);
    q_label_ids [Q] i32; q_src_vids [Q,K] i32 (pad: -2).
    """
    scores = gather_scores(q_bank, gallery, q_rows)
    tp, ignore = build_eval_masks(gal_label_ids, gal_vid_ids, q_label_ids, q_src_vids)
    return _metrics_from_masks(scores, tp, ignore, tuple(r_at_n), robust, topk, full_rank)


def fused_eval_metrics(
    q_bank,
    gallery,
    gal_label_ids,
    gal_vid_ids,
    q_rows,
    q_label_ids,
    q_src_vids,
    r_at_n: Tuple[int, ...] = (30, 50, 100),
    robust: bool = True,
):
    """The entire rank loop: the fused_chunk_metrics body (metrics-only
    form) over every query chunk, all results left on the device.

    q_rows [n_chunks, B, query_num]; q_label_ids [n_chunks, B];
    q_src_vids [n_chunks, B, K] → dict(ap [n_chunks, B],
    recalls [n_chunks, B, len(r_at_n)]).

    A Python loop: each chunk's launches are queued without waiting for the
    device, only ``ap`` and ``recalls`` outlive a chunk (the [B, G] score
    and sort intermediates are one chunk's at a time), and the caller reads
    back once at the end. Callers pad the tail chunk with replicated valid
    queries and drop the extras on the host (padding with -1 rows would NaN
    the masked-mean gather).
    """
    aps, recalls = [], []
    for qr, ql, qs in zip(q_rows, q_label_ids, q_src_vids):
        out = fused_chunk_metrics(
            q_bank, gallery, gal_label_ids, gal_vid_ids, qr, ql, qs,
            r_at_n=r_at_n, robust=robust,
        )
        aps.append(out["ap"])
        recalls.append(out["recalls"])
    return dict(ap=torch.stack(aps), recalls=torch.stack(recalls))
