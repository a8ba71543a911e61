"""Moment-retrieval metrics on the device: NMS + grouped-order AP/R@N.

Counterpart of vqwild_tpu/retrieval/moment_device.py on torch tensors. The
host postprocess (retrieval/moment.py::moment_query_metrics, mirroring
dataloader_baseline.py:1236-1330) needs the full ``[Q, ~10^6-moment]`` score
matrix on the host; this module keeps the scores on the device and reads
back only per-query scalars (AP + R@N), so the transfer no longer grows
with the gallery.

Exactness. Every decision the reference makes is reproduced bit for bit:

* **greedy NMS per video** (+1 length convention, suppress at iou ≥ thresh,
  score-desc/index-asc tie order): window boundaries are integer seconds,
  so intersections and unions are small integers, exact in fp32, and the
  iou test is rearranged division-free as ``inter·(1+t) ≥ t·(len_i+len_j)``
  (exact for a t with a short mantissa, 0.5 in practice). Greedy order comes
  from sorting each video's members once (stable, so ties fall back to
  ascending global index exactly like ``np.argsort(-scores, kind="stable")``),
  then a loop over sorted slots: slot i suppresses later overlapping slots
  iff it is itself unsuppressed, vectorized over [Q, videos, W].
* **grouped order** (videos by their best *pre-NMS* moment's global rank,
  members by score within a video, dataloader:1283-1309): videos are
  ordered by (best score desc, best member's global index asc) through two
  stable argsorts over the [Q, V] video axis, and a member's grouped
  position is the exclusive cumsum of valid members over ordered videos
  plus its within-video exclusive cumsum.
* **robust-mAP flip** at the grouped-order-last valid item and **R@N over
  grouped positions** follow from the grouped positions.
* **AP** is one masked sort + the shared sklearn-tie function
  (ops/ranking.ap_from_sorted).

Videos are bucketed by moment count (W) into a few padded [Q, V_bucket, W]
tensors, so the sequential NMS loop runs each video's width, not the
global maximum. The bucket constants go to the device once per evaluation.

Eager PyTorch materialises every intermediate that XLA would fuse, so the
cross-block suppression pass of the blocked NMS is tiled (``tile_elems``
bounds each temporary), and a chunk's body has no host synchronisation:
no boolean-mask indexing, ``.item()``, ``nonzero`` or branch on a device
value; the only host wait is the readback in ``finalize``/``finalize_scan``.
The JAX module's ``warm_scan`` has no counterpart (nothing to compile).

Under a ``mesh`` (parallel/mesh.py) the engine runs JAX's query-sharded
mode: the bucket constants are on every rank's device, each chunk's
gathered [B, n_padded] scores (every rank holds them: GalleryScorer
gathers the columns) pad to the chunk, whose size is a multiple of the
world size, and rank r runs the chunk body on its row block alone; the
per-query rows are gathered in rank order before the one readback, so
every rank returns the whole chunk. The super-chunked ``dispatch_scan``
stays single-device, as JAX's does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.ops.ranking import ap_from_sorted, gather_scores

log = get_logger("retrieval.moment_device")

# bucket pad widths: ~1.33x steps keep padding waste low while bounding the
# number of NMS loops (one per non-empty bucket). The 16,384 ceiling is a
# hard per-video limit — the real 100_20_80 untrimmed DB maxes at 3,549
# windows/video (p99 897); a ~47-minute video would cross it, so the caller
# (retrieval/moment.py) falls back to the host postprocess for oversize
# galleries instead of letting _bucket_plan raise.
_BUCKET_WIDTHS = (
    16, 32, 48, 64, 96, 128, 192, 256, 384, 512,
    768, 1024, 1536, 2048, 3072, 4096, 8192, 16384,
)
# the widest video the engine takes (retrieval/moment.py reads it at call time)
MAX_MOMENTS_PER_VIDEO = _BUCKET_WIDTHS[-1]
# elements of the largest temporary the blocked NMS builds ([Q, Vb, K, cols]
# tiles of the pairwise test): 2^26 fp32 = 256 MB
_TILE_ELEMS = 1 << 26


def _bucket_plan(vidx: np.ndarray, n_videos: int):
    """Group videos by member count into padded buckets.

    ``vidx`` [G] must be contiguous per video (build_gallery's layout).
    Returns a list of dicts with static per-bucket arrays:
      gather [Vb, W] int64 moment index (pad = G), vglob [Vb] video index.
    """
    counts = np.bincount(vidx, minlength=n_videos)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    buckets = []
    for lo, hi in zip((0,) + _BUCKET_WIDTHS, _BUCKET_WIDTHS):
        vids = np.where((counts > lo) & (counts <= hi))[0]
        if len(vids) == 0:
            continue
        gather = np.full((len(vids), hi), len(vidx), np.int64)
        for r, v in enumerate(vids):
            gather[r, : counts[v]] = np.arange(offsets[v], offsets[v + 1])
        buckets.append(dict(w=hi, gather=gather, vglob=vids.astype(np.int32)))
    widest = max((c for c in counts), default=0)
    if widest > _BUCKET_WIDTHS[-1]:
        raise ValueError(
            f"a video has {widest} moments > max bucket {_BUCKET_WIDTHS[-1]}"
        )
    return buckets


def _pad_rows(scores: torch.Tensor, rows: int) -> torch.Tensor:
    """``rows`` zero score rows appended on the device."""
    return torch.nn.functional.pad(scores, (0, 0, 0, rows))


def _pair_hits(s_i, e_i, l_i, s_j, e_j, l_j, thresh: float) -> torch.Tensor:
    """Bool: slot i overlaps slot j at iou ≥ thresh, division-free with the
    +1 length convention. The operands broadcast ([..., K, 1] against
    [..., 1, T]); the arithmetic and its order are the JAX function's."""
    inter = torch.minimum(e_i, e_j)
    inter.sub_(torch.maximum(s_i, s_j)).add_(1.0).clamp_min_(0.0).mul_(1.0 + thresh)
    return inter >= torch.add(l_i, l_j).mul_(thresh)


def _nms_sorted(ss, st, en, thresh: float, tile_elems: int = _TILE_ELEMS):
    """Greedy temporal NMS over score-sorted members.

    ss/st/en [Q, Vb, W] sorted by score desc (pads: ss=-inf). Returns the
    kept mask in sorted order. +1 length convention; suppress iff iou ≥ t,
    computed division-free (exact for integer-second geometry).

    Blocked: greedy runs exactly per K-slot block. Within a block the
    pairwise test is built once as a [Q, Vb, K, K] matrix (upper triangle),
    and each of the K sequential steps is two small ops over [Q, Vb, K]
    slices: slot i's row suppresses the later slots iff slot i is
    unsuppressed (``hit > supp_i`` is ``hit & ~supp_i`` on bools). Each
    finished block then suppresses every later slot in one pass, tiled over
    the slot axis (and over Vb when one column is too wide) so that no
    temporary exceeds ``tile_elems`` elements. Identical decisions to the
    sequential loop: entering block t, every suppression from blocks < t
    has been applied, and within the block the slot order is the textbook
    greedy. A width that no K of (64, 48, 32, 16) divides, or one no wider
    than K, runs as one block."""
    q, vb, w = ss.shape
    lens = en - st + 1.0
    supp = ~(ss > -torch.inf)
    k = next((c for c in (64, 48, 32, 16) if w % c == 0), None)
    if k is None or w <= k:
        k = w
    tri = torch.ones(k, k, dtype=torch.bool, device=ss.device).triu_(1)
    vt_block = min(vb, max(1, tile_elems // (q * k * k)))
    vt_cross = min(vb, max(1, tile_elems // (q * k)))
    for s0 in range(0, w, k):
        blk = slice(s0, s0 + k)
        stb, enb, lnb = st[..., blk], en[..., blk], lens[..., blk]
        with record_function("moment_device.nms_pairs"):
            hit_b = torch.empty((q, vb, k, k), dtype=torch.bool, device=ss.device)
            for v0 in range(0, vb, vt_block):
                v = slice(v0, v0 + vt_block)
                hit_b[:, v] = _pair_hits(
                    stb[:, v, :, None], enb[:, v, :, None], lnb[:, v, :, None],
                    stb[:, v, None, :], enb[:, v, None, :], lnb[:, v, None, :], thresh,
                )
            hit_b &= tri
        supp_b = supp[..., blk]
        with record_function("moment_device.nms_block"):
            for i in range(k):
                supp_b |= torch.gt(hit_b[:, :, i, :], supp_b[:, :, i : i + 1])
        if s0 + k == w:
            continue
        # kept block slots suppress every later slot
        with record_function("moment_device.nms_cross"):
            kept_b = ~supp_b
            for v0 in range(0, vb, vt_cross):
                v = slice(v0, v0 + vt_cross)
                cols = min(w - s0 - k, max(1, tile_elems // (q * min(vt_cross, vb - v0) * k)))
                si, ei, li = stb[:, v, :, None], enb[:, v, :, None], lnb[:, v, :, None]
                kept = kept_b[:, v, :, None]
                for c0 in range(s0 + k, w, cols):
                    c = slice(c0, c0 + cols)
                    hit = _pair_hits(si, ei, li, st[:, v, None, c], en[:, v, None, c],
                                     lens[:, v, None, c], thresh)
                    hit &= kept
                    target = supp[:, v, c]
                    target |= hit.any(dim=2)
    return ~supp & (ss > -torch.inf)


def _chunk_metrics_core(
    scores,
    q_label,
    ignore_vids,
    buckets,
    n_moments: int,
    nms_threshold: float,
    tp_when_no_match: bool,
    r_at_n: Tuple[int, ...],
    robust: bool,
):
    """One query chunk → (ap [Q], rhits [Q, len(r_at_n)], npos [Q]).

    ``buckets``: tuple of dicts of device-resident gallery constants.
    scores [Q, >=G] f32 (extra padded columns ignored), q_label [Q] int32,
    ignore_vids [Q, I] int64 gallery video indices (-1 pads).
    """
    q = scores.shape[0]
    g = n_moments
    dev = scores.device
    s_ext = torch.cat(
        [scores[:, :g], torch.full((q, 1), -torch.inf, dtype=scores.dtype, device=dev)],
        dim=1,
    )

    per_bucket = []
    vbest_score, vbest_idx = [], []
    for b in buckets:
        vb, w = b["gather"].shape
        with record_function("moment_device.bucket_sort"):
            sb = torch.index_select(s_ext, 1, b["gather"].view(-1)).view(q, vb, w)
            key, order = torch.sort(-sb, dim=2, stable=True)
            del sb

            def take(a):
                return torch.gather(a.expand(q, vb, w), 2, order)

            ss = -key
            stt, enn = take(b["starts"]), take(b["ends"])
            lab, hit = take(b["labels"]), take(b["hit_ok"])
            gidx0 = torch.gather(b["gather"].expand(q, vb, w), 2, order[:, :, :1])
            del key, order
        with record_function("moment_device.nms"):
            kept = _nms_sorted(ss, stt, enn, nms_threshold)
        del stt, enn
        igb = (b["vglob"][None, :, None] == ignore_vids[:, None, :]).any(dim=-1)  # [Q, Vb]
        validkept = kept & ~igb[:, :, None]
        tp = torch.where(lab == q_label[:, None, None], hit, tp_when_no_match)
        within = torch.cumsum(validkept, dim=2, dtype=torch.int32) - validkept.int()
        per_bucket.append(dict(ss=ss, tp=tp, validkept=validkept, within=within))
        vbest_score.append(ss[:, :, 0])
        vbest_idx.append(gidx0[:, :, 0])

    # ---- cross-video grouped order (videos in bucket-concatenated axis) ----
    bs = torch.cat(vbest_score, dim=1)  # [Q, V]
    bi = torch.cat(vbest_idx, dim=1)
    nv = torch.cat(
        [pb["validkept"].sum(dim=2, dtype=torch.int32) for pb in per_bucket], dim=1
    )
    # videos by (best score desc, best member global index asc): compose two
    # stable argsorts (radix over the lexicographic key)
    perm1 = torch.argsort(bi, dim=1, stable=True)
    key2 = torch.gather(-bs, 1, perm1)
    perm2 = torch.argsort(key2, dim=1, stable=True)
    vorder = torch.gather(perm1, 1, perm2)
    nv_ord = torch.gather(nv, 1, vorder)
    base_ord = torch.cumsum(nv_ord, dim=1, dtype=torch.int32) - nv_ord  # exclusive
    # back to the concatenated-video order through the inverse permutation
    base = torch.empty_like(base_ord).scatter_(1, vorder, base_ord)
    total_valid = nv.sum(dim=1, dtype=torch.int32)  # [Q]

    # ---- per-moment grouped positions, R@N, flip, AP inputs ----
    npos = torch.zeros((q,), dtype=torch.int32, device=dev)
    rhits = [torch.zeros((q,), dtype=torch.int32, device=dev) for _ in r_at_n]
    ap_scores, ap_tp = [], []
    voff = 0
    for pb in per_bucket:
        vb = pb["ss"].shape[1]
        base_b = base[:, voff : voff + vb]
        voff += vb
        gpos = base_b[:, :, None] + pb["within"]
        vk = pb["validkept"]
        tpv = pb["tp"] & vk
        npos += tpv.sum(dim=(1, 2), dtype=torch.int32)
        for j, n in enumerate(r_at_n):
            rhits[j] += (tpv & (gpos < n)).sum(dim=(1, 2), dtype=torch.int32)
        tp_ap = tpv
        if robust:
            tp_ap = tp_ap | (vk & (gpos == (total_valid[:, None, None] - 1)))
        ap_scores.append(torch.where(vk, pb["ss"], -torch.inf).reshape(q, -1))
        ap_tp.append(tp_ap.reshape(q, -1))
    del per_bucket

    with record_function("moment_device.ap_sort"):
        s_m = torch.cat(ap_scores, dim=1)
        t_m = torch.cat(ap_tp, dim=1)
        del ap_scores, ap_tp
        key, order = torch.sort(-s_m, dim=1, stable=True)
        tp_sorted = torch.gather(t_m, 1, order)
        s_sorted = -key
    valid_sorted = s_sorted > -torch.inf
    ap = ap_from_sorted(s_sorted, tp_sorted & valid_sorted, valid_sorted,
                        total_valid[:, None])
    # recalls divide on the host in f64 (exact integer numerators here)
    return ap, torch.stack(rhits, dim=1), npos


def _pack(ap, rhits, npos) -> torch.Tensor:
    """[..., 2 + len(r_at_n)] f64 on the device: ap | rhits | npos, so that
    a readback is one copy (every value is exact in f64)."""
    return torch.cat([ap.double()[..., None], rhits.double(), npos.double()[..., None]], dim=-1)


def _scan_metrics(
    q_bank,
    gallery,
    q_rows,
    q_label,
    ignore_vids,
    buckets,
    n_moments: int,
    nms_threshold: float,
    tp_when_no_match: bool,
    r_at_n: Tuple[int, ...],
    robust: bool,
):
    """MANY query chunks queued without a readback: score (K1 on the card)
    + NMS + grouped-order metrics for each of the S chunks of a super-chunk,
    one chunk at a time, so the [B, G] scores and [B, Vb, W] bucket tensors
    exist one chunk at a time.

    q_rows [S, B, query_num] rows into ``q_bank`` (pad -1 within a query,
    whole padded chunks replicate real queries — extras dropped host-side);
    q_label [S, B]; ignore_vids [S, B, I]. → packed [S, B, 2 + len(r_at_n)].
    """
    out = []
    for qr, ql, ig in zip(q_rows, q_label, ignore_vids):
        with record_function("moment_device.score"):
            scores = gather_scores(q_bank, gallery, qr)
        out.append(_pack(*_chunk_metrics_core(
            scores, ql, ig, buckets, n_moments, nms_threshold, tp_when_no_match,
            r_at_n, robust,
        )))
        del scores
    return torch.stack(out)


def _unpack(h: np.ndarray):
    """Packed host rows [N, 2 + R] → (ap [N] f64, recalls [N, R] f64)."""
    ap = h[:, 0]
    # identical arithmetic to the host path: npos = tp.sum() + 1e-10 (f64)
    npos = h[:, -1] + 1e-10
    return ap, h[:, 1:-1] / npos[:, None]


class DeviceMomentEngine:
    """Per-evaluation device state + chunked metric computation.

    Parameters mirror the host postprocess inputs (retrieval/moment.py):
    window geometry/hit labels are the build_gallery outputs; ``tiou`` is
    applied HERE on the host in float64 (the device only ever sees the
    boolean), so tp thresholds are bit-identical to the host path. The
    constants live on ``device``, or under a ``mesh`` on its device
    (``device`` is not read), and the chunk then rounds down to a multiple
    of the world size (at least the world size).
    """

    def __init__(
        self,
        vidx: np.ndarray,
        start_sec: np.ndarray,
        end_sec: np.ndarray,
        hit_label: np.ndarray,
        hit_iou: np.ndarray,
        n_videos: int,
        *,
        nms_threshold: float = 0.5,
        tiou_threshold: float = 0.5,
        chunk: int = 32,
        max_ignore: int = 8,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.n_moments = len(vidx)
        self.max_ignore = max_ignore
        if mesh is not None:
            chunk = max(mesh.size, (chunk // mesh.size) * mesh.size)
        self.chunk = chunk
        vidx = np.asarray(vidx, np.int64)

        def _const(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # label vocabulary: gallery hit labels now, query labels on demand
        self._label_ids = {"": -1}
        labs = np.empty(self.n_moments, np.int32)
        for i, lab in enumerate(hit_label):
            labs[i] = self._label_ids.setdefault(str(lab), len(self._label_ids))
        hit_ok = np.asarray(hit_iou, np.float64) >= tiou_threshold
        buckets = []
        for b in _bucket_plan(vidx, n_videos):
            gi = b["gather"]
            pad = gi == self.n_moments
            src = np.minimum(gi, self.n_moments - 1)
            starts = np.where(pad, 0.0, np.asarray(start_sec, np.float64)[src]).astype(np.float32)
            ends = np.where(pad, -1.0, np.asarray(end_sec, np.float64)[src]).astype(np.float32)
            labels = np.where(pad, -1, labs[src])
            hok = np.where(pad, False, hit_ok[src])
            buckets.append(
                dict(
                    # int64: torch's index_select/gather take int64 indices
                    gather=_const(gi),
                    vglob=_const(b["vglob"].astype(np.int64)),
                    starts=_const(starts),
                    ends=_const(ends),
                    labels=_const(labels.astype(np.int32)),
                    hit_ok=_const(hok),
                )
            )
        self._buckets = tuple(buckets)
        self._nms_threshold = float(nms_threshold)
        # upstream: iou_q = where(label match, hit_iou, 0.0); tp = iou_q >= t
        self._tp_when_no_match = bool(0.0 >= tiou_threshold)
        log.info(
            "device moment engine: %d moments, %d videos, %d buckets (padded %d)",
            self.n_moments,
            n_videos,
            len(buckets),
            sum(int(b["gather"].numel()) for b in buckets),
        )

    def label_id(self, label: str) -> int:
        return self._label_ids.setdefault(str(label), len(self._label_ids))

    def _ints(self, a, dtype) -> torch.Tensor:
        """A small host array on the device without a host wait: a copy
        from pageable memory waits for the stream, one from pinned memory
        is queued behind the work before it."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def dispatch(
        self,
        scores: torch.Tensor,
        q_labels: Sequence[int],
        ignore_vids: List[List[int]],
        r_at_n: Tuple[int, ...],
        robust: bool,
    ):
        """Enqueue one chunk: scores [B, >=G] f32 on the engine's device (a
        GalleryScorer output); q_labels [B] int ids; ignore_vids per-query
        gallery-video index lists. Returns an opaque handle for
        ``finalize``. Pads the chunk to the engine's fixed chunk size; the
        [B]-sized outputs stay on the device until ``finalize``. Under a
        mesh every rank passes the same chunk and computes its row block
        of it."""
        b = scores.shape[0]
        assert b <= self.chunk, (b, self.chunk)
        ql = np.full(self.chunk, -1, np.int32)
        ql[:b] = np.asarray(q_labels, np.int32)
        ig = np.full((self.chunk, self.max_ignore), -1, np.int64)
        for i, vids in enumerate(ignore_vids):
            if len(vids) > self.max_ignore:
                raise ValueError(f"{len(vids)} ignore videos > {self.max_ignore}")
            ig[i, : len(vids)] = vids
        if b < self.chunk:
            scores = _pad_rows(scores, rows=self.chunk - b)
        if self.mesh is not None:
            rows = self.mesh.rows(self.chunk)
            scores, ql, ig = scores[rows], ql[rows], ig[rows]
        out = _chunk_metrics_core(
            scores,
            self._ints(ql, np.int32),
            self._ints(ig, np.int64),
            self._buckets,
            n_moments=self.n_moments,
            nms_threshold=self._nms_threshold,
            tp_when_no_match=self._tp_when_no_match,
            r_at_n=tuple(r_at_n),
            robust=bool(robust),
        )
        return _pack(*out), b, self.mesh

    @staticmethod
    def finalize(handle):
        """→ (ap [B] f64, recalls [B, len(r_at_n)] f64) for one dispatch:
        one device-to-host copy of the three outputs (under a mesh,
        after the ranks' rows are gathered in rank order)."""
        packed, b, mesh = handle
        if mesh is not None:
            packed = mesh.gather(packed)
        return _unpack(packed.cpu().numpy()[:b])

    def dispatch_scan(self, q_bank, gallery, q_rows, q_labels, ignore_vids,
                      r_at_n: Tuple[int, ...], robust: bool):
        """Enqueue S chunks without a readback: q_rows [S, B, query_num]
        rows into ``q_bank`` (whole padded chunks replicate real queries;
        the caller drops their outputs); q_labels [S, B]; ignore_vids
        [S, B, max_ignore] (-1 pads). Scores are computed from the
        device-resident bank (K1 on the card), so the upload is three small
        integer arrays per S chunks. Single-device only, as JAX's: under a
        mesh each chunk goes through ``dispatch``."""
        if self.mesh is not None:
            raise ValueError("dispatch_scan is the single-device path; under a mesh, dispatch "
                             "each chunk")
        s, b = np.shape(q_rows)[:2]
        assert b == self.chunk, (b, self.chunk)
        return _scan_metrics(
            q_bank,
            gallery,
            self._ints(q_rows, np.int32),
            self._ints(q_labels, np.int32),
            self._ints(ignore_vids, np.int64),
            self._buckets,
            n_moments=self.n_moments,
            nms_threshold=self._nms_threshold,
            tp_when_no_match=self._tp_when_no_match,
            r_at_n=tuple(r_at_n),
            robust=bool(robust),
        )

    @staticmethod
    def finalize_scan(handle):
        """→ (ap [S*B] f64, recalls [S*B, len(r_at_n)] f64), one copy."""
        h = handle.cpu().numpy()
        return _unpack(h.reshape(-1, h.shape[-1]))

    def metrics(
        self,
        scores: torch.Tensor,
        q_labels: Sequence[int],
        ignore_vids: List[List[int]],
        r_at_n: Tuple[int, ...],
        robust: bool,
    ):
        """Synchronous dispatch+finalize of one chunk."""
        return self.finalize(
            self.dispatch(scores, q_labels, ignore_vids, r_at_n, robust)
        )
