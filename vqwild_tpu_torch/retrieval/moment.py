"""Untrimmed moment retrieval (ARV_Retrieval_Moment,
dataloader_baseline.py:965-1380).

Gallery: every video's tape is sliced into moments of 1..max_clips ×
moment_clip_sec seconds (5s stride); each moment carries its best-tIoU
annotation (closest_hit). Ranking per query: exact-L2 full ranking (kernel
K1 on the card) → per-video clustering in rank order → temporal NMS per
cluster (ignored moments participate and can suppress) → drop ignored → tp
iff closest-hit label matches and tIoU ≥ 0.5 → AP/R@N.

Faithfully-preserved upstream quirks:
* after NMS the kept list is re-assembled *grouped by video* (videos ordered
  by their best-ranked moment, moments rank-ordered within a video) — the
  robust-mAP flip and the R@N top-N windows operate on this grouped order,
  not pure score order (:1283-1330);
* NMS runs before the ignore filter, so ignored moments can suppress valid
  ones (:1283-1314 vs :386-402).

Counterpart of vqwild_tpu/retrieval/moment.py. Like the port's clip
evaluator it takes ``device`` where the JAX class takes ``mesh``. The
per-query postprocess runs on one of three engines:

* **device** (``engine="auto"`` on ``cuda``): NMS + grouped-order metrics as
  torch ops on the device (retrieval/moment_device.py); each chunk is scored
  by K1 and the [Q, ~10^6] scores never cross to the host: the readback is
  one AP + R@N row per query. ``engine="device"`` takes it on any device,
  the CPU included;
* **native**: each rank chunk is scored on the device, read back into one
  reused host buffer and postprocessed by the port's C++ thread-pool engine
  (vqwild_tpu_torch/native), the default on the CPU;
* **numpy threads**: the pure-python host path, taken when the host has no
  g++ or ``VQWILD_NO_NATIVE=1``, and the diagnostics path (it is the only
  engine that exposes the per-query kept stream for cm_dict).

The engines are metric-equal, so the choice moves time, not results.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.core.profiling import phase
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.sampling import temporal_iou
from vqwild_tpu_torch.data.schema import MomentDB, VideoRecord
from vqwild_tpu_torch.native import lib as native_lib
from vqwild_tpu_torch.ops import metrics_np
from vqwild_tpu_torch.ops.hostmem import alloc_array
from vqwild_tpu_torch.ops.nms import temporal_nms
from vqwild_tpu_torch.ops.segment_pool import HostWindowPooler, enumerate_moment_windows
from vqwild_tpu_torch.retrieval import moment_device
from vqwild_tpu_torch.retrieval.aggregate import MetricAggregator
from vqwild_tpu_torch.retrieval.diagnostics import DiagnosticsCollector
from vqwild_tpu_torch.retrieval.features import FeatureExtractor
from vqwild_tpu_torch.retrieval.multiquery import generate_multi_query
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer

log = get_logger("retrieval.moment")


def closest_hit(annotations, loc_sec, possible_classes):
    """Best-tIoU annotation with an allowed label (:1099-1114); None if the
    video has no allowed annotations."""
    best_iou, best = -1.0, None
    for ann in annotations or ():
        if ann.label not in possible_classes:
            continue
        iou = temporal_iou(ann.segment[0], ann.segment[1], loc_sec[0], loc_sec[1])
        if iou > best_iou:
            best = (ann.label, iou)
            best_iou = iou
    return best


def closest_hits_vectorized(annotations, locs, possible_classes):
    """Batched closest_hit for all W windows of one video → (labels [W] str,
    ious [W]). Ties resolve to the earlier annotation, like the python loop
    (strict > comparison ≡ argmax-first-max)."""
    allowed = [a for a in annotations or () if a.label in possible_classes]
    w = len(locs)
    if not allowed:
        return np.array([""] * w, dtype=object), np.zeros(w)
    a0 = np.array([a.segment[0] for a in allowed])  # [A]
    a1 = np.array([a.segment[1] for a in allowed])
    w0 = locs[:, 0:1]  # [W,1]
    w1 = locs[:, 1:2]
    inter = np.maximum(0.0, np.minimum(a1[None], w1) - np.maximum(a0[None], w0))
    union = np.maximum(a1[None], w1) - np.minimum(a0[None], w0)
    iou = inter / union  # [W, A]
    best = np.argmax(iou, axis=1)
    labels = np.array([allowed[k].label for k in best], dtype=object)
    return labels, iou[np.arange(w), best]


def moment_query_metrics(
    scores: np.ndarray,
    video_idx: np.ndarray,
    start_sec: np.ndarray,
    end_sec: np.ndarray,
    iou: np.ndarray,
    ignore: np.ndarray,
    nms_threshold: float = 0.5,
    tiou_threshold: float = 0.5,
    r_at_n: Sequence[int] = (30, 50, 100),
    robust: bool = True,
    return_diag: bool = False,
) -> Tuple[float, List[float]]:
    """One query's full postprocess (the reference worker body, :1236-1330).

    With ``return_diag`` a third element is returned: dict(valid=[K] kept
    moment indices in grouped order, tp=[K] bool pre-robust labels,
    scores=[K]) — the ignore-filtered ranked stream for the cm_dict payload.
    """
    order = np.argsort(-scores, kind="stable")
    # cluster by video in ranked order
    kept_global: List[np.ndarray] = []
    # group moments by video preserving first-appearance order
    vids_in_order, first_pos = np.unique(video_idx[order], return_index=True)
    vids_by_appearance = vids_in_order[np.argsort(first_pos)]
    ranked_vidx = video_idx[order]
    for vid in vids_by_appearance:
        members = order[ranked_vidx == vid]  # ranked order within the video
        dets = np.stack(
            [start_sec[members], end_sec[members], scores[members]], axis=1
        ).astype(np.float32)
        keep = temporal_nms(dets, nms_threshold)
        keep_set = set(keep)
        # upstream re-filters in list (=ranked) order (:1306-1309)
        kept_global.append(members[[i for i in range(len(members)) if i in keep_set]])
    grouped = np.concatenate(kept_global) if kept_global else np.array([], np.int64)
    valid = grouped[~ignore[grouped]]
    if len(valid) == 0:
        empty = (0.0, [0.0 for _ in r_at_n])
        if return_diag:
            return empty + (
                dict(
                    valid=valid,
                    tp=np.zeros(0, bool),
                    scores=np.zeros(0, np.float32),
                ),
            )
        return empty
    tp = iou[valid] >= tiou_threshold
    y_true = tp.astype(np.int64).copy()
    if robust:
        y_true[-1] = 1  # last item of the *grouped* order (:389)
    ap = metrics_np.average_precision(y_true, scores[valid])
    npos = float(tp.sum()) + 1e-10
    recalls = [float(tp[:n].sum() / npos) for n in r_at_n]
    if return_diag:
        return ap, recalls, dict(valid=valid, tp=tp, scores=scores[valid])
    return ap, recalls


def use_device_engine(engine: str, device: torch.device, collect_diagnostics: bool,
                      vidx: np.ndarray) -> bool:
    """The JAX class's engine rule, with its accelerator test read as
    ``device.type == "cuda"``: "device" always, "auto" on cuda without
    diagnostics; either falls back to the host postprocess when a video has
    more moments than the device engine's widest bucket."""
    use_device = engine == "device" or (
        engine == "auto"
        and not collect_diagnostics
        and len(vidx) > 0
        # the device engine exists to avoid the [Q, ~10^6] score readback;
        # on the CPU there is no device link to avoid, and its padded-bucket
        # NMS costs more than the native postprocess
        and device.type == "cuda"
    )
    if use_device and len(vidx):
        max_per_video = int(np.bincount(vidx).max())
        if max_per_video > moment_device.MAX_MOMENTS_PER_VIDEO:
            log.warning(
                "device moment engine disabled: a video has %d moments "
                "> the %d bucket cap; falling back to the host postprocess",
                max_per_video,
                moment_device.MAX_MOMENTS_PER_VIDEO,
            )
            use_device = False
    return use_device


def _host_buffer(rows: int, cols: int, dtype: torch.dtype) -> torch.Tensor:
    """A pre-faulted host tensor (ops.hostmem.alloc_array) of ``dtype``:
    the score readback reuses it for every chunk."""
    np_dtype = {torch.float32: np.float32, torch.bfloat16: np.uint16}[dtype]
    return torch.from_numpy(alloc_array((rows, cols), np_dtype)).view(dtype)


class ARVRetrievalMoment:
    def __init__(
        self,
        db: MomentDB,
        spec: SplitSpec,
        extractor: FeatureExtractor,
        moment_clip_sec: int = 5,
        max_clips_per_moment: int = 26,
        fps: int = 3,
        temporal_stride: int = 1,
        query_num: int = 1,
        multi_query_extra: int = 4,
        nms_threshold: float = 0.5,
        tiou_threshold: float = 0.5,
        r_at_n: Sequence[int] = (30, 50, 100),
        robust_map: bool = True,
        rank_chunk: int = 128,
        read_cache: bool = False,
        workers: int = 8,
        collect_diagnostics: bool = False,
        device: Union[str, torch.device] = "cuda",
        score_readback_dtype: str = "float32",
        engine: str = "auto",
        scan_chunks: int = 16,
    ):
        self.extractor = extractor
        self.moment_clip_sec = moment_clip_sec
        self.max_clips = max_clips_per_moment
        self.fps = fps
        self.temporal_stride = temporal_stride
        self.query_num = query_num
        self.multi_query_extra = multi_query_extra
        self.nms_threshold = nms_threshold
        self.tiou_threshold = tiou_threshold
        self.r_at_n = tuple(r_at_n)
        self.robust_map = robust_map
        self.rank_chunk = rank_chunk
        self.read_cache = read_cache
        # 0 means "no loader workers" at the CLI; postprocess still needs >=1
        self.workers = max(1, workers)
        self.collect_diagnostics = collect_diagnostics
        self.device = resolve_device(device)
        # "bfloat16" halves the [rank_chunk, ~10^6-moment] device→host score
        # transfer; metric impact is rounding-level rank flips between
        # near-tied moments
        if score_readback_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown score_readback_dtype {score_readback_dtype!r}")
        self.score_readback_dtype = score_readback_dtype
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"unknown engine {engine!r}")
        # postprocess engine: "device" keeps the [Q, G] scores on the device
        # and reads back per-query metrics only; "host" reads the scores back
        # for the native/numpy postprocess; "auto" picks device on cuda and
        # host on the CPU, or when diagnostics need the per-query kept stream
        # or a video overflows the engine's bucket cap
        self.engine = engine
        # device-engine super-chunking: ``scan_chunks`` query chunks are
        # queued per readback (0 = dispatch and read back chunk by chunk)
        self.scan_chunks = int(scan_chunks)
        # resolved by evaluation(): "device" | "native" | "numpy"
        self.resolved_engine = ""
        self.possible_classes = set(spec.possible_classes("testing"))
        self.queries: List[VideoRecord] = db.nonnoise_queries()
        self.gallery_videos: List[VideoRecord] = db.gallery
        # per-phase wall-time accounting, populated by evaluation()
        self.timings: dict = {}

    def build_gallery(self):
        """→ feats [G,C], video_idx [G], start/end_sec [G], hit_label [G],
        hit_iou [G]."""
        cache = (
            self.extractor.load_cache("moment_gallery.npz") if self.read_cache else None
        )
        if cache is not None:
            return (
                cache["feats"],
                cache["video_idx"],
                cache["start_sec"],
                cache["end_sec"],
                cache["hit_label"],
                cache["hit_iou"],
            )
        with phase(self.timings, "tape_build"):
            tapes = self.extractor.extract_video_tapes(self.gallery_videos)
        # Two passes with preallocated arenas: at production scale there are
        # ~10^6 moments, and per-block allocations pay this container's
        # pathological page-fault cost (see ops.segment_pool.HostWindowPooler).
        windows = []
        total = 0
        for video, tape in zip(self.gallery_videos, tapes):
            starts, ends, locs = enumerate_moment_windows(
                video.activitynet_duration,
                tape.shape[1],
                self.moment_clip_sec,
                self.max_clips,
                self.fps,
                self.temporal_stride,
            )
            windows.append((starts, ends, locs))
            total += len(starts)
        feat_dim = next((t.shape[0] for t in tapes if t.size), 0)
        feats = alloc_array((total, feat_dim), np.float32)
        vidx = np.empty(total, np.int64)
        s_sec = np.empty(total, np.float64)
        e_sec = np.empty(total, np.float64)
        h_iou = np.empty(total, np.float64)
        h_label = np.empty(total, object)
        pooler = HostWindowPooler()
        off = 0
        with phase(self.timings, "window_pool"):
            for vi, (video, tape) in enumerate(zip(self.gallery_videos, tapes)):
                starts, ends, locs = windows[vi]
                w = len(starts)
                if w == 0:
                    continue
                pooler(tape, starts, ends, out=feats[off : off + w])
                vidx[off : off + w] = vi
                s_sec[off : off + w] = locs[:, 0]
                e_sec[off : off + w] = locs[:, 1]
                labels_v, ious_v = closest_hits_vectorized(
                    video.annotations, locs, self.possible_classes
                )
                h_label[off : off + w] = labels_v
                h_iou[off : off + w] = ious_v
                off += w
        log.info(
            "moment gallery: %d moments (%.1f / video)",
            total,
            total / max(len(self.gallery_videos), 1),
        )
        out = (feats, vidx, s_sec, e_sec, h_label.astype(str), h_iou)
        self.extractor.save_cache(
            "moment_gallery.npz",
            feats=out[0],
            video_idx=out[1],
            start_sec=out[2],
            end_sec=out[3],
            hit_label=out[4],
            hit_iou=out[5],
        )
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _evaluation_device(
        self, queries, q_feats_all, feats, vidx, s_sec, e_sec, h_label, h_iou
    ) -> dict:
        """Device-engine ranking: scores never leave the device; per chunk the
        readback is one AP + R@N row per query (retrieval/moment_device.py).
        Metric-equal to the host postprocess."""
        with phase(self.timings, "engine_build"):
            engine = moment_device.DeviceMomentEngine(
                vidx,
                s_sec,
                e_sec,
                h_label,
                h_iou,
                len(self.gallery_videos),
                nms_threshold=self.nms_threshold,
                tiou_threshold=self.tiou_threshold,
                chunk=min(self.rank_chunk, 32),
                max_ignore=max(8, 1 + self.multi_query_extra),
                device=self.device,
            )
        video_id_to_idx = {v.video_id: i for i, v in enumerate(self.gallery_videos)}
        expanded = generate_multi_query(
            list(range(len(queries))),
            label_of=lambda i: queries[i].label,
            video_id_of=lambda i: queries[i].video_id,
            extras=self.multi_query_extra,
        )
        log.info(
            "moment ranking (device engine): %d queries x %d moments",
            len(expanded),
            len(feats),
        )
        agg = MetricAggregator(self.r_at_n)
        agg.set_class_info(
            [(queries[qs[0]].label, queries[qs[0]].retrieval_type) for qs in expanded]
        )
        with phase(self.timings, "gallery_to_device"):
            scorer = GalleryScorer(feats, device=self.device)
            # queries gather from a device-resident bank: per chunk only the
            # [B, query_num] row indices cross to the device, not [B, D] features
            scorer.set_query_bank(q_feats_all.astype(np.float32, copy=False))
            self._sync()
        if self.scan_chunks > 0 and expanded:
            return self._device_scan_rank(
                engine, scorer, queries, expanded, video_id_to_idx, agg
            )
        # bounded in-flight pipeline: keep up to `inflight` chunks dispatched
        # ahead of the readback cursor, so progress is steady and the staged
        # device outputs stay bounded
        inflight = 16
        staged: list = []
        read_cursor = 0

        def _finalize_one():
            nonlocal read_cursor
            batch, handle = staged[read_cursor]
            staged[read_cursor] = None  # free the device handles
            read_cursor += 1
            aps, recalls = engine.finalize(handle)
            if read_cursor % 8 == 0 or read_cursor == n_chunks:
                log.info("moment chunk %d/%d read back", read_cursor, n_chunks)
            for bi, qs in enumerate(batch):
                q = queries[qs[0]]
                agg.add(q.label, q.retrieval_type, float(aps[bi]), recalls[bi].tolist())

        n_chunks = -(-len(expanded) // engine.chunk)
        for cstart in range(0, len(expanded), engine.chunk):
            batch = expanded[cstart : cstart + engine.chunk]
            q_rows = np.full((len(batch), self.query_num), -1, np.int32)
            for bi, qs in enumerate(batch):
                take = qs[: self.query_num]
                q_rows[bi, : len(take)] = take
            q_labels = [engine.label_id(queries[qs[0]].label) for qs in batch]
            ignore_vids = [
                [
                    video_id_to_idx[queries[qi].video_id]
                    for qi in qs
                    if queries[qi].video_id in video_id_to_idx
                ]
                for qs in batch
            ]
            with phase(self.timings, "score_device"):
                dev_scores = scorer.scores_from_bank(q_rows)
            with phase(self.timings, "metrics_device"):
                staged.append(
                    (
                        batch,
                        engine.dispatch(
                            dev_scores, q_labels, ignore_vids, self.r_at_n, self.robust_map
                        ),
                    )
                )
            del dev_scores
            if len(staged) % 8 == 0 or len(staged) == n_chunks:
                log.info("moment chunk %d/%d dispatched", len(staged), n_chunks)
            if len(staged) - read_cursor >= inflight:
                with phase(self.timings, "metrics_readback"):
                    _finalize_one()
        with phase(self.timings, "metrics_readback"):
            while read_cursor < len(staged):
                _finalize_one()
        return {"map05": agg.result()}

    def _device_scan_rank(self, engine, scorer, queries, expanded, video_id_to_idx,
                          agg) -> dict:
        """Rank loop with super-chunked dispatch: ``scan_chunks`` query
        chunks are queued per readback (moment_device._scan_metrics), so the
        host waits once per super-chunk. Tail chunks pad by replicating
        query 0; their outputs are dropped below."""
        b = engine.chunk
        qe = len(expanded)
        n_chunks = -(-qe // b)
        s_chunks = min(self.scan_chunks, n_chunks)
        n_prog = -(-n_chunks // s_chunks)
        total = n_prog * s_chunks * b
        q_rows = np.full((total, self.query_num), -1, np.int32)
        q_lab = np.zeros(total, np.int32)
        ig = np.full((total, engine.max_ignore), -1, np.int64)
        for i, qs in enumerate(expanded):
            take = qs[: self.query_num]
            q_rows[i, : len(take)] = take
            q_lab[i] = engine.label_id(queries[qs[0]].label)
            vids = [
                video_id_to_idx[queries[qi].video_id]
                for qi in qs
                if queries[qi].video_id in video_id_to_idx
            ]
            if len(vids) > engine.max_ignore:
                raise ValueError(f"{len(vids)} ignore videos > {engine.max_ignore}")
            ig[i, : len(vids)] = vids
        if total > qe:
            q_rows[qe:] = q_rows[0]
            q_lab[qe:] = q_lab[0]
            ig[qe:] = ig[0]
        q_rows = q_rows.reshape(n_prog, s_chunks, b, self.query_num)
        q_lab = q_lab.reshape(n_prog, s_chunks, b)
        ig = ig.reshape(n_prog, s_chunks, b, engine.max_ignore)
        # bounded in-flight pipeline over super-chunks (see _evaluation_device)
        inflight = 2
        staged: list = []
        read_cursor = 0

        def _finalize_one():
            nonlocal read_cursor
            p = read_cursor
            handle = staged[p]
            staged[p] = None  # free the device handles
            read_cursor += 1
            aps, recalls = engine.finalize_scan(handle)
            log.info("moment super-chunk %d/%d read back", read_cursor, n_prog)
            base = p * s_chunks * b
            for j in range(min(len(aps), qe - base)):
                q = queries[expanded[base + j][0]]
                agg.add(q.label, q.retrieval_type, float(aps[j]), recalls[j].tolist())

        for p in range(n_prog):
            with phase(self.timings, "metrics_device"):
                staged.append(
                    engine.dispatch_scan(
                        scorer.q_bank, scorer.g_dev, q_rows[p], q_lab[p], ig[p],
                        self.r_at_n, self.robust_map,
                    )
                )
            log.info("moment super-chunk %d/%d dispatched", p + 1, n_prog)
            if len(staged) - read_cursor >= inflight:
                with phase(self.timings, "metrics_readback"):
                    _finalize_one()
        with phase(self.timings, "metrics_readback"):
            while read_cursor < len(staged):
                _finalize_one()
        return {"map05": agg.result()}

    def evaluation(self) -> dict:
        with phase(self.timings, "query_feats"):
            q_feats_all = self.extractor.extract_trimmed(self.queries)
        pool = self.queries[: q_feats_all.shape[0]]  # capped in debug
        keep = [i for i, q in enumerate(pool) if q.label in self.possible_classes]
        queries = [pool[i] for i in keep]
        q_feats_all = q_feats_all[keep]

        feats, vidx, s_sec, e_sec, h_label, h_iou = self.build_gallery()

        if use_device_engine(self.engine, self.device, self.collect_diagnostics, vidx):
            self.resolved_engine = "device"
            return self._evaluation_device(
                queries, q_feats_all, feats, vidx, s_sec, e_sec, h_label, h_iou
            )

        # the native engine returns only ap/recalls; diagnostics need the
        # per-query kept stream, so they ride the numpy/thread path
        use_native = native_lib.available() and not self.collect_diagnostics
        self.resolved_engine = "native" if use_native else "numpy"
        if use_native:
            label_ids = {"": -1}
            for lab in list(h_label) + [q.label for q in queries]:
                label_ids.setdefault(lab, len(label_ids))
            # the engine's dtypes, converted once rather than per chunk
            engine_cols = dict(
                video_idx=np.ascontiguousarray(vidx, np.int32),
                start_sec=np.ascontiguousarray(s_sec, np.float32),
                end_sec=np.ascontiguousarray(e_sec, np.float32),
                hit_label=np.array([label_ids[l] for l in h_label], np.int32),
                hit_iou=np.ascontiguousarray(h_iou, np.float32),
            )
            video_id_to_idx = {v.video_id: i for i, v in enumerate(self.gallery_videos)}
            log.info("moment postprocess: native engine, %d threads", self.workers)
        else:
            gal_video_ids = np.array([v.video_id for v in self.gallery_videos])[vidx]

        expanded = generate_multi_query(
            list(range(len(queries))),
            label_of=lambda i: queries[i].label,
            video_id_of=lambda i: queries[i].video_id,
            extras=self.multi_query_extra,
        )
        log.info(
            "moment ranking: %d queries x %d moments", len(expanded), len(feats)
        )
        agg = MetricAggregator(self.r_at_n)
        agg.set_class_info(
            [(queries[qs[0]].label, queries[qs[0]].retrieval_type) for qs in expanded]
        )
        # upstream's multiprocessing moment path bypasses add2dict and
        # collects no diagnostics (:386-402); the rebuild fills the full
        # payload over the kept grouped-order stream (retrieval/diagnostics.py)
        diag = DiagnosticsCollector(self.robust_map) if self.collect_diagnostics else None

        with phase(self.timings, "gallery_to_device"):
            scorer = GalleryScorer(feats, device=self.device)
            self._sync()
        bf16 = self.score_readback_dtype == "bfloat16"
        rows = min(self.rank_chunk, max(len(expanded), 1))
        # one host block for every chunk's scores (751 MB at 128 x 1.47M
        # moments), plus an fp32 one to widen a bf16 readback into
        readback = _host_buffer(rows, scorer.n, torch.bfloat16 if bf16 else torch.float32)
        wide = _host_buffer(rows, scorer.n, torch.float32) if bf16 else readback
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=self.workers)
        try:
            for cstart in range(0, len(expanded), self.rank_chunk):
                batch = expanded[cstart : cstart + self.rank_chunk]
                b = len(batch)
                qf = np.stack(
                    [
                        np.mean([q_feats_all[i] for i in qs[: self.query_num]], axis=0)
                        for qs in batch
                    ]
                )
                with phase(self.timings, "score_device"):
                    dev_scores = scorer.scores(
                        qf, out_dtype=torch.bfloat16 if bf16 else None
                    )
                    self._sync()
                with phase(self.timings, "score_readback"):
                    readback[:b].copy_(dev_scores)
                    if bf16:  # postprocess consumes fp32 (host widen is cheap)
                        wide[:b].copy_(readback[:b])
                    scores = wide[:b].numpy()
                del dev_scores

                if use_native:
                    max_ig = max(len(qs) for qs in batch)
                    ignore_vids = np.full((b, max_ig), -1, np.int32)
                    q_label_ids = np.empty(b, np.int32)
                    for bi, qs in enumerate(batch):
                        q_label_ids[bi] = label_ids[queries[qs[0]].label]
                        k = 0  # compact: -1 is the terminator sentinel
                        for qi in qs:
                            gidx = video_id_to_idx.get(queries[qi].video_id)
                            if gidx is not None:
                                ignore_vids[bi, k] = gidx
                                k += 1
                    with phase(self.timings, "postprocess"):
                        aps, recalls = native_lib.moment_batch(
                            scores,
                            q_label=q_label_ids,
                            ignore_vids=ignore_vids,
                            nms_thresh=self.nms_threshold,
                            tiou_thresh=self.tiou_threshold,
                            r_at_n=self.r_at_n,
                            robust=self.robust_map,
                            n_threads=self.workers,
                            **engine_cols,
                        )
                    for bi, qs in enumerate(batch):
                        q = queries[qs[0]]
                        agg.add(
                            q.label,
                            q.retrieval_type,
                            float(aps[bi]),
                            recalls[bi].tolist(),
                        )
                    continue

                def one(bi_qs):
                    bi, qs = bi_qs
                    q = queries[qs[0]]
                    iou_q = np.where(h_label == q.label, h_iou, 0.0)
                    ignore_q = np.isin(
                        gal_video_ids, [queries[i].video_id for i in qs]
                    )
                    out = moment_query_metrics(
                        scores[bi],
                        vidx,
                        s_sec,
                        e_sec,
                        iou_q,
                        ignore_q,
                        self.nms_threshold,
                        self.tiou_threshold,
                        self.r_at_n,
                        self.robust_map,
                        return_diag=diag is not None,
                    )
                    return (q,) + tuple(out)

                t_post = time.perf_counter()
                for res in pool.map(one, enumerate(batch)):
                    q, ap, recalls = res[0], res[1], res[2]
                    agg.add(q.label, q.retrieval_type, ap, recalls)
                    if diag is not None:
                        d = res[3]
                        top = d["valid"][:100]
                        diag.add(
                            gt_label=q.label,
                            retrieval_type=q.retrieval_type,
                            duration_sec=q.duration_sec,
                            ap=float(ap),
                            y_true=d["tp"],
                            y_pred=d["scores"],
                            top_labels=[str(h_label[g]) for g in top],
                            top30_items=[
                                dict(
                                    video_id=str(gal_video_ids[g]),
                                    loc=[float(s_sec[g]), float(e_sec[g])],
                                    hit_label=str(h_label[g]),
                                    hit_iou=float(h_iou[g]),
                                )
                                for g in top[:30]
                            ],
                        )
                self.timings["postprocess"] = self.timings.get(
                    "postprocess", 0.0
                ) + (time.perf_counter() - t_post)
        finally:
            pool.shutdown()
        result = agg.result()
        if diag is not None:
            result["cm_dict"] = diag.finalize(agg, result)
        return {"map05": result}
