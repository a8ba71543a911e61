"""Untrimmed clip retrieval (ARV_Retrieval_Clip, dataloader_baseline.py:661-963).

Gallery: every untrimmed video is chunked and embedded into a per-video
feature tape, then sliced into non-overlapping clip_sec windows; a window's
feature is the temporal mean over the tape (host cumsum gather) and its
label is the first annotation fully covering it (else "unknown"). Queries are
the trimmed query clips, held in a query bank of their own on the device.
tp = clip_label == query label.

Counterpart of vqwild_tpu/retrieval/clip.py. As the port's trimmed
evaluator, it has no ``compile_warm`` phase (eager PyTorch compiles nothing
ahead of the rank loop), and each rank chunk is scored by kernel K1 on a
CUDA tensor. Under a ``mesh`` (parallel/mesh.py) every rank runs the
evaluation: the extractor's ``make_feat_fn(mesh=)`` shards each embed
batch, so every rank builds the whole gallery; the scorer holds the
rank's block of the gallery rows and gathers the score columns, so every
rank ranks the whole gallery and returns the same metrics; rank 0 alone
writes the feature cache.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.core.profiling import phase
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import MomentDB, VideoRecord
from vqwild_tpu_torch.ops.hostmem import alloc_array
from vqwild_tpu_torch.ops.segment_pool import HostWindowPooler, enumerate_clip_windows
from vqwild_tpu_torch.retrieval.aggregate import MetricAggregator
from vqwild_tpu_torch.retrieval.diagnostics import DiagnosticsCollector
from vqwild_tpu_torch.retrieval.features import FeatureExtractor
from vqwild_tpu_torch.retrieval.multiquery import generate_multi_query
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer, stack_query_chunks

log = get_logger("retrieval.clip")


def window_label(annotations, loc_sec, possible_classes) -> str:
    """First annotation fully covering [loc_sec0, loc_sec1] with an allowed
    label, else "unknown" (cal_label, dataloader_baseline.py:797-806)."""
    for ann in annotations or ():
        if (
            ann.segment[0] <= loc_sec[0]
            and ann.segment[1] >= loc_sec[1]
            and ann.label in possible_classes
        ):
            return ann.label
    return "unknown"


class ARVRetrievalClip:
    def __init__(
        self,
        db: MomentDB,
        spec: SplitSpec,
        extractor: FeatureExtractor,
        clip_sec: int = 6,
        fps: int = 3,
        temporal_stride: int = 1,
        query_num: int = 1,
        multi_query_extra: int = 4,
        r_at_n: Sequence[int] = (30, 50, 100),
        robust_map: bool = True,
        rank_chunk: int = 256,
        read_cache: bool = False,
        check_completeness: bool = True,
        collect_diagnostics: bool = False,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        """``device`` holds the gallery; under a ``mesh`` its device does
        (``device`` is not read)."""
        self.extractor = extractor
        self.clip_sec = clip_sec
        self.fps = fps
        self.temporal_stride = temporal_stride
        self.query_num = query_num
        self.multi_query_extra = multi_query_extra
        self.r_at_n = tuple(r_at_n)
        self.robust_map = robust_map
        self.rank_chunk = rank_chunk
        self.read_cache = read_cache
        self.check_completeness = check_completeness
        self.collect_diagnostics = collect_diagnostics
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        # clip/moment eval always uses train+test labels (:671-674)
        self.possible_classes = set(spec.possible_classes("testing"))
        self.timings: dict = {}
        self.queries: List[VideoRecord] = db.nonnoise_queries()
        self.gallery_videos: List[VideoRecord] = db.gallery
        log.info(
            "clip eval: %d queries, %d gallery videos",
            len(self.queries),
            len(self.gallery_videos),
        )

    def build_gallery(self):
        """→ (clip_feats [G, C], clip_labels [G] str, clip_video_idx [G],
        clip_locs [G, 2] seconds)."""
        cache = self.extractor.load_cache("clip_gallery.npz") if self.read_cache else None
        if cache is not None and "locs" in cache:
            return cache["feats"], cache["labels"], cache["video_idx"], cache["locs"]
        tapes = self.extractor.extract_video_tapes(self.gallery_videos)
        # preallocated arenas + reusable pooler scratch (page faults on fresh
        # allocations are pathologically costly on some hosts; see
        # HostWindowPooler)
        windows = []
        total = 0
        for video, tape in zip(self.gallery_videos, tapes):
            starts, ends, locs = enumerate_clip_windows(
                video.activitynet_duration,
                tape.shape[1],
                self.clip_sec,
                self.fps,
                self.temporal_stride,
            )
            windows.append((starts, ends, locs))
            total += len(starts)
        feat_dim = next((t.shape[0] for t in tapes if t.size), 0)
        feats = alloc_array((total, feat_dim), np.float32)
        vidx = np.empty(total, np.int64)
        labels_arr = np.empty(total, object)
        locs_arr = np.zeros((total, 2), np.float64)
        pooler = HostWindowPooler()
        off = 0
        for vi, (video, tape) in enumerate(zip(self.gallery_videos, tapes)):
            starts, ends, locs = windows[vi]
            w = len(starts)
            if w == 0:
                continue
            pooler(tape, starts, ends, out=feats[off : off + w])
            vidx[off : off + w] = vi
            locs_arr[off : off + w] = locs
            for k in range(w):
                labels_arr[off + k] = window_label(
                    video.annotations, locs[k], self.possible_classes
                )
            off += w
        labels = labels_arr.astype(str)
        if self.mesh is None or self.mesh.rank == 0:
            self.extractor.save_cache(
                "clip_gallery.npz", feats=feats, labels=labels, video_idx=vidx, locs=locs_arr
            )
        return feats, labels, vidx, locs_arr

    def evaluation(self) -> dict:
        with phase(self.timings, "query_feats"):
            q_feats_all = self.extractor.extract_trimmed(self.queries)
        pool = self.queries[: q_feats_all.shape[0]]  # capped in debug
        keep = [i for i, q in enumerate(pool) if q.label in self.possible_classes]
        queries = [pool[i] for i in keep]
        q_feats_all = q_feats_all[keep]

        with phase(self.timings, "gallery_build"):
            gal_feats, gal_labels, gal_vidx, gal_locs = self.build_gallery()
        if self.check_completeness:
            present = set(gal_labels.tolist()) - {"unknown"}
            missing = self.possible_classes - present
            if missing:
                log.warning(
                    "gallery missing %d classes (e.g. %s)",
                    len(missing),
                    sorted(missing)[:3],
                )

        gal_video_ids = np.array(
            [self.gallery_videos[v].video_id for v in gal_vidx]
        )
        label_ids = {}
        for lab in list(gal_labels) + [q.label for q in queries]:
            label_ids.setdefault(lab, len(label_ids))
        gal_label_ids = np.array([label_ids[l] for l in gal_labels], np.int32)
        vid_codes = {}
        for v in self.gallery_videos:
            vid_codes.setdefault(v.video_id, len(vid_codes))
        for q in queries:
            vid_codes.setdefault(q.video_id, len(vid_codes))
        gal_vid_codes = np.array(
            [vid_codes[self.gallery_videos[v].video_id] for v in gal_vidx],
            np.int32,
        )

        expanded = generate_multi_query(
            list(range(len(queries))),
            label_of=lambda i: queries[i].label,
            video_id_of=lambda i: queries[i].video_id,
            extras=self.multi_query_extra,
        )
        log.info(
            "clip ranking: %d queries x %d gallery clips",
            len(expanded),
            len(gal_feats),
        )

        agg = MetricAggregator(self.r_at_n)
        agg.set_class_info(
            [(queries[qs[0]].label, queries[qs[0]].retrieval_type) for qs in expanded]
        )
        # upstream's clip dicts carry only gt_label/tp/ignore/score (:911-927)
        # so its cm_dict has just gt_labels + system streams; the rebuild fills
        # the full payload (see retrieval/diagnostics.py)
        diag = DiagnosticsCollector(self.robust_map) if self.collect_diagnostics else None
        # id-based chunk path: gallery feats + per-clip label/video ids and
        # the query bank upload once; each chunk ships only i32 ids (KB)
        # instead of two [Q,G] bool masks (50 MB at this scale)
        k_src = max((len(qs) for qs in expanded), default=1)
        if not expanded:
            return agg.result()
        with phase(self.timings, "gallery_to_device"):
            scorer = GalleryScorer(gal_feats, device=self.device, mesh=self.mesh)
            scorer.set_columns(gal_label_ids, gal_vid_codes)
            scorer.set_query_bank(q_feats_all.astype(np.float32, copy=False))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        log.info(
            "gallery on device: %.1f MB in %.1fs",
            scorer.g_dev.numel() * scorer.g_dev.element_size() / 1e6,
            self.timings["gallery_to_device"],
        )
        if diag is None:
            # whole-eval path: every chunk is queued on the device with no
            # readback between chunks (ops/ranking.py fused_eval_metrics)
            q_rows_all, q_lab_all, q_src_all = stack_query_chunks(
                expanded,
                self.rank_chunk,
                self.query_num,
                k_src,
                label_id_of=lambda i: label_ids[queries[i].label],
                src_vids_of=lambda qs: [
                    vid_codes[queries[qi].video_id] for qi in qs
                ],
            )
            log.info("dispatching %d chunks", q_rows_all.shape[0])
            with phase(self.timings, "rank_dispatch"):
                out = scorer.eval_metrics_all(
                    q_rows_all, q_lab_all, q_src_all,
                    r_at_n=self.r_at_n, robust=self.robust_map,
                )
            with phase(self.timings, "metrics_readback"):
                aps = out["ap"].cpu().numpy().reshape(-1)
                recalls = out["recalls"].cpu().numpy().reshape(
                    -1, len(self.r_at_n)
                )
                for i, qs in enumerate(expanded):
                    q = queries[qs[0]]
                    agg.add(
                        q.label,
                        q.retrieval_type,
                        float(aps[i]),
                        recalls[i].tolist(),
                    )
            return agg.result()
        n_chunks = (len(expanded) + self.rank_chunk - 1) // self.rank_chunk
        for ci, start in enumerate(range(0, len(expanded), self.rank_chunk)):
            if ci % 32 == 0:
                log.info("rank chunk %d/%d dispatched", ci, n_chunks)
            batch = expanded[start : start + self.rank_chunk]
            b = len(batch)
            q_rows = np.full((b, self.query_num), -1, np.int32)
            q_src = np.full((b, k_src), -2, np.int32)
            q_lab = np.empty(b, np.int32)
            for bi, qs in enumerate(batch):
                take = qs[: self.query_num]
                q_rows[bi, : len(take)] = take
                q_lab[bi] = label_ids[queries[qs[0]].label]
                q_src[bi, : len(qs)] = [
                    vid_codes[queries[qi].video_id] for qi in qs
                ]
            with phase(self.timings, "rank_dispatch"):
                out = scorer.chunk_metrics(
                    q_rows,
                    q_lab,
                    q_src,
                    r_at_n=self.r_at_n,
                    robust=self.robust_map,
                    topk=100,
                    full_rank=True,
                )
            # diagnostics path: per-chunk sync (full_rank outputs are [B,G])
            # host copy of the ignore mask, for top-list filtering only
            ignore = np.stack(
                [
                    np.isin(gal_video_ids, [queries[i].video_id for i in qs])
                    for qs in batch
                ]
            )
            ignore = np.concatenate(
                [
                    ignore,
                    np.ones((b, scorer.n_padded - scorer.n), bool),
                ],
                axis=1,
            )
            aps = out["ap"].cpu().numpy()
            recalls = out["recalls"].cpu().numpy()
            top_idx = out["top_idx"].cpu().numpy()
            tp_sorted = out["tp_sorted"].cpu().numpy()
            s_sorted = out["scores_sorted"].cpu().numpy()
            nvalid = out["nvalid"].cpu().numpy()
            for bi, qs in enumerate(batch):
                q = queries[qs[0]]
                agg.add(q.label, q.retrieval_type, float(aps[bi]), recalls[bi].tolist())
                k = int(nvalid[bi])
                top = [g for g in top_idx[bi] if not ignore[bi, g]][:100]
                diag.add(
                    gt_label=q.label,
                    retrieval_type=q.retrieval_type,
                    duration_sec=q.duration_sec,
                    ap=float(aps[bi]),
                    y_true=tp_sorted[bi, :k],
                    y_pred=s_sorted[bi, :k],
                    top_labels=[str(gal_labels[g]) for g in top],
                    top30_items=[
                        dict(
                            video_id=str(gal_video_ids[g]),
                            clip_label=str(gal_labels[g]),
                            loc=gal_locs[g].tolist(),
                        )
                        for g in top[:30]
                    ],
                )
        result = agg.result()
        result["cm_dict"] = diag.finalize(agg, result)
        return result
