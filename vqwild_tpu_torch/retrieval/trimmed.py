"""Trimmed video retrieval (ARV_Retrieval, dataloader_baseline.py:1383-1616).

The during-training validation metric and the primary test metric: every
trimmed segment of the eval split is embedded (temporal mean of normalized
per-frame features), queries (label ∈ possible classes, is_query==1) are
ranked against the full gallery (all videos incl. distractor noise) by exact
L2, and AP/R@N aggregate via MetricAggregator.

The per-query FAISS search + Python dict loop of the reference becomes one
chunked [Q,G] device computation (ops.ranking), each chunk scored by kernel
K1. Counterpart of vqwild_tpu/retrieval/trimmed.py; it has no
``compile_warm`` phase (eager PyTorch compiles nothing ahead of the rank
loop). Under a ``mesh`` (parallel/mesh.py) every rank runs the evaluation:
the extractor's ``make_feat_fn(mesh=)`` shards each embed batch, the
scorer the gallery rows, and every rank returns the same metrics; rank 0
alone writes the feature cache.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.core.profiling import phase
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import TrimmedDB, VideoRecord
from vqwild_tpu_torch.retrieval.aggregate import MetricAggregator
from vqwild_tpu_torch.retrieval.diagnostics import DiagnosticsCollector
from vqwild_tpu_torch.retrieval.features import FeatureExtractor
from vqwild_tpu_torch.retrieval.multiquery import generate_multi_query
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer, stack_query_chunks

log = get_logger("retrieval.trimmed")


class ARVRetrievalTrimmed:
    def __init__(
        self,
        db: TrimmedDB,
        spec: SplitSpec,
        extractor: FeatureExtractor,
        eval_split: str = "validation",
        query_num: int = 1,
        multi_query_extra: int = 4,
        r_at_n: Sequence[int] = (30, 50, 100),
        robust_map: bool = True,
        rank_chunk: int = 256,
        read_cache: bool = False,
        collect_diagnostics: bool = False,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        """``device`` holds the gallery; under a ``mesh`` its device does
        (``device`` is not read)."""
        self.extractor = extractor
        self.eval_split = eval_split
        self.query_num = query_num
        self.multi_query_extra = multi_query_extra
        self.r_at_n = tuple(r_at_n)
        self.robust_map = robust_map
        self.rank_chunk = rank_chunk
        self.read_cache = read_cache
        self.collect_diagnostics = collect_diagnostics
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.possible_classes = set(spec.possible_classes(eval_split))
        self.records: List[VideoRecord] = db.flat(eval_split)
        self.timings: dict = {}
        log.info("loaded %d %s records", len(self.records), eval_split)

    def extract_features(self) -> np.ndarray:
        cache_name = f"trimmed_{self.eval_split}_feats.npz"
        if self.read_cache:
            cached = self.extractor.load_cache(cache_name)
            if cached is not None:
                return cached["feats"]
        feats = self.extractor.extract_trimmed(self.records)
        if self.mesh is None or self.mesh.rank == 0:
            self.extractor.save_cache(cache_name, feats=feats)
        return feats

    def evaluation(self) -> dict:
        with phase(self.timings, "features"):
            gallery_feats = self.extract_features()  # [N, C] (capped in debug)
        if gallery_feats.shape[0] < len(self.records):
            self.records = self.records[: gallery_feats.shape[0]]
        n = len(self.records)
        assert gallery_feats.shape[0] == n

        # queries: label ∈ possible classes AND is_query==1 (:1486-1489, :1521)
        query_idx = [
            i
            for i, r in enumerate(self.records)
            if r.label in self.possible_classes
        ]
        expanded = generate_multi_query(
            query_idx,
            label_of=lambda i: self.records[i].label,
            video_id_of=lambda i: self.records[i].video_id,
            extras=self.multi_query_extra,
        )
        expanded = [qs for qs in expanded if self.records[qs[0]].is_query == 1]
        log.info(
            "ranking %d queries against %d gallery items", len(expanded), n
        )
        return self._rank(expanded, gallery_feats)

    def _rank(self, expanded, gallery_feats: np.ndarray) -> dict:
        records = self.records
        label_ids = {}
        for r in records:
            label_ids.setdefault(r.label, len(label_ids))
        gal_labels = np.array([label_ids[r.label] for r in records], np.int32)
        vid_codes = {}
        for r in records:
            vid_codes.setdefault(r.video_id, len(vid_codes))
        gal_vids = np.array([vid_codes[r.video_id] for r in records], np.int32)

        agg = MetricAggregator(self.r_at_n)
        agg.set_class_info(
            [(records[qs[0]].label, records[qs[0]].retrieval_type) for qs in expanded]
        )
        # cm_dict diagnostics payload (dataloader_baseline.py:357-368, :437-466)
        diag = DiagnosticsCollector(self.robust_map) if self.collect_diagnostics else None

        # queries are gallery rows (dataloader:1486): the fused chunk path
        # gathers them on device, so per-chunk host→device traffic is only
        # the i32 row/label/source-video ids (KB, vs two [Q,G] bool masks —
        # which dominated the whole eval behind a slow host↔device link)
        k_src = max((len(qs) for qs in expanded), default=1)
        if not expanded:
            return agg.result()
        one_prog = diag is None  # diagnostics need [B,G] per-chunk outputs
        if one_prog:
            # whole-eval path: every chunk is queued on the device with no
            # readback between chunks, so the rank phase is 3 id uploads +
            # the queued launches + 1 readback, whatever the chunk count
            # (ops/ranking.py fused_eval_metrics)
            q_rows_all, q_lab_all, q_src_all = stack_query_chunks(
                expanded,
                self.rank_chunk,
                self.query_num,
                k_src,
                label_id_of=lambda i: label_ids[records[i].label],
                src_vids_of=lambda qs: [
                    vid_codes[records[qi].video_id] for qi in qs
                ],
            )
            n_chunks = q_rows_all.shape[0]
        with phase(self.timings, "gallery_to_device"):
            scorer = GalleryScorer(gallery_feats, device=self.device, mesh=self.mesh)
            scorer.set_columns(gal_labels, gal_vids)
            scorer.set_query_bank(None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        log.info(
            "gallery on device: %.1f MB in %.1fs",
            scorer.g_dev.numel() * scorer.g_dev.element_size() / 1e6,
            self.timings["gallery_to_device"],
        )
        if one_prog:
            log.info("dispatching %d chunks", n_chunks)
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
                    q = records[qs[0]]
                    agg.add(
                        q.label,
                        q.retrieval_type,
                        float(aps[i]),
                        recalls[i].tolist(),
                    )
            return self._finalize(agg, diag, expanded)
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
                q_lab[bi] = label_ids[records[qs[0]].label]
                q_src[bi, : len(qs)] = [
                    vid_codes[records[qi].video_id] for qi in qs
                ]
            with phase(self.timings, "rank_dispatch"):
                out = scorer.chunk_metrics(
                    q_rows,
                    q_lab,
                    q_src,
                    r_at_n=self.r_at_n,
                    robust=self.robust_map,
                    # ignored entries score −inf and sort strictly after
                    # every valid item, so top_idx[:100] already IS the first
                    # 100 of the ignore-filtered ranking — no headroom
                    # needed; the filter below only trims when the query has
                    # <100 valid rows
                    topk=100,
                    full_rank=True,
                )
            # diagnostics path: per-chunk sync (full_rank outputs are [B,G])
            # host copy of the ignore mask, for top-list filtering only
            ignore = np.zeros((b, scorer.n_padded), bool)
            ignore[:, scorer.n :] = True
            vid2idx = {}
            for i, r in enumerate(records):
                vid2idx.setdefault(r.video_id, []).append(i)
            for bi, qs in enumerate(batch):
                for qi in qs:
                    for gi in vid2idx.get(records[qi].video_id, ()):
                        ignore[bi, gi] = True
            aps = out["ap"].cpu().numpy()
            recalls = out["recalls"].cpu().numpy()
            top_idx = out["top_idx"].cpu().numpy()
            tp_sorted = out["tp_sorted"].cpu().numpy()
            s_sorted = out["scores_sorted"].cpu().numpy()
            nvalid = out["nvalid"].cpu().numpy()
            for bi, qs in enumerate(batch):
                q = records[qs[0]]
                agg.add(q.label, q.retrieval_type, float(aps[bi]), recalls[bi].tolist())
                if diag is not None:
                    k = int(nvalid[bi])
                    # first 100 of the ignore-filtered ranking (dataloader:437-466)
                    top = [g for g in top_idx[bi] if not ignore[bi, g]][:100]
                    diag.add(
                        gt_label=q.label,
                        retrieval_type=q.retrieval_type,
                        duration_sec=q.duration_sec,
                        ap=float(aps[bi]),
                        y_true=tp_sorted[bi, :k],
                        y_pred=s_sorted[bi, :k],
                        top_labels=[records[g].label for g in top],
                        top30_items=[
                            dict(
                                video_id=records[g].video_id,
                                label=records[g].label,
                                segment=list(records[g].segment),
                            )
                            for g in top[:30]
                        ],
                    )
        return self._finalize(agg, diag, expanded)

    def _finalize(self, agg, diag, expanded) -> dict:
        result = agg.result()
        if diag is not None:
            # pass_content = the expanded query lists, mirroring upstream's
            # get_result(self.original_query_list) (:1611)
            result["cm_dict"] = diag.finalize(
                agg,
                result,
                pass_content=[
                    [self.records[i].video_id for i in qs] for qs in expanded
                ],
            )
        return result
