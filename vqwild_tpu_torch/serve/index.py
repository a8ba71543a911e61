"""The serving gallery index: clip embeddings + metadata, on the device.

Counterpart of vqwild_tpu/serve/index.py ``GalleryIndex`` and
``MomentIndex``. The on-disk formats are the same (``feats.npy`` +
``meta.json``; a moment index adds ``windows.npz`` + ``videos.json``), so
either package serves an index the other built.

Under a ``mesh`` (parallel/mesh.py) every rank holds its block of the
gallery rows (retrieval/sharded.GalleryScorer) and answers the same top-k
from the gathered score columns; the padded rows are masked out first.
``save`` writes the whole gallery once, from rank 0, and every rank waits
for it.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.data.schema import VideoRecord
from vqwild_tpu_torch.ops.nms import temporal_nms
from vqwild_tpu_torch.parallel.distributed import barrier
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer

log = get_logger("serve.index")

_META_KEYS = ("video_id", "label", "retrieval_type")


def _write_atomic(path: str, writer) -> None:
    """tmp + os.replace: saving over an existing index must never leave a
    torn metadata file beside the previous feats.npy."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        writer(f)
    os.replace(tmp, path)


class GalleryIndex:
    """[N, C] fp32 clip embeddings + per-row metadata, scored on the device."""

    def __init__(self, feats: np.ndarray, meta: List[dict],
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if feats.ndim != 2 or feats.shape[0] != len(meta):
            raise ValueError(f"feats {feats.shape} vs {len(meta)} metadata rows")
        self.meta = meta
        self.feat_dim = feats.shape[1]
        self.scorer = GalleryScorer(feats, device=device, mesh=mesh)
        self.n = self.scorer.n

    # ---- construction ----

    @classmethod
    def build(cls, records: Sequence[VideoRecord], extractor,
              device: Union[str, torch.device] = "cuda", mesh=None) -> "GalleryIndex":
        """Embed trimmed records through the extractor (already
        temporal-mean clip embeddings [N, C], features.py extract_trimmed)."""
        feats = extractor.extract_trimmed(list(records))
        meta = [
            {k: getattr(r, k) for k in _META_KEYS} for r in records[: feats.shape[0]]
        ]
        return cls(np.asarray(feats, np.float32), meta, device=device, mesh=mesh)

    # ---- persistence ----

    def save(self, path: str) -> None:
        _save_once(self.scorer, self._write, path)

    def _write(self, path: str) -> None:
        # feats.npy is the load-detection marker — publish it LAST so an
        # interrupted save never leaves a directory that load() detects but
        # cannot read
        os.makedirs(path, exist_ok=True)
        # a stale windows.npz from a previous moment index would misdetect
        # this directory as a moment index at load time
        for stale in ("windows.npz", "videos.json"):
            if os.path.exists(os.path.join(path, stale)):
                os.remove(os.path.join(path, stale))
        _write_atomic(os.path.join(path, "meta.json"), lambda f: json.dump(self.meta, f))
        feats = self.scorer.gallery()
        tmp = os.path.join(path, ".feats.tmp.npy")
        np.save(tmp, feats)
        os.replace(tmp, os.path.join(path, "feats.npy"))
        log.info("saved gallery index (%d rows) to %s", self.n, path)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda",
             mesh=None) -> "GalleryIndex":
        feats = np.load(os.path.join(path, "feats.npy"), mmap_mode="r")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(np.asarray(feats), meta, device=device, mesh=mesh)

    # ---- queries ----

    def topk(self, qfeats: np.ndarray, k: int = 30):
        """[B, C] query embeddings → (scores [B, k], rows [B, k]) numpy.

        Scores are −‖q−g‖² (higher = closer), the reference's FAISS
        convention; on a tie the lower row comes first, as jax.lax.top_k
        orders it. Padded gallery rows (a mesh's) never enter it."""
        return _masked_topk(self.scorer, self.n, qfeats, min(k, self.n))

    def row_meta(self, row: int) -> dict:
        return self.meta[int(row)]

    def lookup(self, rows: Sequence[int]) -> List[dict]:
        return [self.meta[int(r)] for r in rows]


def _save_once(scorer: GalleryScorer, write, path: str) -> None:
    """``write(path)`` in the one process, or on rank 0 of a mesh while every
    rank waits for it."""
    if scorer.mesh is None or scorer.mesh.rank == 0:
        write(path)
    if scorer.mesh is not None:
        barrier("index_save")


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def _masked_topk(scorer: GalleryScorer, n: int, qfeats: np.ndarray, k: int):
    q = np.asarray(qfeats, np.float32)
    # the batch and k bucket to powers of two as in the JAX server, which
    # bounds the distinct kernel shapes the micro-batcher produces
    b = q.shape[0]
    bucket = _pow2(b)
    if bucket != b:
        q = np.concatenate([q, np.zeros((bucket - b,) + q.shape[1:], q.dtype)])
    kb = min(_pow2(k), n)
    scores = scorer.scores(q)
    if scorer.n_padded > n:  # a mesh's padded rows (copies of the last) rank last
        scores[:, n:] = -torch.inf
    # a stable descending sort keeps the lower row first on a tie; at a
    # moment index's 1.47M rows it beats torch.topk + a sort of the pool
    # on the card (chip_smoke.py, phase moment_serve)
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:b, :kb].cpu().numpy(), top_i[:b, :kb].cpu().numpy()
    return top_s[:, :k], top_i[:, :k]


class MomentIndex:
    """Window-level index for untrimmed moment serving.

    Holds every candidate moment window (multi-duration, enumerated like
    ARVRetrievalMoment.build_gallery) as a row: pooled feature + owning
    video + [start, end] seconds. A query scores all windows on the device
    (K1), preselects a candidate pool by top-k, then runs the reference's
    temporal NMS (+1 convention, ops/nms.py) per video on the host and
    returns the top-k surviving moments — the serving form of the moment
    evaluator's cluster→NMS postprocess (retrieval/moment.py).
    """

    def __init__(self, feats: np.ndarray, video_ids: List[str],
                 video_idx: np.ndarray, start_sec: np.ndarray,
                 end_sec: np.ndarray, device: Union[str, torch.device] = "cuda",
                 mesh=None):
        g = feats.shape[0]
        if feats.ndim != 2 or not video_idx.shape == start_sec.shape == end_sec.shape == (g,):
            raise ValueError(f"feats {feats.shape} vs windows {video_idx.shape}, "
                             f"{start_sec.shape}, {end_sec.shape}")
        self.video_ids = list(video_ids)
        self.video_idx = np.asarray(video_idx, np.int64)
        self.start_sec = np.asarray(start_sec, np.float64)
        self.end_sec = np.asarray(end_sec, np.float64)
        self.feat_dim = feats.shape[1]
        self.scorer = GalleryScorer(feats, device=device, mesh=mesh)
        self.n = self.scorer.n

    def save(self, path: str) -> None:
        _save_once(self.scorer, self._write, path)

    def _write(self, path: str) -> None:
        # windows.npz (the moment-index marker) and metadata first; the
        # feats.npy load-detection marker is published LAST (see
        # GalleryIndex.save)
        os.makedirs(path, exist_ok=True)
        wtmp = os.path.join(path, ".windows.tmp.npz")
        np.savez(wtmp, video_idx=self.video_idx,
                 start_sec=self.start_sec, end_sec=self.end_sec)
        os.replace(wtmp, os.path.join(path, "windows.npz"))
        _write_atomic(os.path.join(path, "videos.json"),
                      lambda f: json.dump(self.video_ids, f))
        feats = self.scorer.gallery()
        tmp = os.path.join(path, ".feats.tmp.npy")
        np.save(tmp, feats)
        os.replace(tmp, os.path.join(path, "feats.npy"))
        log.info("saved moment index (%d windows, %d videos) to %s",
                 self.n, len(self.video_ids), path)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda",
             mesh=None) -> "MomentIndex":
        feats = np.load(os.path.join(path, "feats.npy"), mmap_mode="r")
        with np.load(os.path.join(path, "windows.npz")) as z:
            video_idx, start_sec, end_sec = z["video_idx"], z["start_sec"], z["end_sec"]
        with open(os.path.join(path, "videos.json")) as f:
            video_ids = json.load(f)
        return cls(np.asarray(feats), video_ids, video_idx, start_sec, end_sec, device=device,
                   mesh=mesh)

    def topk(self, qfeats: np.ndarray, k: int = 30):
        """Raw window top-k (no NMS) — lets the micro-batched feature-query
        path serve a moment index too (rows are windows)."""
        return _masked_topk(self.scorer, self.n, qfeats, min(k, self.n))

    def row_meta(self, row: int) -> dict:
        row = int(row)
        return {
            "video_id": self.video_ids[int(self.video_idx[row])],
            "start_sec": float(self.start_sec[row]),
            "end_sec": float(self.end_sec[row]),
        }

    def query(self, qfeats: np.ndarray, k: int = 10,
              nms_threshold: float = 0.5,
              candidate_pool: Optional[int] = None) -> List[List[dict]]:
        """[B, C] query embeddings → per query, top-k NMS-surviving moments
        [{video_id, start_sec, end_sec, score, rank}].

        ``candidate_pool`` bounds the host-side NMS work: only the pool's
        top-scored windows enter suppression (default max(4096, 64·k);
        a suppressed-away tail beyond the pool cannot enter the top-k
        unless more than pool−k higher-scored windows die to NMS).
        """
        pool = min(self.n, candidate_pool or max(4096, 64 * k))
        top_s, top_i = _masked_topk(self.scorer, self.n, qfeats, pool)

        out: List[List[dict]] = []
        for bi in range(top_i.shape[0]):
            rows, rscores = top_i[bi], top_s[bi]
            survivors: List[tuple] = []  # (score, row)
            for vid in np.unique(self.video_idx[rows]):
                sel = np.nonzero(self.video_idx[rows] == vid)[0]
                dets = np.stack(
                    [self.start_sec[rows[sel]], self.end_sec[rows[sel]],
                     rscores[sel]], axis=1,
                )
                for ki in temporal_nms(dets, nms_threshold):
                    survivors.append((float(rscores[sel[ki]]), int(rows[sel[ki]])))
            survivors.sort(key=lambda t: -t[0])
            res = []
            for rank, (score, row) in enumerate(survivors[:k]):
                res.append({
                    "video_id": self.video_ids[int(self.video_idx[row])],
                    "start_sec": float(self.start_sec[row]),
                    "end_sec": float(self.end_sec[row]),
                    "score": score,
                    "rank": rank,
                })
            out.append(res)
        return out
