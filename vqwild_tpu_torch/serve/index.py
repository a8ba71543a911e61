"""The serving gallery index: clip embeddings + metadata, on the device.

Counterpart of vqwild_tpu/serve/index.py ``GalleryIndex``. The on-disk
format is the same (``feats.npy`` + ``meta.json``), so either package
serves an index the other built. ``MomentIndex`` comes with the moment
slice.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.data.schema import VideoRecord
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
                 device: Union[str, torch.device] = "cuda"):
        if feats.ndim != 2 or feats.shape[0] != len(meta):
            raise ValueError(f"feats {feats.shape} vs {len(meta)} metadata rows")
        self.meta = meta
        self.feat_dim = feats.shape[1]
        self.scorer = GalleryScorer(feats, device=device)
        self.n = self.scorer.n

    # ---- construction ----

    @classmethod
    def build(cls, records: Sequence[VideoRecord], extractor,
              device: Union[str, torch.device] = "cuda") -> "GalleryIndex":
        """Embed trimmed records through the extractor (already
        temporal-mean clip embeddings [N, C], features.py extract_trimmed)."""
        feats = extractor.extract_trimmed(list(records))
        meta = [
            {k: getattr(r, k) for k in _META_KEYS} for r in records[: feats.shape[0]]
        ]
        return cls(np.asarray(feats, np.float32), meta, device=device)

    # ---- persistence ----

    def save(self, path: str) -> None:
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
        feats = self.scorer.g_dev[: self.n].cpu().numpy()
        tmp = os.path.join(path, ".feats.tmp.npy")
        np.save(tmp, feats)
        os.replace(tmp, os.path.join(path, "feats.npy"))
        log.info("saved gallery index (%d rows) to %s", self.n, path)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda") -> "GalleryIndex":
        feats = np.load(os.path.join(path, "feats.npy"), mmap_mode="r")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return cls(np.asarray(feats), meta, device=device)

    # ---- queries ----

    def topk(self, qfeats: np.ndarray, k: int = 30):
        """[B, C] query embeddings → (scores [B, k], rows [B, k]) numpy.

        Scores are −‖q−g‖² (higher = closer), the reference's FAISS
        convention; on a tie the lower row comes first, as jax.lax.top_k
        orders it."""
        return _masked_topk(self.scorer, self.n, qfeats, min(k, self.n))

    def row_meta(self, row: int) -> dict:
        return self.meta[int(row)]

    def lookup(self, rows: Sequence[int]) -> List[dict]:
        return [self.meta[int(r)] for r in rows]


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
    scores = scorer.scores(q)  # one device: n_padded == n, nothing to mask
    # a stable descending sort keeps the lower row first on a tie
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:b, :kb].cpu().numpy(), top_i[:b, :kb].cpu().numpy()
    return top_s[:, :k], top_i[:, :k]
