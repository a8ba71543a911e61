"""Device-resident gallery scoring.

Counterpart of vqwild_tpu/retrieval/sharded.py ``GalleryScorer`` on one
device (the mesh-sharded gallery comes with the multi-GPU slice). The JAX
module's ``warm_*`` functions compile XLA programs ahead of time; eager
PyTorch has no program to compile, so they have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.ops.distance import score_matrix
from vqwild_tpu_torch.ops.ranking import (
    fused_chunk_metrics,
    fused_eval_metrics,
    gather_scores,
)


def stack_query_chunks(
    expanded,
    rank_chunk: int,
    query_num: int,
    k_src: int,
    label_id_of,
    src_vids_of,
):
    """Batch every expanded query list into the stacked chunk arrays the
    whole-eval loop consumes (fused_eval_metrics).

    → (q_rows [n_chunks, B, query_num], q_label_ids [n_chunks, B],
    q_src_vids [n_chunks, B, k_src]). The tail chunk pads by replicating
    query 0 — real, valid inputs whose outputs the caller drops (index ≥
    len(expanded) after flattening) — because -1 rows would NaN the
    masked-mean feature gather. ``label_id_of(i)``/``src_vids_of(qs)`` map a
    query index / expanded list to its label id and source-video id list.
    """
    qe = len(expanded)
    assert qe > 0
    b = min(rank_chunk, qe)
    n_chunks = (qe + b - 1) // b
    total = n_chunks * b
    q_rows = np.full((total, query_num), -1, np.int32)
    q_src = np.full((total, k_src), -2, np.int32)
    q_lab = np.zeros(total, np.int32)
    for i, qs in enumerate(expanded):
        take = qs[:query_num]
        q_rows[i, : len(take)] = take
        q_lab[i] = label_id_of(qs[0])
        q_src[i, : len(qs)] = src_vids_of(qs)
    if total > qe:
        q_rows[qe:] = q_rows[0]
        q_lab[qe:] = q_lab[0]
        q_src[qe:] = q_src[0]
    return (
        q_rows.reshape(n_chunks, b, query_num),
        q_lab.reshape(n_chunks, b),
        q_src.reshape(n_chunks, b, k_src),
    )


class GalleryScorer:
    """Holds the gallery on the device; scores query chunks with kernel K1."""

    def __init__(self, gallery_feats: np.ndarray, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        g = np.array(gallery_feats, np.float32, order="C")  # a copy: feats may be a read-only memmap
        self.n = g.shape[0]
        self.n_padded = self.n  # one device: no shard padding
        self.g_dev = torch.from_numpy(g).to(self.device)
        self._col_label_ids = None
        self._col_vid_ids = None
        self._q_bank = None

    def _ids(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    @property
    def q_bank(self) -> torch.Tensor:
        """Device-resident query-feature bank (set_query_bank)."""
        assert self._q_bank is not None, "set_query_bank() first"
        return self._q_bank

    # ---- device-resident eval state (id-based mask path) ----

    def set_columns(self, label_ids: np.ndarray, vid_ids: np.ndarray):
        """Upload per-gallery-item label/video ids once ([G] i32, ≥0).
        Padded rows get -1 so build_eval_masks force-ignores them."""
        assert label_ids.shape == vid_ids.shape == (self.n,)

        def _pad(a):
            a = np.asarray(a, np.int32)
            if self.n_padded > self.n:
                a = np.concatenate([a, np.full(self.n_padded - self.n, -1, np.int32)])
            return self._ids(a)

        self._col_label_ids = _pad(label_ids)
        self._col_vid_ids = _pad(vid_ids)

    def set_query_bank(self, feats: Optional[np.ndarray]):
        """Upload the query-feature bank once. ``None`` means queries are
        gallery rows (trimmed eval) — the bank is the gallery itself."""
        if feats is None:
            self._q_bank = self.g_dev
        else:
            bank = np.array(feats, np.float32, order="C")
            self._q_bank = torch.from_numpy(bank).to(self.device)

    def chunk_metrics(
        self,
        q_rows: np.ndarray,
        q_label_ids: np.ndarray,
        q_src_vids: np.ndarray,
        r_at_n=(30, 50, 100),
        robust: bool = True,
        topk: int = 0,
        full_rank: bool = False,
    ):
        """One query chunk on the device (ops.ranking.fused_chunk_metrics).
        q_rows [B,query_num] i32 rows into the query bank; q_label_ids [B]
        i32; q_src_vids [B,K] i32 (pad -2). Returns device tensors."""
        assert self._col_label_ids is not None, "set_columns() first"
        return fused_chunk_metrics(
            self.q_bank,
            self.g_dev,
            self._col_label_ids,
            self._col_vid_ids,
            self._ids(q_rows),
            self._ids(q_label_ids),
            self._ids(q_src_vids),
            r_at_n=tuple(r_at_n),
            robust=robust,
            topk=topk,
            full_rank=full_rank,
        )

    def eval_metrics_all(
        self,
        q_rows: np.ndarray,
        q_label_ids: np.ndarray,
        q_src_vids: np.ndarray,
        r_at_n=(30, 50, 100),
        robust: bool = True,
    ):
        """EVERY query chunk, queued on the device without a readback
        (ops.ranking.fused_eval_metrics): q_rows [n_chunks, B, query_num]
        etc. Returns the dict of device tensors; callers copy it to the host
        once. The tail chunk must be padded with replicated VALID queries
        (extras dropped on the host)."""
        assert self._col_label_ids is not None, "set_columns() first"
        return fused_eval_metrics(
            self.q_bank,
            self.g_dev,
            self._col_label_ids,
            self._col_vid_ids,
            self._ids(q_rows),
            self._ids(q_label_ids),
            self._ids(q_src_vids),
            r_at_n=tuple(r_at_n),
            robust=robust,
        )

    def pad_columns(self, tp: np.ndarray, ignore: np.ndarray):
        """Extend per-query tp/ignore to padded gallery width (pads ignored)."""
        extra = self.n_padded - self.n
        if extra == 0:
            return tp, ignore
        tp = np.concatenate([tp, np.zeros((tp.shape[0], extra), bool)], axis=1)
        ignore = np.concatenate(
            [ignore, np.ones((ignore.shape[0], extra), bool)], axis=1
        )
        return tp, ignore

    def scores_from_bank(self, q_rows: np.ndarray) -> torch.Tensor:
        """[B, query_num] i32 rows (pad -1) → [B, n_padded] scores (device).

        Like ``scores`` but the query features are gathered (masked mean)
        from the device-resident bank, so the per-chunk upload is the i32
        row index array instead of the [B, D] f32 features."""
        return gather_scores(self.q_bank, self.g_dev, self._ids(q_rows))

    def scores(self, qfeats) -> torch.Tensor:
        """[B, D] queries → [B, n_padded] scores −‖q−g‖² (device tensor)."""
        q = torch.as_tensor(qfeats, dtype=torch.float32).to(self.device).contiguous()
        return score_matrix(q, self.g_dev)
