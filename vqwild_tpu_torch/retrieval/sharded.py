"""Device-resident gallery scoring, on one device or row-sharded over a
mesh.

Counterpart of vqwild_tpu/retrieval/sharded.py ``GalleryScorer``. Under a
``mesh`` (parallel/mesh.py) the gallery pads to a multiple of the world
size and each rank holds its row block; every query chunk is scored on
each rank's block by kernel K1, and the score columns are gathered in rank
order, so every rank ranks the whole gallery. The JAX scorer scores a
sharded gallery with XLA's matmul, because GSPMD cannot partition a Pallas
call (vqwild_tpu/ops/distance.py:49-55); a rank here owns its block and
calls the kernel on it. The JAX module's ``warm_*`` functions compile XLA
programs ahead of time; eager PyTorch has no program to compile, so they
have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.ops import ranking
from vqwild_tpu_torch.ops.distance import score_matrix
from vqwild_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch_arrays


def stack_query_chunks(
    expanded,
    rank_chunk: int,
    query_num: int,
    k_src: int,
    label_id_of,
    src_vids_of,
):
    """Batch every expanded query list into the stacked chunk arrays the
    whole-eval loop consumes (GalleryScorer.eval_metrics_all).

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
    """Holds the gallery on the device, or this rank's row block of it under
    a ``mesh`` (the mesh's device then; ``device`` is not read); scores
    query chunks with kernel K1. Column ids and the query bank are the
    whole padded gallery's on every rank."""

    def __init__(self, gallery_feats: np.ndarray, device: Union[str, torch.device] = "cuda",
                 mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        g = np.array(gallery_feats, np.float32, order="C")  # a copy: feats may be a read-only memmap
        self.n = g.shape[0]
        self._g_full = None
        if mesh is None:
            self.n_padded = self.n
            self.g_dev = torch.from_numpy(g).to(self.device)
        else:
            self._g_full, _ = pad_to_multiple(g, mesh.size)
            self.n_padded = self._g_full.shape[0]
            (self.g_dev,) = shard_batch_arrays(mesh, self._g_full)
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
        gallery rows (trimmed eval) — the bank is the gallery itself (the
        whole padded gallery on every rank under a mesh)."""
        if feats is None and self.mesh is not None:
            self._q_bank = torch.from_numpy(self._g_full).to(self.device)
        elif feats is None:
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
        """One query chunk on the device (the body of
        ops.ranking.fused_chunk_metrics, with the score columns gathered
        under a mesh before the masks). q_rows [B,query_num] i32 rows into
        the query bank; q_label_ids [B] i32; q_src_vids [B,K] i32 (pad -2).
        Returns device tensors."""
        return self._chunk(self._ids(q_rows), self._ids(q_label_ids), self._ids(q_src_vids),
                           tuple(r_at_n), robust, topk, full_rank)

    def eval_metrics_all(
        self,
        q_rows: np.ndarray,
        q_label_ids: np.ndarray,
        q_src_vids: np.ndarray,
        r_at_n=(30, 50, 100),
        robust: bool = True,
    ):
        """EVERY query chunk, queued on the device without a readback (the
        loop of ops.ranking.fused_eval_metrics): q_rows [n_chunks, B,
        query_num] etc. Returns the dict of device tensors; callers copy it
        to the host once. The tail chunk must be padded with replicated
        VALID queries (extras dropped on the host)."""
        aps, recalls = [], []
        for qr, ql, qs in zip(self._ids(q_rows), self._ids(q_label_ids), self._ids(q_src_vids)):
            out = self._chunk(qr, ql, qs, tuple(r_at_n), robust)
            aps.append(out["ap"])
            recalls.append(out["recalls"])
        return dict(ap=torch.stack(aps), recalls=torch.stack(recalls))

    def _chunk(self, q_rows, q_label_ids, q_src_vids, r_at_n, robust, topk=0, full_rank=False):
        assert self._col_label_ids is not None, "set_columns() first"
        scores = self._columns(ranking.gather_scores(self.q_bank, self.g_dev, q_rows))
        tp, ignore = ranking.build_eval_masks(self._col_label_ids, self._col_vid_ids,
                                              q_label_ids, q_src_vids)
        return ranking.ranked_retrieval_metrics(scores, tp, ignore, r_at_n, robust, topk,
                                                full_rank)

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
        return self._columns(ranking.gather_scores(self.q_bank, self.g_dev, self._ids(q_rows)))

    def _columns(self, s: torch.Tensor) -> torch.Tensor:
        """This rank's score columns → every rank's, in rank order."""
        return s if self.mesh is None else self.mesh.gather(s, dim=1)

    def scores(self, qfeats, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """[B, D] queries → [B, n_padded] scores −‖q−g‖² (device tensor).

        ``out_dtype`` casts on the device, before any readback: bf16 halves
        the device→host bytes of a wide score matrix."""
        q = torch.as_tensor(qfeats, dtype=torch.float32).to(self.device).contiguous()
        s = self._columns(score_matrix(q, self.g_dev))
        return s if out_dtype is None else s.to(out_dtype)
