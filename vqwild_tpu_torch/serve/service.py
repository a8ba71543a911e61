"""Micro-batched query service (counterpart of vqwild_tpu/serve/service.py,
same batching and error semantics).

An always-on GPU process wastes the card if every query launches alone;
the service collects concurrent requests for up to ``max_wait_ms`` (or
``max_batch`` requests, whichever first) and ranks them with ONE scoring
launch. Latency cost is bounded by the window; throughput approaches the
device-resident batch rate.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex

log = get_logger("serve.service")


@dataclass
class _Pending:
    qfeat: np.ndarray  # [C]
    k: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[dict]] = None
    error: Optional[BaseException] = None


class QueryService:
    """Answers top-k gallery queries; thread-safe, micro-batching.

    ``embed_fn`` (optional) maps cropped YUV420 planes to frame embeddings
    [B, C, T] — the serving trunk from retrieval.features.make_feat_fn;
    without it only feature queries are served. ``moment_index`` (a
    serve.index.MomentIndex, optional) answers ``query_moments``.
    """

    def __init__(
        self,
        index: GalleryIndex,
        embed_fn: Optional[Callable] = None,
        default_k: int = 30,
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
        moment_index: Optional[MomentIndex] = None,
    ):
        self.index = index
        self.embed_fn = embed_fn
        self.moment_index = moment_index
        self.default_k = default_k
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- public API ----

    def query_features(self, qfeat: np.ndarray, k: Optional[int] = None) -> List[dict]:
        """[C] (or [1, C]) clip embedding → top-k [{video_id, label,
        retrieval_type, score, rank}]. Blocks until served.

        Validates the feature dim BEFORE enqueueing: a malformed request
        must fail alone, never the whole micro-batch it would coalesce
        into."""
        if self._stop.is_set():
            raise RuntimeError("service is closed")
        qfeat = np.asarray(qfeat, np.float32).reshape(-1)
        if qfeat.shape[0] != self.index.feat_dim:
            raise ValueError(
                f"feature dim {qfeat.shape[0]} != index dim {self.index.feat_dim}"
            )
        k = self.default_k if k is None else int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        p = _Pending(qfeat=qfeat, k=k)
        self._q.put(p)
        # bounded wait: a close() racing the enqueue could otherwise strand
        # this waiter forever
        while not p.done.wait(timeout=0.5):
            if self._stop.is_set():
                raise RuntimeError("service closed before the query was served")
        if p.error is not None:
            raise p.error
        return p.result

    def query_clip(self, y_u8: np.ndarray, uv_u8: np.ndarray,
                   k: Optional[int] = None) -> List[dict]:
        """Cropped YUV420 planes [T, s, s] / [T, s/2, s/2, 2] → top-k.

        The embed dispatch is per-call (clip shapes vary); the ranking still
        micro-batches with concurrent feature queries."""
        if self.embed_fn is None:
            raise RuntimeError("service built without an embed_fn")
        fe = np.asarray(self.embed_fn(y_u8[None], uv_u8[None]))  # [1, C, T]
        return self.query_features(fe[0].mean(axis=1), k=k)

    def query_moments(self, qfeat: np.ndarray, k: int = 10,
                      nms_threshold: float = 0.5) -> List[dict]:
        """[C] clip embedding → top-k NMS-surviving untrimmed moments.

        Served directly from the calling thread, not micro-batched: the
        moment postprocess is per-query host work, and concurrent calls
        each launch K1 (its launch path and launch count are thread-safe)."""
        if self.moment_index is None:
            raise RuntimeError("service built without a moment_index")
        qfeat = np.asarray(qfeat, np.float32).reshape(1, -1)
        return self.moment_index.query(qfeat, k=k, nms_threshold=nms_threshold)[0]

    def close(self) -> None:
        """Stop the worker; fail (never strand) any still-queued waiters."""
        self._stop.set()
        self._worker.join(timeout=2.0)
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("service closed before the query was served")
            p.done.set()

    # ---- batching worker ----

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = _now() + self.max_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - _now()
                if timeout <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    break
            try:
                self._serve(batch)
            except BaseException as e:  # propagate to every unfinished waiter
                for p in batch:
                    # skip waiters _serve already completed with a valid
                    # result: setting error after done would race a client
                    # between done.wait() and the error check
                    if p.done.is_set():
                        continue
                    p.error = e
                    p.done.set()

    def _serve(self, batch: List[_Pending]) -> None:
        qfeats = np.stack([p.qfeat for p in batch])
        kmax = max(p.k for p in batch)
        scores, rows = self.index.topk(qfeats, k=kmax)
        for bi, p in enumerate(batch):
            out = []
            for rank in range(p.k):
                if rank >= rows.shape[1]:
                    break
                meta = self.index.row_meta(rows[bi, rank])
                out.append({**meta, "score": float(scores[bi, rank]), "rank": rank})
            p.result = out
            p.error = None
            p.done.set()


def _now() -> float:
    import time

    return time.monotonic()
