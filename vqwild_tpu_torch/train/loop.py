"""The training loop (reference main.py:533-620).

Counterpart of vqwild_tpu/train/loop.py. Epoch loop with periodic
trimmed-retrieval validation, best-checkpoint tracking on the 2-order
harmonic mAP, and step-level loss/throughput logging. The loop is
deliberately thin: data comes from a PrefetchLoader, compute from
make_train_step, evaluation from a caller-supplied callback — so tests can
drive it end-to-end on synthetic data.

On a CUDA device each batch goes up through pinned host memory on a side
stream while the step before it runs, and the losses are read back once a
print, never once a step: between prints the host never waits on the card.

Under a profiler the loop records (core/profiling.py) the spans
``train.data_wait`` (the next batch from the loader), ``train.upload``,
``train.step``, ``train.drain`` (the losses' readback), ``train.checkpoint``
and ``train.validate``, each with the id (epoch, step), and the counters
``train.steps``, ``train.clips`` (rows), ``train.upload_bytes`` and
``train.host_syncs`` (drains). The ``dataload=`` log is the mean wait for
the loader's next batch.

Under a ``mesh`` (parallel/mesh.py) every rank runs this loop over the same
global batches: rows pad (edge-repeat) to a multiple of the world size, a
0/1 weight marks the padding, and each rank uploads only its row block.
Validation runs on every rank (the sharded evaluator), the ``best``
decision is rank 0's score on every rank, and the checkpoint manager lets
rank 0 write.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.core.meters import AverageMeter
from vqwild_tpu_torch.parallel.mesh import rank_rows
from vqwild_tpu_torch.train.checkpoint import CheckpointManager, last_payload
from vqwild_tpu_torch.train.step import TrainState

log = get_logger("train.loop")


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    best_score: float
    best_epoch: int
    history: list


class NonFiniteLossError(RuntimeError):
    """Training diverged: a loss became NaN/Inf (train failure detection).

    The reference has no failure detection (SURVEY §5) — a NaN quietly burns
    the remaining epochs and poisons the checkpoints. Here the loop halts at
    the next loss sync; the previous epoch's ``last`` checkpoint (saved
    before the divergence finished an epoch) is the resume point.
    """


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of CPU tensor ``t`` in pinned memory, made by numpy on this
    thread alone, the GIL released. Torch's own (``pin_memory``) splits the
    copy over its intra-op threads, which then spin on the cores that this
    thread needs to launch the step and the loader's threads need to build
    batches: on an 8-core host beside an H100 the launching thread fell
    behind a 63 ms step for seconds at a time."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    np.copyto(out.numpy(), t.numpy())
    return out


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,
        loader,
        epochs: int,
        eval_fn: Optional[Callable] = None,  # (state, epoch) -> score dict
        eval_per_epoch: int = 2,
        ckpt: Optional[CheckpointManager] = None,
        mesh=None,
        print_freq: int = 100,
        max_steps_per_epoch: Optional[int] = None,
        start_epoch: int = 0,
        scan_fn: Optional[Callable] = None,
        scan_steps: int = 1,
        nonfinite_policy: str = "halt",
    ):
        """``scan_fn`` + ``scan_steps`` > 1 run groups of ``scan_steps``
        batches, stacked on the host, through one call of
        train/step.py:make_scanned_train_step. Leftover batches
        (< scan_steps at epoch end) go through ``step_fn`` one at a time —
        zero-weight padding would still advance the optimizer (weight
        decay, bias correction), so it is never used to fill a group.

        ``nonfinite_policy``: what to do when a synced loss is NaN/Inf —
        "halt" (default) raises NonFiniteLossError at the next loss sync
        (losses sync every print_freq steps, so detection lags at most that
        many steps — by design, a per-step readback would make the host
        wait on the device every step); "warn" logs and keeps going."""
        if nonfinite_policy not in ("halt", "warn"):
            raise ValueError(f"unknown nonfinite_policy {nonfinite_policy!r}")
        self.step_fn = step_fn
        self.loader = loader
        self.epochs = epochs
        self.eval_fn = eval_fn
        self.eval_per_epoch = eval_per_epoch
        self.ckpt = ckpt
        self.mesh = mesh
        self.print_freq = print_freq
        self.max_steps = max_steps_per_epoch
        self.start_epoch = start_epoch
        self.scan_fn = scan_fn
        self.scan_steps = scan_steps if scan_fn is not None else 1
        self.nonfinite_policy = nonfinite_policy
        self._dev = torch.device("cpu")
        self._copy_stream = None

    def _upload(self, arrays) -> tuple:
        """Host arrays → tensors on the state's device. On a CUDA device each
        array is copied into pinned memory and uploaded on a side stream; the
        compute stream waits for that copy from here on (work already queued
        on it does not), and each tensor is marked as used by the compute
        stream, so that its memory is not reused while a step still reads it."""
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        profiling.count("train.upload_bytes", sum(t.nbytes for t in tensors))
        if self._dev.type == "cpu":
            return tensors
        if self._dev.type != "cuda":
            raise ValueError(f"TrainLoop runs on cpu or cuda, not {self._dev}")
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self._dev)
        compute = torch.cuda.current_stream(self._dev)
        with torch.cuda.stream(self._copy_stream):
            out = tuple(_pinned(t).to(self._dev, non_blocking=True) for t in tensors)
        compute.wait_stream(self._copy_stream)
        for t in out:
            t.record_stream(compute)
        return out

    def _rows(self, arrays, n: int, axis: int, sharded: bool):
        """(this rank's row block of each array along ``axis``, its 0/1
        weights or None): rows pad to the world size's multiple by
        edge-repeat (parallel/mesh.rank_rows), the padding weighs 0.
        ``sharded`` arrays already are the rank's block of a global batch
        of ``n`` real rows (data/triplets.py's shard). No padding, no
        weights."""
        world, rank = self.mesh.size, self.mesh.rank
        idx = rank_rows(n, rank, world)
        if not sharded:
            arrays = tuple(np.take(a, idx, axis=axis) for a in arrays)
        if n % world == 0:
            return arrays, None
        return arrays, (rank * len(idx) + np.arange(len(idx)) < n).astype(np.float32)

    def _put(self, batch):
        """→ (wire tensors..., labels, weights-or-None) on the state's
        device. Without a mesh there is no padding, so no weights; under a
        mesh this rank's rows of the padded global batch, and their 0/1
        weights where rows were padded."""
        arrays = batch.arrays + (batch.labels,)
        if self.mesh is None:
            return self._upload(arrays) + (None,)
        n = getattr(batch, "global_rows", None)
        arrays, weights = self._rows(arrays, n or batch.labels.shape[0], 0, n is not None)
        if weights is None:
            return self._upload(arrays) + (None,)
        return self._upload(arrays + (weights,))

    def _put_group(self, group):
        """Stack ``len(group)`` loader batches along a leading scan axis →
        (arrays [K,B,...], labels [K,B], weights [K,B]-or-None); under a mesh
        the rows pad and split on the second axis."""
        stacked = [
            np.stack([b.arrays[j] for b in group])
            for j in range(len(group[0].arrays))
        ]
        labels = np.stack([b.labels for b in group])
        arrays = tuple(stacked) + (labels,)
        if self.mesh is None:
            return self._upload(arrays) + (None,)
        n = getattr(group[0], "global_rows", None)
        arrays, weights = self._rows(arrays, n or labels.shape[1], 1, n is not None)
        if weights is None:
            return self._upload(arrays) + (None,)
        return self._upload(arrays + (np.tile(weights, (len(group), 1)),))

    def _agreed(self, score: float) -> float:
        """Rank 0's ``score`` on every rank: every rank then takes the same
        ``best`` decision."""
        if self.mesh is None or self.mesh.size == 1:
            return score
        t = torch.tensor([score if self.mesh.rank == 0 else 0.0], dtype=torch.float64)
        return float(self.mesh.all_sum(t.to(self.mesh.device)).cpu()[0])

    def run(self, state: TrainState) -> LoopResult:
        self._dev = next(state.model.parameters()).device
        profiling.begin(self._dev)
        best_score, best_epoch = -1.0, -1
        history = []
        for epoch in range(self.start_epoch, self.epochs):
            data_wait = AverageMeter()
            loss_meters: Dict[str, AverageMeter] = {}
            nsteps = 0

            def waited(fetch, sid):
                """``fetch()``, its time the loop's wait for data."""
                t0 = time.perf_counter()
                out = fetch()
                t1 = time.perf_counter()
                data_wait.update(t1 - t0)
                profiling.add("train.data_wait", t0, t1, sid)
                return out

            def capped():
                for i, b in enumerate(self.loader.epoch(epoch)):
                    if self.max_steps is not None and i >= self.max_steps:
                        return
                    yield b

            def drain(pending):
                """Every pending loss in one device-to-host copy, into the
                meters in step order; then the non-finite check."""
                if not pending:
                    return
                with profiling.span("train.drain", (epoch, nsteps)):
                    flat = [(k, torch.as_tensor(v, dtype=torch.float64).reshape(-1))
                            for entry in pending for k, v in entry.items()]
                    host = torch.cat([v for _, v in flat]).cpu().numpy()
                profiling.count("train.host_syncs")
                profiling.settle()
                pending.clear()
                bad = None
                at = 0
                for k, v in flat:
                    for x in host[at:at + v.numel()]:
                        if not np.isfinite(x) and bad is None:
                            bad = (k, float(x))
                        loss_meters.setdefault(k, AverageMeter()).update(float(x))
                    at += v.numel()
                if bad is not None:
                    msg = (
                        f"non-finite loss {bad[0]}={bad[1]} detected by epoch "
                        f"{epoch} step {nsteps} (sync granularity "
                        f"print_freq={self.print_freq}); resume from the "
                        f"'last' checkpoint of the previous epoch"
                    )
                    if self.nonfinite_policy == "halt":
                        log.error(msg)
                        raise NonFiniteLossError(msg)
                    log.warning(msg)

            pending = []  # the steps' loss tensors, read back only at print time

            def progress_log(step_idx):
                drain(pending)
                log.info(
                    "[%d][%d] %s dataload=%.3fs best=%.3f",
                    epoch,
                    step_idx,
                    " ".join(
                        f"{k}={m.avg:.4f}" for k, m in sorted(loss_meters.items())
                    ),
                    data_wait.avg,
                    best_score,
                )

            def call(fn, arrays, sid, steps):
                *arrs, weights = arrays
                with profiling.span("train.step", sid):
                    out = (fn(state, *arrs) if weights is None
                           else fn(state, *arrs, weights=weights))
                profiling.count("train.steps", steps)
                profiling.count("train.clips", arrs[-1].numel())
                return out

            next_print = self.print_freq
            if self.scan_steps > 1:
                it = iter(capped())
                while True:
                    sid = (epoch, nsteps)
                    group = waited(lambda: list(itertools.islice(it, self.scan_steps)), sid)
                    if not group:
                        break
                    if len(group) == self.scan_steps:
                        with profiling.span("train.upload", sid):
                            arrays = self._put_group(group)
                        state, losses = call(self.scan_fn, arrays, sid, len(group))
                        nsteps += len(group)
                        pending.append(losses)
                    else:  # epoch tail < scan window → per-step fn
                        for b in group:
                            sid = (epoch, nsteps)
                            with profiling.span("train.upload", sid):
                                arrays = self._put(b)
                            state, losses = call(self.step_fn, arrays, sid, 1)
                            nsteps += 1
                            pending.append(losses)
                    if nsteps >= next_print:
                        next_print += self.print_freq
                        progress_log(nsteps)
            else:
                # one-batch lookahead: batch k+1 goes up while step k runs
                def batches():
                    it = iter(capped())
                    nxt = waited(lambda: next(it, None), (epoch, 0))
                    k = 0
                    while nxt is not None:
                        with profiling.span("train.upload", (epoch, k)):
                            cur = self._put(nxt)
                        nxt = waited(lambda: next(it, None), (epoch, k + 1))
                        yield cur
                        k += 1

                for i, arrays in enumerate(batches()):
                    state, losses = call(self.step_fn, arrays, (epoch, i), 1)
                    nsteps += 1
                    pending.append(losses)
                    if i % self.print_freq == 0 and i > 0:
                        progress_log(i)
            drain(pending)
            log.info(
                "epoch %d done: %d steps, %s",
                epoch,
                nsteps,
                " ".join(f"{k}={m.avg:.4f}" for k, m in sorted(loss_meters.items())),
            )
            entry = dict(
                epoch=epoch,
                steps=nsteps,
                losses={k: m.avg for k, m in sorted(loss_meters.items())},
            )
            history.append(entry)

            if self.ckpt is not None:
                # the full training state, for a resume mid-training (the
                # reference saves best only, SURVEY §5)
                with profiling.span("train.checkpoint", (epoch, nsteps)):
                    self.ckpt.save("last", last_payload(state, epoch))

            is_eval_epoch = (
                self.eval_fn is not None and (epoch + 1) % self.eval_per_epoch == 0
            )
            if is_eval_epoch:
                with profiling.span("train.validate", (epoch, nsteps)):
                    score = self.eval_fn(state, epoch)
                ap = self._agreed(float(score.get("ap", 0.0)))
                entry["ap"] = ap
                log.warning("epoch %d validation ap=%.4f (best %.4f)", epoch, ap, best_score)
                if ap > best_score:
                    best_score, best_epoch = ap, epoch
                    if self.ckpt is not None:
                        with profiling.span("train.checkpoint", (epoch, nsteps)):
                            self.ckpt.save(
                                "best",
                                dict(model=state.model.state_dict(), epoch=epoch, score=ap),
                            )
        profiling.settle()
        return LoopResult(
            state=state, best_score=best_score, best_epoch=best_epoch, history=history
        )
