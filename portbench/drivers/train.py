"""Entry kind ``train``: the port's training loop, closed loop, for the window.

Set-up builds one train state (the VA model from seeded weights, torch's
Adam, the dropout generator), the triplet loader over the packed 4:2:0
store, and drives ``TrainLoop`` through its first steps: the steps the
reference follows, then warm-up. The same state and loader then train for
the window: ``train_clips_per_s`` is every clip whose step completed in
the window over the window's seconds, the window ending when the device
finishes the last step.

``correct`` compares the first three steps with the plain reference
(reference/arv.py) run on the same batches from the same weights and
dropout seed: the first step's loss, each leaf's gradient norm as Adam
took it in step 1 by the worst leaf, and each leaf's change of norm after
step 3 by the median leaf; and every clip of those batches against the
store it was read from. Every step's loss and the worst leaf's change are
logged.
"""

from __future__ import annotations

import gc
import statistics
from typing import Dict, List

import numpy as np

from portbench.harness import data, traffic
from portbench.harness.common import CACHE_DIR, Check, Ctx, Outcome, log, now
from portbench.harness.peaks import train_flops_per_clip
from portbench.harness.trace import Tracer
from portbench.harness.weights import make_state
from portbench.reference import arv as ref_arv
from portbench.reference import loader as ref_loader

CHECKED_STEPS = 3


class TimedLoader:
    """A loader's epochs, with the time the loop waits for each batch (the
    loop's data time); a frozen copy of chip_smoke.TimedLoader."""

    def __init__(self, inner, tracer=None):
        self.inner, self.tracer = inner, tracer
        self.waits, self.started = {}, {}
        self.current = None

    def epoch(self, e):
        waits = self.waits.setdefault(e, [])
        self.started[e] = now()
        self.current = e
        it = self.inner.epoch(e)
        while True:
            t0 = now()
            b = next(it, None)
            if b is None:
                return
            t1 = now()
            waits.append(t1 - t0)
            if self.tracer is not None:
                self.tracer.add("portbench.loader_wait", t0, t1)
            yield b


class WindowLoader:
    """Epoch ``epoch`` of a loader, started and its first batch fetched
    before the window opens, then batches until ``deadline``. The loader's
    threads are stopped by ``close``, after the window: stopping them
    inside it would leave the device idle before the last step."""

    def __init__(self, inner, epoch: int):
        self.it = inner.epoch(epoch)
        self.first = next(self.it)
        self.deadline = None

    def epoch(self, e):
        yield self.first
        while now() < self.deadline:
            b = next(self.it, None)
            if b is None:
                return
            yield b

    def close(self):
        self.it.close()


def _hp(p: dict) -> dict:
    return {k: p[k] for k in ("dropout", "nl_dropout", "temperature", "moving_average",
                              "init_lr", "weight_decay")}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's)."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys):
    """(the worst leaf's gap, that leaf)."""
    gaps = _leaf_gaps(prog, ref, keys)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _leaf_norms(torch, tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[k].double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def run(ctx: Ctx) -> Outcome:
    import torch

    from vqwild_tpu_torch.core.device import disable_tf32
    from vqwild_tpu_torch.data.frames import PackedYUV420FrameStore
    from vqwild_tpu_torch.data.labels import load_split_file
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
    from vqwild_tpu_torch.models.arv import ARVModel
    from vqwild_tpu_torch.train.loop import TrainLoop
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    p, dev = ctx.params, ctx.device
    if p["compute_dtype"] != "float32" or p["tf32"]:
        raise SystemExit("portbench: the train driver runs float32 with TF32 off")
    disable_tf32()
    root = data.train_store(torch, dev, CACHE_DIR, p)
    spec = load_split_file(f"{root}/split.json")
    db = load_trimmed_db(spec.db_json)
    store = PackedYUV420FrameStore(root)
    ds = TripletDataset(db, spec, store, novel_num=p["novel_num"], train_frames=p["frames"],
                        crop_size=p["crop"], fps=p["fps"], nclass=p["nclass"], wire=p["wire"])
    loader = PrefetchLoader(ds, batch_size=p["triplets"], steps_per_epoch=p["epoch_steps"],
                            workers=p["workers"], seed=traffic.sub_seed(ctx.seed,
                                                                        traffic.ROLE_LOADER))
    layout = ref_arv.va_layout(p["nclass"], p["feat_dim"])
    w_seed = traffic.sub_seed(ctx.seed, traffic.ROLE_WEIGHTS)
    d_seed = traffic.sub_seed(ctx.seed, traffic.ROLE_DROPOUT)
    sd0 = make_state(layout, w_seed, dev)
    with dev:
        model = ARVModel(method=p["method"], nclass=p["nclass"], feat_dim=p["feat_dim"],
                         dropout=p["dropout"], nl_dropout=p["nl_dropout"],
                         temperature=p["temperature"], moving_average=p["moving_average"],
                         bn_eps=p["bn_eps"], bn_momentum=p["bn_momentum"])
    model.load_state_dict(sd0, strict=True)
    tx = make_optimizer(p["init_lr"], p["weight_decay"], p["epoch_steps"], p["lr_decay_epoch"])
    state = create_train_state(model, tx, seed=d_seed)
    step_fn = make_train_step(model, tx, wire=p["wire"])
    params = dict(model.named_parameters())

    batches: List[tuple] = []
    prog: Dict[str, object] = {"loss": []}
    half = ctx.mode == "fault:half_batch"

    def checked_step(state, *arrays):
        i = state.step
        if i < CHECKED_STEPS:
            batches.append(tuple(a.cpu() for a in arrays))
        if half and i < CHECKED_STEPS:  # the fault: half the batch, the mean over the rest
            arrays = tuple(a[: a.shape[0] // 2] for a in arrays)
        state, losses = step_fn(state, *arrays)
        if i < CHECKED_STEPS:
            prog["loss"].append(float(losses["loss"]))
        if i == 0:
            # a leaf the optimizer never stepped has no moment: its gradient reads 0
            prog["grad"] = _leaf_norms(torch, {
                k: state.optimizer.state.get(t, {}).get("exp_avg", torch.zeros_like(t)) / 0.1
                for k, t in params.items()})
        if i == CHECKED_STEPS - 1:
            cur = state.model.state_dict()
            prog["change"] = _leaf_norms(torch, {k: cur[k].double() - sd0[k].double()
                                                 for k in sd0 if k.split(".")[-1]
                                                 != "num_batches_tracked"})
        return state, losses

    if ctx.mode == "control":
        # the reference in TF32 takes the program's place; the loader still feeds it
        it = loader.epoch(0)
        for _ in range(CHECKED_STEPS):
            b = next(it)
            batches.append(tuple(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in b.arrays + (b.labels,)))
        it.close()
        del model, state, step_fn, params
        rp = _reference(torch, ctx, layout, batches, w_seed, d_seed, tf32=True)
        prog.update(loss=rp["loss"], grad=rp["grad"], change=rp["change"])
        setup_s, steps, window_s, waits, peak, summary = now() - ctx.t_start, 0, 0.0, [], 0, None
    else:
        TrainLoop(checked_step, loader, epochs=1, max_steps_per_epoch=p["setup_steps"],
                  print_freq=10**9).run(state)
        tracer = Tracer(torch, dev, ctx.trace)
        window = WindowLoader(loader, epoch=1)
        timed = TimedLoader(window, tracer)
        count = [0]

        def counted_step(state, *arrays):
            count[0] += 1
            with tracer.span("portbench.train_step"):
                return step_fn(state, *arrays)

        seconds = ctx.seconds if not ctx.trace else min(ctx.seconds, p["trace_seconds"])
        with tracer.window() as t0:
            setup_s = t0 - ctx.t_start
            window.deadline = t0 + seconds
            TrainLoop(counted_step, timed, epochs=2, start_epoch=1,
                      print_freq=p["print_freq"]).run(state)
            _sync(torch, dev)
            window_s = now() - t0
        window.close()
        steps, waits = count[0], timed.waits[1]
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        summary = tracer.summary
        del model, state, step_fn, params, loader, window, timed
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    clips = steps * 3 * p["triplets"]
    rp = _reference(torch, ctx, layout, batches, w_seed, d_seed, tf32=False)
    checks = _compare(prog, rp)
    store_y, store_uv, doc = data.store_planes(root)
    records = data.train_records(p["nclass"], p["store_frames"], p["fps"])
    bad = sum(ref_loader.batch_mismatches(b[0].numpy(), b[1].numpy(), b[2].numpy(), store_y,
                                          store_uv, doc, records, p["fps"]) for b in batches)
    checks.append(Check("loader_mismatch", float(bad), 0.0))
    readings = {c.name: c.value for c in checks}
    # a number is compared where the cell's file gives it a limit; the others
    # are printed to the log only (PERF.md: why)
    for c in checks:
        if c.name not in ctx.workload["limits"]:
            log(f"not compared: {c.name} = {c.value!r}")
    checks = [c for c in checks if c.name in ctx.workload["limits"]]
    for c in checks:
        c.limit = float(ctx.workload["limits"][c.name])
    out = Outcome(setup_s=setup_s, metrics={}, attempted=steps, failed=0, checks=checks,
                  memory_peak_bytes=int(peak), window_s=window_s, trace=summary)
    if window_s > 0:
        out.metrics["train_clips_per_s"] = clips / window_s
    out.counters = {"clips": clips, "steps": steps, "loader_wait_s": float(sum(waits)),
                    "train_flops": clips * train_flops_per_clip(p["frames"], p["crop"],
                                                                3 * p["triplets"], p["nclass"]),
                    "readings": readings}
    return out


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reference(torch, ctx, layout, batches, w_seed, d_seed, tf32: bool) -> dict:
    """The reference's three steps from the seeded weights on the captured
    batches, float32 (``tf32``: in TF32, the control)."""
    dev = ctx.device
    sd0 = make_state(layout, w_seed, dev)
    tr = ref_arv.VATrainer(sd0, layout, _hp(ctx.params), d_seed, tf32=tf32)
    out = {"loss": []}
    for i, (y, uv, labels) in enumerate(batches):
        out["loss"].append(tr.step(y.to(dev), uv.to(dev), labels.to(dev)))
        if i == 0:
            out["grad"] = _leaf_norms(torch, {k: tr.optimizer_grad(k) for k in tr.params})
            out["raw_grad"] = _leaf_norms(torch, dict(zip(tr.params, tr.raw_grads)))
    out["change"] = _leaf_norms(torch, {k: tr.P[k].detach().double() - sd0[k].double()
                                        for k in sd0 if k.split(".")[-1]
                                        != "num_batches_tracked"})
    return out


def _compare(prog: dict, ref: dict) -> List[Check]:
    # the first step's loss: the later steps' losses part by round-off that
    # Adam's normalised step turns into whole steps on near-zero gradients
    # (PERF.md gives both readings)
    loss_gap = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    med = statistics.median(ref["raw_grad"].values())
    # leaves the loss does not reach, or reaches with a gradient that is
    # nought to rounding (a bias under softmax or before a BatchNorm), move
    # under Adam by weight decay and round-off alone: a rule on the
    # reference's first gradient leaves them out
    moved = [k for k in ref["raw_grad"] if ref["raw_grad"][k] >= 1e-3 * med]
    grad_gap, grad_leaf = _worst_leaf(prog["grad"], ref["grad"], moved)
    # the parameters' change after three steps by the median leaf: the
    # non-local block's leaves take their gradient through a BatchNorm over
    # 30 near-identical attention rows, which turns round-off into whole
    # Adam steps on some seeds (PERF.md: the look, the cause, both readings)
    gaps = _leaf_gaps(prog["change"], ref["change"], moved)
    change_gap = statistics.median(gaps.values())
    worst = max(gaps, key=gaps.get)
    # the BN statistics' and the visual memory's change, by the worst leaf
    buffers = [k for k in ref["change"] if k not in ref["raw_grad"]]
    state_gap, state_leaf = _worst_leaf(prog["change"], ref["change"], buffers)
    left_out = sorted(set(ref["raw_grad"]) - set(moved))
    log(f"losses {prog['loss']} vs {ref['loss']}; worst grad leaf {grad_leaf}; change: worst "
        f"leaf {worst} {gaps[worst]!r}, median leaf {change_gap!r}; state: worst leaf "
        f"{state_leaf}; left out: {left_out}")
    return [Check("loss_gap", loss_gap, 0.0), Check("grad_gap", grad_gap, 0.0),
            Check("change_gap", change_gap, 0.0), Check("state_gap", state_gap, 0.0)]
