"""Entry kind ``train_vswin``: the port's training loop on the VA model with
the Video Swin trunk, closed loop, for the window.

As ``train`` (drivers/train.py), whose loaders and comparison it takes:
set-up builds one train state (``ARVModel(trunk="swin3d_b")`` from seeded
weights, torch's Adam, the dropout generator, which the trunk's drop path
draws from too), the triplet loader over the packed 4:2:0 store, and
drives ``TrainLoop`` through its first steps: the steps the reference
follows, then warm-up. The same state and loader then train for the
window: ``train_clips_per_s`` is every clip whose step completed in the
window over the window's seconds, the window ending when the device
finishes the last step.

``correct`` compares the first three steps with the plain reference
(reference/swin3d.py, the trunk in blocks of clips) on the same batches
from the same weights and generator seed: the first step's loss, each
leaf's gradient as Adam took it in step 1 by the worst leaf, each leaf's
change after step 3 by the median leaf, the non-local BatchNorm's
statistics' and the memory's change by the worst buffer; and every clip of
those batches against the store it was read from.

A program without the trunk fails before anything is built.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np

from portbench.drivers.train import (
    CHECKED_STEPS,
    TimedLoader,
    WindowLoader,
    _compare,
    _hp,
    _leaf_norms,
    _sync,
)
from portbench.harness import data, traffic
from portbench.harness.common import CACHE_DIR, Check, Ctx, Outcome, log, now
from portbench.harness.peaks import va_heads_train_flops
from portbench.harness.swin_work import train_flops_per_clip
from portbench.harness.trace import Tracer
from portbench.reference import loader as ref_loader
from portbench.reference import swin3d as ref_swin

TRUNK_KEYS = ("embed_dim", "depths", "heads", "window", "patch", "mlp_ratio", "frames", "crop",
              "drop_path", "ln_eps")
SIZES = ("embed_dim", "depths", "heads", "window", "patch", "mlp_ratio")
REF_CHUNK = 1  # clips a block of the reference's trunk


def _layout(p):
    return ref_swin.va_layout(p["nclass"], p["feat_dim"], *(p[k] for k in SIZES))


def _floats(sd) -> List[str]:
    """The keys of the leaves that a step may change (not the index or the
    count buffers)."""
    return [k for k, v in sd.items() if v.is_floating_point()]


def run(ctx: Ctx) -> Outcome:
    from vqwild_tpu_torch.models import swin3d  # noqa: F401  (a program without it fails here)

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
        raise SystemExit("portbench: the train_vswin driver runs float32 with TF32 off")
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
    layout = _layout(p)
    w_seed = traffic.sub_seed(ctx.seed, traffic.ROLE_WEIGHTS)
    d_seed = traffic.sub_seed(ctx.seed, traffic.ROLE_DROPOUT)
    sd0 = ref_swin.make_state(layout, w_seed, p["window"], dev)
    with dev:
        model = ARVModel(method=p["method"], nclass=p["nclass"], feat_dim=p["feat_dim"],
                         dropout=p["dropout"], nl_dropout=p["nl_dropout"],
                         temperature=p["temperature"], moving_average=p["moving_average"],
                         trunk=p["trunk"], trunk_args={k: p[k] for k in TRUNK_KEYS})
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
                                                 for k in _floats(sd0)})
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
    batch = 3 * p["triplets"]
    per_clip = train_flops_per_clip(p["frames"], p["crop"], p["patch"], p["embed_dim"],
                                    p["depths"], p["window"], p["mlp_ratio"])
    out.counters = {"clips": clips, "steps": steps, "loader_wait_s": float(sum(waits)),
                    "train_flops": clips * per_clip + steps * va_heads_train_flops(
                        batch, p["nclass"], dim=p["feat_dim"]),
                    "readings": readings}
    return out


def _reference(torch, ctx, layout, batches, w_seed, d_seed, tf32: bool) -> dict:
    """The reference's three steps from the seeded weights on the captured
    batches, float32 (``tf32``: in TF32, the control)."""
    dev, p = ctx.device, ctx.params
    sd0 = ref_swin.make_state(layout, w_seed, p["window"], dev)
    cfg = {k: p[k] for k in TRUNK_KEYS + ("feat_dim",)}
    tr = ref_swin.SwinTrainer(sd0, layout, _hp(p), cfg, d_seed, tf32=tf32, chunk=REF_CHUNK)
    out = {"loss": []}
    for i, (y, uv, labels) in enumerate(batches):
        out["loss"].append(tr.step(y.to(dev), uv.to(dev), labels.to(dev)))
        if i == 0:
            out["grad"] = _leaf_norms(torch, {k: tr.optimizer_grad(k) for k in tr.params})
            out["raw_grad"] = _leaf_norms(torch, dict(zip(tr.params, tr.raw_grads)))
    out["change"] = _leaf_norms(torch, {k: tr.P[k].detach().double() - sd0[k].double()
                                        for k in _floats(sd0)})
    return out
