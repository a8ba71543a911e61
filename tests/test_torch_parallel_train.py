"""Data-parallel training in the port on the CPU with gloo: the train step,
the sharded triplet loader, ``TrainLoop(mesh=)`` and rank-0 checkpoints,
against the JAX package on a 2- and 4-device mesh and against the port's
own single process.

The port's ranks run in spawned processes that import no JAX
(tests/test_torch_parallel.spawn); their inputs and JAX's per-step states go
to them in an ``.npz`` file. Each step of a rank starts from the JAX run's
state after the step before (as tests/test_torch_train_step.py does: two
fp32 programs agree to rounding from one state and drift apart when they
run free), and is held to that file's tolerances: losses 2e-4 a part, 5e-4
in all, plus 5e-5 of the value; every parameter within an Adam step's
2·lr and within 1e-5 on all but 0.2% of the resolved elements (vasa: 0.5%,
VASA_MAX_OFF); BN running means 1e-5, variances rtol 5e-3; the memory
5e-6. After every step all ranks hold the same parameters, statistics and
memory, bit for bit.

Why vasa's share is wider: at 30 rows the word adaptor's small gradients
flip sign more often between the two packages whatever the ranks. The
port's one process, each step from the JAX mesh step's state, leaves 0.06%
(step 1) and 0.23% (step 2) of vasa's resolved elements beyond 1e-5 of
JAX's on this case; baseline and va 0.0003-0.009%.

A W-rank step with dropout on draws the masks one process draws for the
same batch (the global batch's masks, each rank keeping its rows): each
step from the one-process run's state after the step before, its losses
agree with the one-process run's to 1e-5 (the reductions run in another
order), and its states to the step tolerances above.
"""

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import child_mesh, load_ranks, save_rank, spawn
from tests.test_torch_train_step import (
    ADAM,
    assert_losses_close,
    assert_steps_close,
    batches,
    port_run,
    wire_arrays,
)
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
from vqwild_tpu_torch.models.arv import ARVModel, init_model
from vqwild_tpu_torch.parallel.mesh import pad_to_multiple
from vqwild_tpu_torch.train.checkpoint import CheckpointManager, last_payload, restore_train_state
from vqwild_tpu_torch.train.loop import TrainLoop
from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

N_STEPS = 2
NCLASS, SEM_DIM = 20, 16
VASA_MAX_OFF = 5e-3
DROPOUT_LOSS_TOL = 1e-5
FRAMES, CROP, H, W = 2, 32, 40, 48  # the loop tests' tiny clips (tests/test_torch_loop.py)
# (name, method, world, rows, ranking_weight): 30 rows split evenly over 2
# ranks; over 4 they pad to 32, the last two weigh 0, and the ranking
# loss's triplets straddle ranks. Each method once: a JAX mesh step
# compiles in ~20 s on the CPU.
JAX_CASES = [("baseline_w2", "baseline", 2, 30, 0.0), ("vasa_w2", "vasa", 2, 30, 0.0),
             ("va_w4_padded", "va", 4, 30, 0.5)]


def digest(model) -> str:
    h = hashlib.sha1()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_block(mesh, arrays):
    """This rank's rows of the arrays padded to the world size, and the
    rows' 0/1 weights (None: nothing padded) — TrainLoop._put's rule."""
    n = len(arrays[-1])
    padded = [pad_to_multiple(np.asarray(a), mesh.size)[0] for a in arrays]
    rows = mesh.rows(len(padded[0]))
    weights = None
    if len(padded[0]) > n:
        weights = torch.from_numpy((np.arange(rows.start, rows.stop) < n).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(p[rows])) for p in padded], weights



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port in the pytest process, as its ranks
    have: the suite's parallel workers share the CPU
    (tests/test_torch_lifecycle.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the children ----

def child_steps(in_path, out_dir):
    """Each case of the input file: N_STEPS steps of the port over this
    rank's rows under the mesh, each after the first from the given state;
    rank 0 keeps the states and the summed gradients the optimizer saw,
    every rank the losses and a digest of its state."""
    mesh = child_mesh()
    d = np.load(in_path)
    cases = json.loads(str(d["cases"]))
    out = {}
    for c in cases:
        name, method = c["name"], c["method"]
        model = ARVModel(method, nclass=NCLASS, semantic_dim=SEM_DIM, dropout=c["dropout"],
                         nl_dropout=c["dropout"] * 0.4)
        keys = [k[len(name) + 4:] for k in d.files if k.startswith(f"{name}/sd/")]
        model.load_state_dict({k: torch.from_numpy(d[f"{name}/sd/{k}"]) for k in keys})
        tx = make_optimizer(**ADAM)
        state = create_train_state(model, tx, seed=1)
        seen = []
        state.optimizer.register_step_pre_hook(lambda opt, a, k: seen.append(
            [p.grad.clone() for g in opt.param_groups for p in g["params"]]))
        sem = d[f"{name}/sem"] if method == "vasa" else None
        step = make_train_step(model, tx, semantic_memory=sem, mesh=mesh,
                               ranking_weight=c["ranking_weight"], triplet_margin=1.0)
        for k in range(c["steps"]):
            if c["resync"] and k > 0:
                model.load_state_dict({kk: torch.from_numpy(d[f"{name}/resync{k - 1}/{kk}"])
                                       for kk in keys})
            arrays, weights = rank_block(mesh, [d[f"{name}/clips{k}"], d[f"{name}/labels{k}"]])
            state, losses = step(state, *arrays, weights=weights)
            for lk, v in losses.items():
                out[f"{name}/loss{k}/{lk}"] = float(v)
            out[f"{name}/digest{k}"] = digest(model)
            if mesh.rank == 0:
                for kk, v in model.state_dict().items():
                    out[f"{name}/state{k}/{kk}"] = v.detach().clone()
                for i, g in enumerate(seen[-1]):
                    out[f"{name}/grad{k}/{i}"] = g
    save_rank(out_dir, mesh.rank, **out)


def _tiny_loader(spec_path, seed, shard, steps=1, wire="yuv420"):
    spec = get_split(spec_path)
    ds = TripletDataset(load_trimmed_db(spec.db_json), spec, SyntheticFrameStore(h=H, w=W),
                        novel_num=5, train_frames=FRAMES, crop_size=CROP,
                        nclass=len(spec.train_labels) + len(spec.val_labels)
                        + len(spec.test_labels), wire=wire)
    return PrefetchLoader(ds, batch_size=2, steps_per_epoch=steps, workers=1, seed=seed,
                          shard=shard)


def child_loop(in_path, out_dir):
    """``TrainLoop(mesh=)`` over the sharded loader from the given va
    weights: one epoch of one step; then a run of 2 epochs of 2 steps with
    rank-0 checkpoints, and the same run stopped after epoch 0 and resumed
    from ``last`` on every rank."""
    mesh = child_mesh()
    d = np.load(in_path)
    spec_path, ckpt_dir = str(d["spec"]), str(d["ckpt_dir"])
    nclass = int(d["nclass"])
    sd = {k[3:]: torch.from_numpy(d[k]) for k in d.files if k.startswith("sd/")}
    model = ARVModel("va", nclass=nclass, semantic_dim=SEM_DIM, dropout=0.0, nl_dropout=0.0)
    model.load_state_dict(sd)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=1, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    res = TrainLoop(make_train_step(model, tx, wire="yuv420", mesh=mesh),
                    _tiny_loader(spec_path, 5, (mesh.rank, mesh.size)), epochs=1,
                    mesh=mesh).run(state)
    out = {f"loop/{k}": v for k, v in res.history[0]["losses"].items()}
    out["loop/steps"] = res.history[0]["steps"]
    if mesh.rank == 0:
        out.update({f"loop/state/{k}": v for k, v in model.state_dict().items()})
    out["loop/digest"] = digest(model)

    def fresh():
        m = init_model(ARVModel("va", nclass=nclass, semantic_dim=SEM_DIM, dropout=0.5,
                                nl_dropout=0.2), seed=3)
        t = make_optimizer(init_lr=1e-3, weight_decay=1e-5, steps_per_epoch=2, lr_decay_epoch=1)
        return create_train_state(m, t, seed=4)

    def run(st, epochs, start, ckpt):
        return TrainLoop(make_train_step(st.model, st.tx, wire="yuv420", mesh=mesh),
                         _tiny_loader(spec_path, 9, (mesh.rank, mesh.size), steps=2),
                         epochs=epochs, start_epoch=start, ckpt=ckpt, mesh=mesh).run(st)

    whole = fresh()
    run(whole, 2, 0, None)
    first = fresh()
    run(first, 1, 0, CheckpointManager(ckpt_dir, mesh=mesh))
    resumed = fresh()
    start = restore_train_state(resumed, CheckpointManager(ckpt_dir, mesh=mesh).restore(
        "last", map_location="cpu"))
    run(resumed, 2, start, None)
    out.update({"resume/start": start, "resume/whole": digest(whole.model),
                "resume/resumed": digest(resumed.model),
                "resume/optim_equal": all(
                    torch.equal(a, b) for sa, sb in zip(
                        whole.optimizer.state_dict()["state"].values(),
                        resumed.optimizer.state_dict()["state"].values())
                    for a, b in zip(sa.values(), sb.values())),
                "resume/payload_keys": ",".join(sorted(last_payload(first, 0)))})
    save_rank(out_dir, mesh.rank, **out)


# ---- the JAX side ----

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from tests import test_torch_heads as th
    from vqwild_tpu.parallel import mesh as jmesh
    from vqwild_tpu.train import step as jstep

    return SimpleNamespace(jax=jax, jnp=jnp, th=th, mesh=jmesh, step=jstep)


def run_jax_mesh(jx, method, variables, data, world, ranking_weight):
    """JAX's step over ``data`` on a ``world``-device mesh, the batch padded
    and weighted as vqwild_tpu/train/loop.py's _put does: per-step losses
    and state_dicts."""
    from vqwild_tpu_torch.models.convert import arv_state_dict_from_jax

    jnp = jx.jnp
    mesh = jx.mesh.make_mesh(devices=jx.jax.devices()[:world])
    model = jx.th.jax_model(method)
    tx = jx.step.make_optimizer(**ADAM)
    state = jx.step.create_train_state(
        model, variables["params"],
        {"batch_stats": variables["batch_stats"], "memory": variables.get("memory", {})}, tx,
        jx.jax.random.PRNGKey(1))
    sem = jx.th.semantic_memory() if method == "vasa" else None
    step = jx.step.make_train_step(model, tx, semantic_memory=sem, donate=False,
                                   ranking_weight=ranking_weight, triplet_margin=1.0)
    losses, states = [], []
    for clips, labels in data:
        arrays = (clips, labels.astype(np.int32))
        n = len(labels)
        weights = np.ones(n, np.float32)
        if n % world:
            arrays = tuple(jx.mesh.pad_to_multiple(a, world)[0] for a in arrays)
            weights = (np.arange(len(arrays[0])) < n).astype(np.float32)
        *sharded, w = jx.mesh.shard_batch_arrays(mesh, *arrays, weights)
        state, ls = step(state, *sharded, weights=w)
        losses.append({k: float(v) for k, v in ls.items()})
        tree = {"params": state.params, "batch_stats": state.batch_stats, "memory": state.memory}
        states.append(arv_state_dict_from_jax(jx.jax.tree_util.tree_map(np.asarray, tree),
                                              method))
    return losses, states


def _flat(prefix, sd):
    return {f"{prefix}/{k}": v.numpy() for k, v in sd.items()}


def _unflat(res, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(np.asarray(v)) for k, v in res.items()
            if k.startswith(prefix + "/")}


def _port_states(res, name, model):
    """A run in tests/test_torch_train_step.py's form from rank 0's file."""
    names = [n for n, _ in model.named_parameters()]
    states, grads, losses = [], [], []
    for k in range(N_STEPS):
        states.append(_unflat(res, f"{name}/state{k}"))
        grads.append([torch.from_numpy(res[f"{name}/grad{k}/{i}"]) for i in range(len(names))])
        keys = [key.rsplit("/", 1)[1] for key in res if key.startswith(f"{name}/loss{k}/")]
        losses.append({lk: float(res[f"{name}/loss{k}/{lk}"]) for lk in keys})
    return SimpleNamespace(states=states, grads=grads, losses=losses, model=model)


def _run_children(tmp, world, inputs):
    np.savez(tmp / "in.npz", **inputs)
    spawn(world, "tests.test_torch_parallel_train:child_steps", tmp / "in.npz", tmp,
          log_dir=tmp)
    return load_ranks(tmp, world)


@pytest.fixture(scope="module", params=[2, 4])
def step_runs(request, jx, tmp_path_factory):
    """Per world size: every JAX case of that size (JAX's losses and
    states, the port's), and a dropout case against the port's own one
    process."""
    from vqwild_tpu_torch.models.convert import arv_state_dict_from_jax

    world = request.param
    tmp = tmp_path_factory.mktemp(f"steps{world}")
    cases, inputs, want = [], {}, {}
    for name, method, w, rows, rw in JAX_CASES:
        if w != world:
            continue
        v = jx.th.random_arv_variables(method, seed=50 + len(cases))
        data = batches(n=N_STEPS, seed=60 + len(cases), b=rows, nclass=NCLASS)
        wl, ws = run_jax_mesh(jx, method, v, data, world, rw)
        want[name] = (method, wl, ws)
        cases.append(dict(name=name, method=method, ranking_weight=rw, dropout=0.0, resync=True,
                          steps=N_STEPS))
        inputs.update(_flat(f"{name}/sd", arv_state_dict_from_jax(v, method)))
        for k, (clips, labels) in enumerate(data):
            inputs[f"{name}/clips{k}"], inputs[f"{name}/labels{k}"] = clips, labels
        for k, s in enumerate(ws[:-1]):
            inputs.update(_flat(f"{name}/resync{k}", s))
        if method == "vasa":
            inputs[f"{name}/sem"] = jx.th.semantic_memory()
    # dropout on: the W-rank port against the one-process port, 24 rows
    sd = init_model(ARVModel("va", nclass=NCLASS, semantic_dim=SEM_DIM), seed=8).state_dict()
    data = batches(n=N_STEPS, seed=70, b=24, nclass=NCLASS)
    one = port_run("va", sd, data, ADAM, seed=1, dropout=0.5, nl_dropout=0.2)
    cases.append(dict(name="dropout", method="va", ranking_weight=0.0, dropout=0.5,
                      resync=True, steps=N_STEPS))
    inputs.update(_flat("dropout/sd", sd))
    for k, st in enumerate(one.states[:-1]):
        inputs.update(_flat(f"dropout/resync{k}", st))
    for k, (clips, labels) in enumerate(data):
        inputs[f"dropout/clips{k}"], inputs[f"dropout/labels{k}"] = clips, labels
    inputs["cases"] = np.array(json.dumps(cases))
    res = _run_children(tmp, world, inputs)
    return SimpleNamespace(world=world, want=want, one=one, res=res)


class TestStepAgainstJaxMesh:
    def test_steps(self, step_runs):
        """Every case of the world size: losses, parameters, BN statistics
        and memory after each step against JAX's step on the mesh."""
        res0 = step_runs.res[0]
        for name, (method, want_losses, want_states) in step_runs.want.items():
            run = _port_states(res0, name, ARVModel(method, nclass=NCLASS,
                                                    semantic_dim=SEM_DIM))
            if name.endswith("padded"):
                assert all("ranking_loss" in ls for ls in run.losses)
            assert_losses_close(run.losses, want_losses)
            assert_steps_close(run, want_states, lr_bound=2 * ADAM["init_lr"],
                               **({"max_off": VASA_MAX_OFF} if method == "vasa" else {}))

    def test_ranks_hold_the_same_state(self, step_runs):
        for r in step_runs.res[1:]:
            for k, v in step_runs.res[0].items():
                if "/digest" in k or "/loss" in k:
                    assert r[k] == v, k


class TestTopologyInvariance:
    def test_dropout_steps_equal_one_process(self, step_runs):
        """Dropout p 0.5 and 0.2 on 24 rows: the W-rank run against the
        one-process run from the same weights and generator seed."""
        one = step_runs.one
        run = _port_states(step_runs.res[0], "dropout", one.model)
        assert_losses_close(run.losses, one.losses, rtol=DROPOUT_LOSS_TOL,
                            atol=DROPOUT_LOSS_TOL, total_atol=DROPOUT_LOSS_TOL)
        run.grads = one.grads
        assert_steps_close(run, one.states, lr_bound=2 * ADAM["init_lr"])


class TestShardedLoader:
    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    @pytest.mark.parametrize("world,batch_size", [(2, 2), (4, 2), (4, 1)])
    def test_shards_are_the_padded_global_batch(self, tiny_arv, tmp_path, wire, world,
                                                batch_size):
        """Each rank's batch from a generator seeded alike, concatenated in
        rank order, equals the whole batch padded to the world size, bit
        for bit (4 ranks over 3 rows: the last rank holds only padding)."""
        from tests.test_torch_data import write_split_spec

        spec = write_split_spec(tiny_arv, tmp_path / "spec.json")
        ds = _tiny_loader(spec, 0, None, wire=wire).dataset
        whole = ds.build_batch(np.random.default_rng(3), batch_size)
        parts = [ds.build_batch(np.random.default_rng(3), batch_size, shard=(r, world))
                 for r in range(world)]
        n = 3 * batch_size
        assert whole.global_rows is None and all(p.global_rows == n for p in parts)
        for j, a in enumerate(whole.arrays + (whole.labels,)):
            got = np.concatenate([(p.arrays + (p.labels,))[j] for p in parts])
            np.testing.assert_array_equal(got, pad_to_multiple(a, world)[0])

    def test_loader_epochs_are_sharded_alike(self, tiny_arv, tmp_path):
        """Two workers: every rank's loader gives its block of the same
        global batch at every step."""
        from tests.test_torch_data import write_split_spec

        spec = write_split_spec(tiny_arv, tmp_path / "spec.json")

        def epoch(shard):
            loader = _tiny_loader(spec, 11, shard, steps=4)
            loader.workers = 2
            return list(loader.epoch(1))

        whole = epoch(None)
        parts = [epoch((r, 4)) for r in range(4)]
        for k, b in enumerate(whole):
            got = np.concatenate([p[k].y for p in parts])
            np.testing.assert_array_equal(got, pad_to_multiple(b.y, 4)[0])
            np.testing.assert_array_equal(np.concatenate([p[k].labels for p in parts]),
                                          pad_to_multiple(b.labels, 4)[0])

    def test_sharded_batches_ignore_the_host_core_count(self, tiny_arv, tmp_path, monkeypatch):
        """A sharded loader keeps the requested worker count on a host with
        fewer cores, so a rank's batches are the same on hosts of 1 and 8
        cores: ranks on unlike hosts read blocks of one global batch."""
        from tests.test_torch_data import write_split_spec

        ds = _tiny_loader(write_split_spec(tiny_arv, tmp_path / "spec.json"), 0, None).dataset

        def epoch(cores):
            monkeypatch.setattr(os, "cpu_count", lambda: cores)
            loader = PrefetchLoader(ds, batch_size=2, steps_per_epoch=4, workers=2, seed=11,
                                    shard=(1, 2))
            assert loader.workers == 2
            return list(loader.epoch(0))

        for a, b in zip(epoch(1), epoch(8), strict=True):
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.labels, b.labels)


@pytest.fixture(scope="module")
def loop_run(jx, tiny_arv, tmp_path_factory):
    """JAX's TrainLoop on a 4-device mesh (one va step of 6 rows, padded to
    8, yuv420) and the port's on 4 ranks, from the same weights; then the
    port's checkpoint and resume on 2 ranks."""
    from tests.test_torch_data import write_split_spec
    from vqwild_tpu.data import triplets as jtriplets
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxStore
    from vqwild_tpu.data.schema import load_trimmed_db as jax_load_db
    from vqwild_tpu.models import arv as jarv
    from vqwild_tpu.train import loop as jloop
    from vqwild_tpu_torch.models.convert import arv_state_dict_from_jax

    jax, jnp = jx.jax, jx.jnp
    tmp = tmp_path_factory.mktemp("loop")
    nclass = tiny_arv["nclass"]
    jmodel = jarv.ARVModel(method="va", nclass=nclass, semantic_dim=SEM_DIM, dropout=0.0,
                           nl_dropout=0.0)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 1, CROP, CROP, 3)),
        targets=jnp.zeros((1,), jnp.int32), train=True))
    variables = jx.th._seeded_leaves({k: dict(v) for k, v in dict(shapes).items()},
                                     np.random.default_rng(23))
    jtx = jx.step.make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=1,
                                 lr_decay_epoch=9)
    jstate = jx.step.create_train_state(
        jmodel, variables["params"],
        {"batch_stats": variables["batch_stats"], "memory": variables["memory"]}, jtx,
        jax.random.PRNGKey(1))
    jds = jtriplets.TripletDataset(jax_load_db(tiny_arv["db_path"]), tiny_arv["spec"],
                                   JaxStore(h=H, w=W), novel_num=5, train_frames=FRAMES,
                                   crop_size=CROP, nclass=nclass, wire="yuv420")
    jloader = jtriplets.PrefetchLoader(jds, batch_size=2, steps_per_epoch=1, workers=1, seed=5)
    want = jloop.TrainLoop(jx.step.make_train_step(jmodel, jtx, donate=False, wire="yuv420"),
                           jloader, epochs=1,
                           mesh=jx.mesh.make_mesh(devices=jax.devices()[:4])).run(jstate)
    tree = {"params": want.state.params, "batch_stats": want.state.batch_stats,
            "memory": want.state.memory}
    want_sd = arv_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), "va")
    spec = write_split_spec(tiny_arv, tmp / "spec.json")
    inputs = dict(spec=np.array(spec), ckpt_dir=np.array(str(tmp / "ckpt")),
                  nclass=np.int64(nclass),
                  **{f"sd/{k}": v.numpy()
                     for k, v in arv_state_dict_from_jax(variables, "va").items()})
    np.savez(tmp / "in.npz", **inputs)
    spawn(4, "tests.test_torch_parallel_train:child_loop", tmp / "in.npz", tmp, log_dir=tmp)
    return SimpleNamespace(want=want, want_sd=want_sd, res=load_ranks(tmp, 4), tmp=tmp)


class TestLoopUnderMesh:
    def test_one_step_against_the_jax_loop(self, loop_run):
        """The loop's history (the step's losses) to the step tolerances;
        parameters within 2·lr, the memory 5e-6, BN means 1e-5."""
        res, want = loop_run.res[0], loop_run.want
        w = want.history[0]["losses"]
        assert set(w) == {"ce_loss", "reg_loss", "loss"}
        for k in w:
            tol = 5e-4 if k == "loss" else 2e-4
            assert abs(float(res[f"loop/{k}"]) - w[k]) <= tol, (k, res[f"loop/{k}"], w[k])
        assert int(res["loop/steps"]) == want.history[0]["steps"] == 1
        got = _unflat(res, "loop/state")
        for k, v in loop_run.want_sd.items():
            if k.endswith("running_var"):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=5e-3, atol=1e-5,
                                           err_msg=k)
            elif k == "visual_memory":
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=5e-6)
            elif k.endswith("running_mean"):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
            elif got[k].is_floating_point():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-4, err_msg=k)

    def test_ranks_agree(self, loop_run):
        for r in loop_run.res[1:]:
            assert r["loop/digest"] == loop_run.res[0]["loop/digest"]
            assert float(r["loop/loss"]) == float(loop_run.res[0]["loop/loss"])

    def test_rank0_checkpoint_and_resume_on_every_rank(self, loop_run):
        """Rank 0 alone wrote ``last`` (one directory, one file); each rank
        resumed from it at epoch 1 and ends bit-equal to the run that was
        not stopped."""
        ckpt = loop_run.tmp / "ckpt"
        assert sorted(os.listdir(ckpt)) == ["last"]
        assert os.listdir(ckpt / "last") == ["state.pt"]
        for r in loop_run.res:
            assert int(r["resume/start"]) == 1
            assert str(r["resume/whole"]) == str(r["resume/resumed"])
            assert bool(r["resume/optim_equal"])
