"""Port's training loop (vqwild_tpu_torch/train/loop.py) on the CPU.

Against the JAX package's TrainLoop, both driven by one stub loader and one
stub step (no model): the step and scan calls in order, the progress and
epoch log lines (the print cadence and the averages at each print), the
history, the eval epochs, best tracking, the checkpoint names, the
start-epoch skip, the scan path's tail and the halt/warn policies.

The real step: the port's loop over the port's loader leaves the same state
as make_train_step called on the same batches in order (atol 0), on the
per-step and the scan path. Validation through the trimmed evaluator over
make_feat_fn of the state's model, with checkpoints on disk. One step from
the JAX package's weights against the JAX loop's, within the step tests'
tolerance (free-running fp32 trajectories part within 3 Adam steps, so no
further).

The JAX package is imported inside a fixture, so that the ``cuda`` test at
the end (the pinned side-stream upload against a pageable one, the port
alone) runs on a machine that has only the port: ``pytest --noconftest -m
cuda``.
"""

import json
import logging
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.core.meters import AverageMeter
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
from vqwild_tpu_torch.models.arv import ARVModel, init_model
from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor, make_feat_fn
from vqwild_tpu_torch.train.checkpoint import CheckpointManager
from vqwild_tpu_torch.train.loop import NonFiniteLossError, TrainLoop
from vqwild_tpu_torch.train.step import (
    create_train_state,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
)

FRAMES, CROP, H, W = 2, 32, 40, 48
# the step tests' one-step tolerances (tests/test_torch_train_step.py)
LOSS_TOL, TOTAL_LOSS_TOL = 2e-4, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port here: the suite's parallel workers
    share the CPU, and torch's default of a thread per core oversubscribes
    it (as in tests/test_torch_lifecycle.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's loop, step, loader and seeded-variable helpers."""
    import jax

    from tests import test_torch_heads as th
    from vqwild_tpu.data import triplets as jtriplets
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxStore
    from vqwild_tpu.data.schema import load_trimmed_db as jax_load_trimmed_db
    from vqwild_tpu.models import arv as jarv
    from vqwild_tpu.train import loop as jloop
    from vqwild_tpu.train import step as jstep

    return SimpleNamespace(jax=jax, th=th, triplets=jtriplets, Store=JaxStore,
                           load_db=jax_load_trimmed_db, arv=jarv, loop=jloop, step=jstep)


def port_spec(tiny_arv):
    s = tiny_arv["spec"]
    return SplitSpec(s.name, tuple(s.train_labels), tuple(s.val_labels), tuple(s.test_labels),
                     s.db_json, s.moment_db_json)


def port_loader(tiny_arv, steps=3, seed=5, wire="rgb", workers=1):
    ds = TripletDataset(load_trimmed_db(tiny_arv["db_path"]), port_spec(tiny_arv),
                        SyntheticFrameStore(h=H, w=W), novel_num=5, train_frames=FRAMES,
                        crop_size=CROP, nclass=tiny_arv["nclass"], wire=wire)
    return PrefetchLoader(ds, batch_size=2, steps_per_epoch=steps, workers=workers, seed=seed)


def small_state(nclass, seed=0, accum_grad=1, method="va", device="cpu", dropout=0.5):
    """A seeded full-width ARVModel (default dropout: the generator matters)
    and Adam whose lr drops x0.1 after 3 updates."""
    model = init_model(ARVModel(method, nclass=nclass, semantic_dim=16, dropout=dropout,
                                nl_dropout=dropout / 2.5), seed=seed).to(device)
    tx = make_optimizer(init_lr=1e-3, weight_decay=1e-5, steps_per_epoch=3, lr_decay_epoch=1,
                        accum_grad=accum_grad)
    return create_train_state(model, tx, seed=1)


def assert_states_equal(a, b):
    """Two TrainStates: parameters, BN statistics, memory, optimizer
    moments, step and the pending gradient mean, exactly."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert list(oa["state"]) == list(ob["state"])
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step
    assert (a.grad_acc is None) == (b.grad_acc is None)
    for x, y in zip(a.grad_acc or [], b.grad_acc or []):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# against the JAX loop, with a stub step and a stub loader


class StubBatch:
    """A loader batch with the TripletBatch interface: labels tell the
    epoch and the index."""

    def __init__(self, epoch, i):
        self.labels = np.full(3, 100 * epoch + i, np.int32)
        self.arrays = (np.full((3, 1), i, np.uint8),)


class StubLoader:
    def __init__(self, steps):
        self.steps = steps

    def epoch(self, e):
        for i in range(self.steps):
            yield StubBatch(e, i)


def stub_fns(calls, nan_at=None):
    """A step and a scan fn that record their calls and return losses as
    numpy values (exact in either package): call n's loss 1/(n+1), NaN at
    ``nan_at``."""
    count = [0]

    def losses(n):
        return (np.float32("nan") if n == nan_at else np.float32(1.0 / (n + 1)),
                np.float32(0.25 * n))

    def step(state, arrays, labels, weights=None):
        assert weights is None
        calls.append(("step", np.asarray(labels).tolist(), np.asarray(arrays).shape))
        loss, ce = losses(count[0])
        count[0] += 1
        return state, {"loss": loss, "ce_loss": ce}

    def scan(state, arrays, labels, weights=None):
        assert weights is None
        calls.append(("scan", np.asarray(labels).tolist(), np.asarray(arrays).shape))
        out = [losses(count[0] + k) for k in range(len(labels))]
        count[0] += len(labels)
        return state, {"loss": np.array([o[0] for o in out]),
                       "ce_loss": np.array([o[1] for o in out])}

    return step, scan


class RecordingCkpt:
    def __init__(self):
        self.names = []

    def save(self, name, payload):
        self.names.append((name, int(payload["epoch"])))


def port_stub_state():
    model = torch.nn.Linear(1, 1)
    return SimpleNamespace(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                           step=0, grad_acc=None, generator=torch.Generator())


def jax_stub_state():
    return SimpleNamespace(params={}, batch_stats={}, memory={}, opt_state=(), step=0,
                           dropout_rng=None)


class LogLines(logging.Handler):
    """The loop logger's messages, without the data-time field."""

    def __init__(self, name):
        super().__init__(logging.DEBUG)
        self.lines = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        self.lines.append(re.sub(r" dataload=\S+", "", record.getMessage()))

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


APS = [0.3, 0.3, 0.5, 0.2, 0.5, 0.6]


def drive(loop_cls, state, logger, *, steps, nan_at=None, **kw):
    calls, evals = [], []
    step, scan = stub_fns(calls, nan_at)
    ckpt = RecordingCkpt()

    def eval_fn(st, epoch):
        evals.append(epoch)
        return {"ap": APS[epoch]}

    if kw.get("scan_steps", 1) > 1:
        kw["scan_fn"] = scan
    loop = loop_cls(step, StubLoader(steps), eval_fn=eval_fn, ckpt=ckpt, **kw)
    with LogLines(logger) as log:
        try:
            result = loop.run(state)
        except Exception as e:  # compared with the other package's
            result = e
    return SimpleNamespace(calls=calls, evals=evals, saves=ckpt.names, lines=log.lines,
                           result=result)


SCENARIOS = {
    "capped": dict(epochs=5, steps=5, max_steps_per_epoch=4, eval_per_epoch=2, print_freq=2),
    "start_epoch": dict(epochs=4, start_epoch=2, steps=2, eval_per_epoch=1, print_freq=1000),
    "every_step": dict(epochs=3, steps=3, eval_per_epoch=1, print_freq=1),
    "scan_tail": dict(epochs=2, steps=5, scan_steps=2, print_freq=2, eval_per_epoch=1),
    "scan_cadence": dict(epochs=3, steps=7, scan_steps=3, print_freq=4, eval_per_epoch=1),
}


class TestAgainstJaxLoop:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_same_schedule(self, jx, name):
        kw = SCENARIOS[name]
        got = drive(TrainLoop, port_stub_state(), "vqwild_tpu_torch.train.loop", **kw)
        want = drive(jx.loop.TrainLoop, jax_stub_state(), "vqwild_tpu.train.loop", **kw)
        assert got.calls == want.calls and got.calls
        assert got.evals == want.evals and got.saves == want.saves
        assert got.lines == want.lines
        np.testing.assert_equal(got.result.history, want.result.history)
        assert (got.result.best_score, got.result.best_epoch) == (
            want.result.best_score, want.result.best_epoch)
        assert [h["epoch"] for h in got.result.history] == list(
            range(kw.get("start_epoch", 0), kw["epochs"]))
        if name == "scan_tail":  # two groups of 2 and a tail of 1 an epoch
            assert [c[0] for c in got.calls] == ["scan", "scan", "step"] * 2
            assert got.result.history[0]["steps"] == 5

    @pytest.mark.parametrize("scan_steps", [1, 2])
    def test_halt_and_warn(self, jx, scan_steps):
        kw = dict(epochs=2, steps=4, print_freq=2, eval_per_epoch=1, scan_steps=scan_steps)
        got = drive(TrainLoop, port_stub_state(), "vqwild_tpu_torch.train.loop", nan_at=1,
                    **kw)
        want = drive(jx.loop.TrainLoop, jax_stub_state(), "vqwild_tpu.train.loop", nan_at=1,
                     **kw)
        assert isinstance(got.result, NonFiniteLossError)
        assert isinstance(want.result, jx.loop.NonFiniteLossError)
        assert str(got.result) == str(want.result) and "loss=nan" in str(got.result)
        assert got.calls == want.calls and got.saves == want.saves == []
        assert got.lines == want.lines
        got = drive(TrainLoop, port_stub_state(), "vqwild_tpu_torch.train.loop", nan_at=1,
                    nonfinite_policy="warn", **kw)
        want = drive(jx.loop.TrainLoop, jax_stub_state(), "vqwild_tpu.train.loop", nan_at=1,
                     nonfinite_policy="warn", **kw)
        np.testing.assert_equal(got.result.history, want.result.history)
        assert np.isnan(got.result.history[0]["losses"]["loss"])
        assert got.calls == want.calls and got.saves == want.saves and got.lines == want.lines
        with pytest.raises(ValueError, match="nonfinite_policy"):
            TrainLoop(stub_fns([])[0], StubLoader(1), epochs=1, nonfinite_policy="bogus")


# ---------------------------------------------------------------------------
# the real step


def manual_run(state, step, loader, epochs):
    """make_train_step over the loader's batches in order; per epoch the
    losses' means as the loop's meters take them."""
    history = []
    for e in range(epochs):
        meters = {}
        for b in loader.epoch(e):
            state, ls = step(state, *b.arrays, b.labels)
            for k, v in ls.items():
                meters.setdefault(k, AverageMeter()).update(float(v))
        history.append({k: m.avg for k, m in sorted(meters.items())})
    return history


class TestRealStep:
    @pytest.mark.parametrize("scan_steps", [1, 2])
    def test_loop_equals_the_step_sequence(self, tiny_arv, scan_steps):
        nclass = tiny_arv["nclass"]
        a, b = small_state(nclass), small_state(nclass)
        scan = make_scanned_train_step(a.model, a.tx) if scan_steps > 1 else None
        loop = TrainLoop(make_train_step(a.model, a.tx), port_loader(tiny_arv), epochs=2,
                         print_freq=2, scan_fn=scan, scan_steps=scan_steps)
        result = loop.run(a)
        want = manual_run(b, make_train_step(b.model, b.tx), port_loader(tiny_arv), 2)
        assert [h["losses"] for h in result.history] == want
        assert [h["steps"] for h in result.history] == [3, 3] and a.step == 6
        assert all(np.isfinite(v) for h in want for v in h.values())
        assert_states_equal(a, b)

    def test_validation_and_checkpoints(self, tiny_arv, tmp_path):
        """Two epochs with the trimmed evaluator over the state's model on
        the yuv420 wire: ap in [0, 1] each epoch, ``last`` and ``best`` on
        disk, ``best`` the best epoch's."""
        nclass = tiny_arv["nclass"]
        state = small_state(nclass)
        db = load_trimmed_db(tiny_arv["db_path"])
        store = SyntheticFrameStore(h=H, w=W)

        def eval_fn(st, epoch):
            ex = FeatureExtractor(make_feat_fn(st.model, wire="yuv420", device="cpu"), store,
                                  test_frames=FRAMES, test_batch_size=8, input_size=CROP,
                                  wire="yuv420")
            return ARVRetrievalTrimmed(db, port_spec(tiny_arv), ex, eval_split="validation",
                                       device="cpu").evaluation()

        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        loop = TrainLoop(make_train_step(state.model, state.tx, wire="yuv420"),
                         port_loader(tiny_arv, steps=2, wire="yuv420"), epochs=2,
                         eval_fn=eval_fn, eval_per_epoch=1, ckpt=ckpt, print_freq=1)
        result = loop.run(state)
        aps = [h["ap"] for h in result.history]
        assert len(aps) == 2 and all(0.0 <= x <= 1.0 for x in aps)
        assert result.best_score == max(aps) and result.best_epoch == aps.index(max(aps))
        assert ckpt.exists("last") and ckpt.exists("best")
        best = ckpt.restore("best")
        assert (best["epoch"], best["score"]) == (result.best_epoch, result.best_score)
        last = ckpt.restore("last")
        assert last["epoch"] == 1 and last["step"] == 4
        for k, v in state.model.state_dict().items():
            assert torch.equal(last["model"][k], v), k
        json.dumps(result.history)  # plain numbers, as RunDir.write_metrics needs

    def test_feat_fn_takes_the_train_model_and_copies_it(self, tiny_arv):
        """make_feat_fn(folded=True) takes an ARVModel (trunk keys plus
        fc, cls_nl, the memory) and folds its weights when it is built:
        later steps leave an extractor built before them as it was."""
        state = small_state(tiny_arv["nclass"])
        rng = np.random.default_rng(4)
        clips = rng.integers(0, 256, (3, FRAMES, CROP, CROP, 3), dtype=np.uint8)
        before = make_feat_fn(state.model, device="cpu")
        e0 = before(clips)
        step = make_train_step(state.model, state.tx)
        for b in port_loader(tiny_arv, steps=2).epoch(0):
            state, _ = step(state, *b.arrays, b.labels)
        np.testing.assert_array_equal(before(clips), e0)
        after = make_feat_fn(state.model, device="cpu")(clips)
        assert after.shape == e0.shape == (3, 512, FRAMES)
        assert np.abs(after - e0).max() > 1e-4


class TestOneStepAgainstJax:
    def test_first_epoch_loss(self, jx, tiny_arv):
        """An epoch of one va step from the JAX package's weights, over each
        package's loader (the same batch): the history's losses agree to the
        step tests' tolerance."""
        from vqwild_tpu_torch.models.convert import arv_state_dict_from_jax

        nclass = tiny_arv["nclass"]
        jmodel = jx.arv.ARVModel(method="va", nclass=nclass, semantic_dim=16, dropout=0.0,
                                 nl_dropout=0.0)
        key = jx.jax.random.PRNGKey(0)
        jnp = jx.jax.numpy
        shapes = jx.jax.eval_shape(lambda: jmodel.init(
            {"params": key, "dropout": key}, jnp.zeros((1, 1, CROP, CROP, 3)),
            targets=jnp.zeros((1,), jnp.int32), train=True))
        variables = jx.th._seeded_leaves({k: dict(v) for k, v in dict(shapes).items()},
                                         np.random.default_rng(21))
        jtx = jx.step.make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=1,
                                     lr_decay_epoch=9)
        jstate = jx.step.create_train_state(
            jmodel, variables["params"],
            {"batch_stats": variables["batch_stats"], "memory": variables["memory"]}, jtx,
            jx.jax.random.PRNGKey(1))
        jds = jx.triplets.TripletDataset(jx.load_db(tiny_arv["db_path"]), tiny_arv["spec"],
                                         jx.Store(h=H, w=W), novel_num=5, train_frames=FRAMES,
                                         crop_size=CROP, nclass=nclass)
        jloader = jx.triplets.PrefetchLoader(jds, batch_size=2, steps_per_epoch=1, workers=1,
                                             seed=5)
        want = jx.loop.TrainLoop(jx.step.make_train_step(jmodel, jtx, donate=False), jloader,
                                 epochs=1).run(jstate)

        model = ARVModel("va", nclass=nclass, semantic_dim=16, dropout=0.0, nl_dropout=0.0)
        model.load_state_dict(arv_state_dict_from_jax(variables, "va"), strict=True)
        tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=1,
                            lr_decay_epoch=9)
        state = create_train_state(model, tx, seed=1)
        got = TrainLoop(make_train_step(model, tx), port_loader(tiny_arv, steps=1),
                        epochs=1).run(state)
        g, w = got.history[0]["losses"], want.history[0]["losses"]
        assert set(g) == set(w) == {"ce_loss", "reg_loss", "loss"}
        for k in w:
            tol = TOTAL_LOSS_TOL if k == "loss" else LOSS_TOL
            assert abs(g[k] - w[k]) <= tol, (k, g[k], w[k])
        assert got.history[0]["steps"] == want.history[0]["steps"] == 1


# ---------------------------------------------------------------------------
# on the card


def write_db(root, nclass=4, per_class=3):
    """A trimmed DB of ``nclass`` training classes and its SplitSpec, made
    without the JAX package's fixtures."""
    labels = [f"class_{i}" for i in range(nclass)]
    training = {label: [{"video_id": f"v{i}_{j}", "label": label, "segment": [1.0, 11.0],
                         "border": [1.0, 11.0], "activitynet_subset": "training",
                         "activitynet_duration": 64 / 3, "is_query": 0,
                         "retrieval_type": "base"} for j in range(per_class)]
                for i, label in enumerate(labels)}
    path = root / "arv_db_loop.json"
    path.write_text(json.dumps({"training": training, "validation": {}, "testing": {}}))
    spec = SplitSpec("loop", tuple(labels), (), (), str(path), "")
    return load_trimmed_db(str(path)), spec


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_pinned_side_stream_upload_matches_a_pageable_one(self, cuda, tmp_path):
        """Two loop steps on the card from the host loader (pinned memory, a
        side stream) against the same two steps with each batch uploaded
        from pageable memory before its step: the same losses and state,
        bit for bit."""
        db, spec = write_db(tmp_path)
        ds = TripletDataset(db, spec, SyntheticFrameStore(h=H, w=W), train_frames=FRAMES,
                            crop_size=CROP, nclass=4)
        loader = PrefetchLoader(ds, batch_size=2, steps_per_epoch=2, workers=1, seed=3)
        a, b = small_state(4, device=cuda), small_state(4, device=cuda)
        step_losses = []
        step = make_train_step(a.model, a.tx)

        def recording(state, *arrays):
            assert all(t.is_cuda for t in arrays)
            state, ls = step(state, *arrays)
            step_losses.append(ls)
            return state, ls

        TrainLoop(recording, loader, epochs=1, print_freq=1).run(a)
        step_b = make_train_step(b.model, b.tx)
        for batch, got in zip(loader.epoch(0), step_losses):
            arrays = [torch.from_numpy(x).to(cuda) for x in batch.arrays + (batch.labels,)]
            _, want = step_b(b, *arrays)
            for k in want:
                assert torch.equal(got[k], want[k]), k
        assert len(step_losses) == 2
        assert_states_equal(a, b)
