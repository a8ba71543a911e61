"""Port's checkpoints, resume, run directory and summaries on the CPU:
``CheckpointManager`` (a directory a name, one ``torch.save`` file, a save
moved into place whole), the ``last`` payload and ``restore_train_state``,
``best`` only on a strictly better ap, an exact resume through the loop
(atol 0), ``RunDir`` against the JAX package's, and ``model_summary``'s
total against the JAX ``model_summary`` of the same model."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from tests.test_torch_loop import (
    StubLoader,
    assert_states_equal,
    port_loader,
    port_stub_state,
    small_state,
    stub_fns,
)
from vqwild_tpu_torch.core import config as tconfig
from vqwild_tpu_torch.core.logging import RunDir, get_logger
from vqwild_tpu_torch.core.summaries import model_summary, optimizer_summary
from vqwild_tpu_torch.models.arv import ARVModel
from vqwild_tpu_torch.train.checkpoint import (
    STATE_FILE,
    CheckpointManager,
    last_payload,
    restore_train_state,
)
from vqwild_tpu_torch.train.loop import TrainLoop
from vqwild_tpu_torch.train.step import make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port here: the suite's parallel workers
    share the CPU, and torch's default of a thread per core oversubscribes
    it (as in tests/test_torch_lifecycle.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stepped_state(tiny_arv, steps=3, accum_grad=2):
    """A state after ``steps`` va steps; with accum_grad 2 and an odd count
    a gradient mean is pending."""
    state = small_state(tiny_arv["nclass"], accum_grad=accum_grad)
    step = make_train_step(state.model, state.tx)
    for b in port_loader(tiny_arv, steps=steps).epoch(0):
        state, _ = step(state, *b.arrays, b.labels)
    return state


class TestCheckpointManager:
    def test_last_roundtrip(self, tiny_arv, tmp_path):
        state = stepped_state(tiny_arv)
        assert state.grad_acc is not None and state.step == 3
        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        assert not ckpt.exists("last")
        ckpt.save("last", last_payload(state, 4))
        assert ckpt.exists("last")
        payload = ckpt.restore("last")
        assert payload["epoch"] == 4 and payload["step"] == 3
        fresh = small_state(tiny_arv["nclass"], seed=9, accum_grad=2)
        fresh.generator.manual_seed(123)
        assert restore_train_state(fresh, payload) == 5
        assert_states_equal(fresh, state)
        assert fresh.optimizer.state_dict()["state"][0]["exp_avg"].abs().max() > 0

    def test_layout_and_atomic_replace(self, tmp_path):
        root = tmp_path / "ckpt"
        ckpt = CheckpointManager(str(root))
        ckpt.save("best", {"epoch": 0, "score": 0.1})
        assert sorted(os.listdir(root)) == ["best"]
        assert os.listdir(root / "best") == [STATE_FILE]
        # a save killed before its move leaves its temporary sibling: the
        # checkpoint in place is still read whole, and the next save
        # replaces both
        (root / "best.tmp").mkdir()
        (root / "best.tmp" / STATE_FILE).write_bytes(b"half a file")
        assert ckpt.restore("best") == {"epoch": 0, "score": 0.1}
        ckpt.save("best", {"epoch": 1, "score": 0.2})
        assert ckpt.restore("best") == {"epoch": 1, "score": 0.2}
        assert sorted(os.listdir(root)) == ["best"]
        # a first save killed before its move leaves no checkpoint
        (root / "last.tmp").mkdir()
        assert not ckpt.exists("last")
        ckpt.save("last", {"epoch": 2})
        assert ckpt.exists("last") and sorted(os.listdir(root)) == ["best", "last"]
        # the payload is read with weights_only: no pickled objects
        torch.save({"f": os.getcwd, "epoch": 3}, root / "best" / STATE_FILE)
        with pytest.raises(Exception, match="weights_only"):
            ckpt.restore("best")

    def test_cross_device_generator_is_refused(self, tiny_arv):
        state = small_state(tiny_arv["nclass"])
        payload = last_payload(state, 0)
        payload["generator_device"] = "cuda"
        with pytest.raises(ValueError, match="cannot be resumed across devices"):
            restore_train_state(small_state(tiny_arv["nclass"]), payload)

    def test_best_only_on_a_better_ap(self, tmp_path):
        class Recording(CheckpointManager):
            def __init__(self, directory):
                super().__init__(directory)
                self.saves = []

            def save(self, name, payload):
                self.saves.append((name, payload["epoch"]))
                super().save(name, payload)

        aps = [0.3, 0.3, 0.5, 0.2, 0.5, 0.6]
        ckpt = Recording(str(tmp_path / "ckpt"))
        result = TrainLoop(stub_fns([])[0], StubLoader(2), epochs=6,
                           eval_fn=lambda st, e: {"ap": aps[e]}, eval_per_epoch=1,
                           ckpt=ckpt).run(port_stub_state())
        assert [e for name, e in ckpt.saves if name == "best"] == [0, 2, 5]
        assert [e for name, e in ckpt.saves if name == "last"] == list(range(6))
        # ``last`` of an epoch goes to disk before that epoch's eval
        assert ckpt.saves[:3] == [("last", 0), ("best", 0), ("last", 1)]
        assert (result.best_score, result.best_epoch) == (0.6, 5)
        best = ckpt.restore("best")
        assert (best["epoch"], best["score"]) == (5, 0.6) and "model" in best


class TestResume:
    @pytest.mark.parametrize("accum_grad", [1, 2])
    def test_resume_is_exact(self, tiny_arv, tmp_path, accum_grad):
        """Two epochs straight, against one epoch, ``last`` saved, a freshly
        built state, restore_train_state and the second epoch: the same
        parameters, BN statistics, memory, optimizer moments, step and
        pending gradient mean, bit for bit (the loader reseeds each epoch;
        the dropout generator is restored). Three steps an epoch put the
        lr boundary and, with accum_grad 2, a pending mean at the epoch's
        end."""
        nclass = tiny_arv["nclass"]

        def loop(state, ckpt, epochs, start_epoch=0):
            return TrainLoop(make_train_step(state.model, state.tx), port_loader(tiny_arv),
                             epochs=epochs, ckpt=ckpt, print_freq=2,
                             start_epoch=start_epoch).run(state)

        straight = small_state(nclass, accum_grad=accum_grad)
        whole = loop(straight, None, 2)
        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        loop(small_state(nclass, accum_grad=accum_grad), ckpt, 1)
        resumed = small_state(nclass, seed=4, accum_grad=accum_grad)
        payload = ckpt.restore("last")
        assert (payload["grad_acc"] is not None) == (accum_grad == 2)
        start = restore_train_state(resumed, payload)
        assert start == 1
        second = loop(resumed, ckpt, 2, start_epoch=start)
        assert [h["epoch"] for h in second.history] == [1]
        assert second.history[0]["losses"] == whole.history[1]["losses"]
        assert_states_equal(resumed, straight)
        assert ckpt.restore("last")["step"] == 6


class TestRunDir:
    def test_layout_and_backup_against_jax(self, tmp_path):
        from vqwild_tpu.core import config as jconfig
        from vqwild_tpu.core.logging import RunDir as JaxRunDir
        from vqwild_tpu.core.logging import get_logger as jax_get_logger

        metrics = {"ap": np.float32(0.25), "r": np.arange(3), "n": 2}

        def tree(root):
            return sorted(os.path.relpath(os.path.join(d, f), root)
                          for d, dirs, files in os.walk(root) for f in files + dirs)

        runs = {}
        for name, mod, run_dir, logger in (
                ("port", tconfig, RunDir, get_logger), ("jax", jconfig, JaxRunDir,
                                                        jax_get_logger)):
            cfg = mod.ExperimentConfig(model=mod.ModelConfig(method="va"))
            root = tmp_path / name
            for i in range(2):
                rd = run_dir.create(cfg, root=str(root))
                logger("test").warning("run %d of %s", i, name)
                out = rd.write_metrics("eval", metrics)
                rd.close()
            logger("test").warning("after close")
            path = root / cfg.run_name()
            assert rd.checkpoint_dir() == str(path / "checkpoints")
            assert rd.cache_path("x.npz") == str(path / "cache" / "x.npz")
            names = tree(path)
            backups = [n for n in names if n.startswith("log.log.")]
            assert len(backups) == 1
            runs[name] = dict(
                tree=[n for n in names if n not in backups],
                config=json.loads((path / "config.json").read_text()),
                metrics=json.loads(open(out).read()),
                log=(path / "log.log").read_text().splitlines(),
                backup=(path / backups[0]).read_text().splitlines())
        port, jax = runs["port"], runs["jax"]
        # the port's own field, which the JAX config has not
        assert port["config"]["model"].pop("trunk") == "resnet18_f2f"
        assert port["tree"] == jax["tree"] == [
            "cache", "checkpoints", "config.json", "log.log", "metrics", "metrics/eval.json"]
        assert port["config"] == jax["config"] and port["config"]["model"]["method"] == "va"
        assert port["metrics"] == jax["metrics"] == {"ap": 0.25, "r": [0, 1, 2], "n": 2}
        for r, name in ((port, "port"), (jax, "jax")):
            assert r["backup"][-1].endswith(f"run 0 of {name}")
            assert r["log"][-1].endswith(f"run 1 of {name}")
            assert not any("after close" in ln for ln in r["log"])


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


class TestSummaries:
    @pytest.mark.parametrize("method", ["baseline", "va", "vasa"])
    def test_model_summary_total_equals_jax(self, method):
        from tests import test_torch_heads as th
        from vqwild_tpu.core.summaries import model_summary as jax_model_summary

        variables = th.random_arv_variables(method)
        want = jax_model_summary(variables["params"], {
            k: v for k, v in variables.items() if k != "params"})
        model = ARVModel(method, nclass=th.NCLASS, semantic_dim=th.SEM_DIM)
        lines = _Lines()
        logging.getLogger("vqwild_tpu_torch.summaries").addHandler(lines)
        try:
            got = model_summary(model)
            optimizer_summary(1e-4, 1e-5, 9, 2)
        finally:
            logging.getLogger("vqwild_tpu_torch.summaries").removeHandler(lines)
        assert got == want == sum(p.numel() for p in model.parameters())
        assert lines.lines[0].split() == ["parameter", "shape", "count"]
        assert f"total parameters: {got / 1e6:.3f}M ({got})" in lines.lines
        assert len(lines.lines) == len(list(model.parameters())) + 4
        assert lines.lines[-1] == ("optimizer: Adam lr=0.0001 (x0.1 @ epoch 9) "
                                   "weight_decay=1e-05 accum_grad=2")
