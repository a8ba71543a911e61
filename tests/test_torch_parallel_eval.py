"""The sharded trimmed evaluation and the command line under torchrun, on
the CPU with gloo.

- ``GalleryScorer(mesh=)``: 37 gallery rows over 2 and 4 ranks (padded to
  38 and 40), against the JAX package's mesh scorer
  (tests/test_sharded_eval.py:24,36): scores 1e-5, the padding ignored.
- ``ARVRetrievalTrimmed(mesh=)`` on the tiny DB with seeded fake
  features: metrics within 1e-6 of JAX's mesh evaluator and of the port's
  single process.
- ``make_feat_fn(mesh=)``: a 5-clip batch (padded to the world size) on
  both wires against the single process, 1e-5 (the trunk's convolutions
  run on fewer rows a rank, so in another order).
- ``python -m torch.distributed.run --nproc_per_node 2 -m
  vqwild_tpu_torch --device cpu --debug`` trains va on 6 rows a step (3 a
  rank) to the checkpoint one process trains (TORCHRUN_*) and ends in the
  evaluation of all three regimes, takes one step of 42 rows to the one
  process's checkpoint within one step's tolerances (ONE_STEP_*);
  ``--evaluate --eval_all`` of one checkpoint, fp32 and ``--trunk_int8``
  (each run beside a copy of it, so that each calibrates), gives the one
  process's metrics within METRIC_TOL (measured: equal) and, under int8,
  the one process's calibration file, written once; and
  ``--trunk_int8_const`` is refused before anything runs.

The ranks run in spawned processes that import no JAX
(tests/test_torch_parallel.spawn).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import REPO, _ENV_NAMES, child_mesh, load_ranks, save_rank, spawn
from vqwild_tpu_torch.core.device import cpu_seeded
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.models.arv import ARVModel
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F
from vqwild_tpu_torch.retrieval import ARVRetrievalTrimmed, FeatureExtractor
from vqwild_tpu_torch.retrieval.features import make_fake_feat_fn, make_feat_fn
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer

SCORE_TOL, METRIC_TOL, EMBED_TOL = 1e-5, 1e-6, 1e-5
TORCHRUN_TIMEOUT_S = 300
# two ranks against one process over 4 va steps with dropout: the same
# masks and batches, the reductions in another order (BatchNorm, the
# gradient sum), and the runs free: they part as any two fp32 runs do
# (tests/test_torch_train_step.py). The first epoch's mean losses within
# 1e-4 (4e-6 measured), the second's 5e-3 (2.2e-3, the total); every parameter within
# 4 Adam steps' 4·2·lr (4.3e-4); BN statistics and the memory 1e-2
# (3.8e-3, a running variance)
TORCHRUN_LOSS_TOL = (1e-4, 5e-3)
TORCHRUN_PARAM_TOL, TORCHRUN_BUFFER_TOL = 8e-4, 1e-2
# one step from the same state (the one-step tolerances of
# tests/test_torch_train_step.py): an Adam step moves each parameter by
# ~lr·sign(g), so a rank-0 state that never stepped, or gradients left
# unsummed (a rank's own gradient's sign), puts far more than
# ONE_STEP_MAX_OFF of the elements past ONE_STEP_PARAM_TOL (all of them;
# 10% with the sum left out); rounding flips only the signs of gradients
# within it. Measured: losses 1.9e-6, 0.11% of
# the parameter elements past 1e-5, BN means 1.4e-6, variances 3.6e-6 of
# their value, the memory 4.2e-6
ONE_STEP_LR = 1e-4
ONE_STEP_LOSS_TOL, ONE_STEP_PARAM_TOL, ONE_STEP_MAX_OFF = 2e-4, 1e-5, 2e-3
ONE_STEP_BUFFER_ATOL, ONE_STEP_VAR_RTOL = 1e-5, 5e-3
TRIMMED_KW = dict(eval_split="validation", r_at_n=(5, 10), rank_chunk=16)


def fake_extractor(store):
    return FeatureExtractor(make_fake_feat_fn(32, seed=3), store, test_frames=8,
                            test_batch_size=4, input_size=64, fake=True)



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

def child_eval(in_path, out_dir):
    """The sharded scorer, the sharded trimmed evaluation (and rank 0's
    single process), make_feat_fn(mesh=) on both wires."""
    mesh = child_mesh()
    d = np.load(in_path)
    out = {}
    sc = GalleryScorer(d["g"], mesh=mesh)
    out["scores"] = sc.scores(d["q"])
    out["n_padded"] = sc.n_padded
    tp, ig = sc.pad_columns(np.ones((2, sc.n), bool), np.zeros((2, sc.n), bool))
    out["pad_tp"], out["pad_ignore"] = tp, ig
    spec = get_split(str(d["spec"]))
    db = load_trimmed_db(spec.db_json)
    r = ARVRetrievalTrimmed(db, spec, fake_extractor(SyntheticFrameStore()), mesh=mesh,
                            **TRIMMED_KW).evaluation()
    out["trimmed_ap"], out["trimmed_recall"] = r["ap"], json.dumps(r["recall"])
    if mesh.rank == 0:
        one = ARVRetrievalTrimmed(db, spec, fake_extractor(SyntheticFrameStore()),
                                  device="cpu", **TRIMMED_KW).evaluation()
        out["single_ap"], out["single_recall"] = one["ap"], json.dumps(one["recall"])
    with cpu_seeded(4):
        trunk = ResNet18F2F()
    for wire in ("rgb", "yuv420"):
        arrays = [d["clips"]] if wire == "rgb" else [d["y"], d["uv"]]
        out[f"embed_{wire}"] = make_feat_fn(trunk, wire=wire, mesh=mesh)(*arrays)
        out[f"embed_{wire}_single"] = make_feat_fn(trunk, wire=wire, device="cpu")(*arrays)
    save_rank(out_dir, mesh.rank, **out)


# ---- the tests ----

@pytest.fixture(scope="module", params=[2, 4])
def eval_run(request, tiny_arv, tmp_path_factory):
    from tests.test_torch_data import write_split_spec
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxStore
    from vqwild_tpu.data.schema import load_trimmed_db as jax_load_db
    from vqwild_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vqwild_tpu.retrieval import ARVRetrievalTrimmed as JaxTrimmed
    from vqwild_tpu.retrieval.features import FeatureExtractor as JaxExtractor
    from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_fake
    from vqwild_tpu.retrieval.sharded import GalleryScorer as JaxScorer
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    import jax

    world = request.param
    tmp = tmp_path_factory.mktemp(f"eval{world}")
    rng = np.random.default_rng(0)
    g = rng.normal(size=(37, 16)).astype(np.float32)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    jmesh = jax_make_mesh(devices=jax.devices()[:world])
    jsc = JaxScorer(g, mesh=jmesh)
    jex = JaxExtractor(jax_fake(32, seed=3), JaxStore(), test_frames=8, test_batch_size=4,
                       input_size=64, fake=True)
    jr = JaxTrimmed(jax_load_db(tiny_arv["db_path"]), tiny_arv["spec"], jex, mesh=jmesh,
                    **TRIMMED_KW).evaluation()
    clips = rng.integers(0, 256, (5, 2, 32, 32, 3), dtype=np.uint8)
    y, uv = rgb_to_yuv420_host(clips)
    spec = write_split_spec(tiny_arv, tmp / "spec.json")
    np.savez(tmp / "in.npz", g=g, q=q, spec=np.array(spec), clips=clips, y=y, uv=uv)
    spawn(world, "tests.test_torch_parallel_eval:child_eval", tmp / "in.npz", tmp, log_dir=tmp)
    return SimpleNamespace(world=world, g=g, q=q, jscores=np.asarray(jsc.scores(q)),
                           jn_padded=jsc.n_padded, jr=jr, res=load_ranks(tmp, world))


class TestShardedScorer:
    def test_scores_against_jax(self, eval_run):
        for r in eval_run.res:
            n_padded = int(r["n_padded"])
            assert n_padded % eval_run.world == 0 and n_padded - 37 < eval_run.world
            np.testing.assert_allclose(r["scores"][:, :37], eval_run.jscores[:, :37],
                                       atol=SCORE_TOL)
            want = -((eval_run.q[:, None, :] - eval_run.g[None]) ** 2).sum(-1)
            np.testing.assert_allclose(r["scores"][:, :37], want, atol=SCORE_TOL)

    def test_pad_columns_marks_padding_ignored(self, eval_run):
        for r in eval_run.res:
            n_padded = int(r["n_padded"])
            assert r["pad_tp"].shape == r["pad_ignore"].shape == (2, n_padded)
            assert not r["pad_tp"][:, 37:].any() and r["pad_ignore"][:, 37:].all()
            assert r["pad_tp"][:, :37].all() and not r["pad_ignore"][:, :37].any()


class TestShardedTrimmed:
    def test_against_jax_mesh_evaluator(self, eval_run):
        for r in eval_run.res:
            assert abs(float(r["trimmed_ap"]) - eval_run.jr["ap"]) < METRIC_TOL
            got = json.loads(str(r["trimmed_recall"]))
            want = {str(k): v for k, v in eval_run.jr["recall"].items()}
            assert got.keys() == want.keys()
            for k in want:
                assert abs(got[k] - want[k]) < METRIC_TOL, k

    def test_against_the_single_process(self, eval_run):
        r0 = eval_run.res[0]
        assert abs(float(r0["trimmed_ap"]) - float(r0["single_ap"])) < METRIC_TOL
        assert json.loads(str(r0["trimmed_recall"])) == json.loads(str(r0["single_recall"]))


class TestShardedExtraction:
    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_against_the_single_process(self, eval_run, wire):
        """Every rank returns the whole batch's features, the padding cut."""
        for r in eval_run.res:
            got, want = r[f"embed_{wire}"], r[f"embed_{wire}_single"]
            assert got.shape == want.shape == (5, 512, 2)
            np.testing.assert_allclose(got, want, atol=EMBED_TOL)
        for r in eval_run.res[1:]:
            np.testing.assert_array_equal(r[f"embed_{wire}"], eval_run.res[0][f"embed_{wire}"])


# ---- the command line under torchrun ----

def torchrun(args, cwd, log, nproc=2, timeout=TORCHRUN_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m vqwild_tpu_torch *args``; its process group is killed past the
    deadline. → (exit code, output)."""
    env = {k: v for k, v in os.environ.items() if k not in _ENV_NAMES}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", str(nproc), "-m", "vqwild_tpu_torch", *args],
                             cwd=cwd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            pytest.fail(f"torchrun {args} past its {timeout} s deadline")
    with open(log) as f:
        return p.returncode, f.read()


def _tiny(root, spec, *extra):
    return ["--frame_store", "synthetic", "--data_root", root, "--meta_split", spec,
            "--input_size", "32", "--train_frame", "2", "--test_frame", "2", "--batch_size", "2",
            "--test_batch_size", "4", "--workers", "0", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_runs(tiny_arv, tmp_path_factory):
    """va --debug (2 epochs of 2 steps, validation each epoch) on 2 ranks
    under torchrun and in one process."""
    from tests.test_torch_data import write_split_spec
    from vqwild_tpu_torch.apps import cli

    d = tmp_path_factory.mktemp("cli")
    spec = write_split_spec(tiny_arv, d / "spec.json")
    args = _tiny(tiny_arv["root"], str(spec), "--method", "va", "--debug", "--eval_per_epoch",
                 "1", "--wire", "yuv420")
    rc, out = torchrun(args + ["--run_dir", str(d / "run2")], d, d / "torchrun.log")
    assert rc == 0, out[-6000:]
    one_result = cli.main(args + ["--run_dir", str(d / "run1")])
    return SimpleNamespace(d=d, spec=spec, args=args, one_result=one_result, out=out)


@pytest.fixture(scope="module")
def cli_one_step(tiny_arv, tmp_path_factory):
    """va, one epoch of one step over the whole epoch's 14 triplets, on 2
    ranks under torchrun and in one process."""
    from tests.test_torch_data import write_split_spec
    from vqwild_tpu_torch.apps import cli

    d = tmp_path_factory.mktemp("cli1")
    spec = write_split_spec(tiny_arv, d / "spec.json")
    args = _tiny(tiny_arv["root"], str(spec), "--method", "va", "--epochs", "1",
                 "--eval_per_epoch", "1", "--wire", "yuv420")
    args[args.index("--batch_size") + 1] = "14"
    rc, out = torchrun(args + ["--run_dir", str(d / "run2")], d, d / "torchrun.log")
    assert rc == 0, out[-6000:]
    cli.main(args + ["--run_dir", str(d / "run1")])
    return d


def _read(run, *parts):
    with open(os.path.join(run, *parts)) as f:
        return json.load(f)


def _state(run, name):
    return torch.load(os.path.join(run, "checkpoints", name, "state.pt"), map_location="cpu",
                      weights_only=True)


class TestTorchrun:
    def test_trains_to_the_one_process_checkpoint(self, cli_runs):
        """The train history's losses, and every parameter, BN statistic
        and the memory in ``last``."""
        two, one = str(cli_runs.d / "run2"), str(cli_runs.d / "run1")
        h2, h1 = _read(two, "metrics", "train_history.json"), _read(one, "metrics",
                                                                     "train_history.json")
        assert [(h["epoch"], h["steps"]) for h in h2["history"]] == [(0, 2), (1, 2)]
        for a, b, tol in zip(h2["history"], h1["history"], TORCHRUN_LOSS_TOL):
            assert a["losses"].keys() == b["losses"].keys()
            for k in b["losses"]:
                assert abs(a["losses"][k] - b["losses"][k]) < tol, (a["epoch"], k)
        s2, s1 = _state(two, "last"), _state(one, "last")
        assert s2["step"] == s1["step"] == 4 and s2["epoch"] == s1["epoch"] == 1
        params = {n for n, _ in ARVModel("va", nclass=8, semantic_dim=16).named_parameters()}
        for k, v in s1["model"].items():
            w = s2["model"][k]
            if not v.is_floating_point():
                assert torch.equal(w, v), k
            else:
                tol = TORCHRUN_PARAM_TOL if k in params else TORCHRUN_BUFFER_TOL
                assert float((w - v).abs().max()) <= tol, k

    def test_one_step_to_the_one_process_checkpoint(self, cli_one_step):
        """One step of the whole batch (42 rows, 21 a rank) from the same
        initial state, held as tests/test_torch_train_step.py holds one
        step: the losses, every parameter within an Adam step's 2·lr and
        all but ONE_STEP_MAX_OFF of all parameter elements within
        ONE_STEP_PARAM_TOL, the BN statistics and the memory."""
        two, one = str(cli_one_step / "run2"), str(cli_one_step / "run1")
        (a,), (b,) = (_read(r, "metrics", "train_history.json")["history"] for r in (two, one))
        assert (a["epoch"], a["steps"]) == (b["epoch"], b["steps"]) == (0, 1)
        assert a["losses"].keys() == b["losses"].keys()
        for k in b["losses"]:
            assert abs(a["losses"][k] - b["losses"][k]) <= ONE_STEP_LOSS_TOL, k
        s2, s1 = _state(two, "last"), _state(one, "last")
        assert s2["step"] == s1["step"] == 1
        params = {n for n, _ in ARVModel("va", nclass=8, semantic_dim=16).named_parameters()}
        n_all = n_off = 0
        for k, v in s1["model"].items():
            w = s2["model"][k]
            d = (w.double() - v.double()).abs() if v.is_floating_point() else None
            if d is None:
                assert torch.equal(w, v), k
            elif k in params:
                # as np.testing.assert_allclose(atol=2·lr) holds it, with
                # its rtol of 1e-7 for the fp32 rounding of w
                assert bool((d <= 2 * ONE_STEP_LR + 1e-7 * v.double().abs()).all()), k
                n_all += d.numel()
                n_off += int((d > ONE_STEP_PARAM_TOL).sum())
            elif k.endswith("running_var"):
                torch.testing.assert_close(w, v, rtol=ONE_STEP_VAR_RTOL,
                                           atol=ONE_STEP_BUFFER_ATOL, msg=k)
            else:
                assert float(d.max()) <= ONE_STEP_BUFFER_ATOL, k
        assert n_off <= ONE_STEP_MAX_OFF * n_all, (n_off, n_all)

    def test_rank0_writes_and_evaluates_all_three(self, cli_runs):
        """One run directory, one log, one feature cache; the final
        evaluation covers the three regimes, as the one process's does."""
        run = cli_runs.d / "run2"
        assert sorted(os.listdir(run / "checkpoints")) == ["best", "last"]
        assert [p for p in os.listdir(run) if p.startswith("log.log")] == ["log.log"]
        assert len([p for p in os.listdir(run) if p.startswith("cache-")]) == 1
        want = {"trimmed", "clip", "moment"}
        assert set(_read(str(run), "metrics", "evaluation.json")) == want
        assert set(cli_runs.one_result) == want

    def test_int8_const_refused_before_anything_runs(self, cli_runs):
        run = cli_runs.d / "refused_int8_const"
        args = cli_runs.args + ["--run_dir", str(run), "--evaluate", "--trunk_int8_const"]
        rc, out = torchrun(args, cli_runs.d, cli_runs.d / "refused.log")
        assert rc != 0
        assert "single-device only" in out
        assert not run.exists()


def _numbers(tree, path=""):
    """{path: number} of a metrics tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_numbers(v, f"{path}/{k}"))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        out[path] = float(tree)
    return out


EVAL_FLAGS = {"fp32": ["--evaluate", "--eval_all"],
              "int8": ["--evaluate", "--eval_all", "--trunk_int8"]}


@pytest.fixture(scope="module", params=sorted(EVAL_FLAGS))
def eval_runs(request, cli_runs):
    """``--evaluate`` of the one process's ``best`` on 2 ranks under
    torchrun and in one process, each from a copy of the checkpoint
    directory (the int8 calibration file goes beside it)."""
    from vqwild_tpu_torch.apps import cli

    d, mode = cli_runs.d, request.param
    out = {}
    for who in ("two", "one"):
        ckpt = d / f"best_{mode}_{who}"
        shutil.copytree(d / "run1" / "checkpoints" / "best", ckpt)
        args = cli_runs.args + EVAL_FLAGS[mode] + ["--test_load", str(ckpt),
                                                    "--run_dir", str(d / f"eval_{mode}_{who}")]
        if who == "two":
            rc, log = torchrun(args, d, d / f"eval_{mode}.log")
            assert rc == 0, log[-6000:]
        else:
            cli.main(args)
        out[who] = SimpleNamespace(ckpt=ckpt, result=_read(str(d / f"eval_{mode}_{who}"),
                                                          "metrics", "evaluation.json"))
    return SimpleNamespace(mode=mode, **out)


class TestTorchrunEvaluate:
    def test_all_three_regimes_against_the_one_process(self, eval_runs):
        two, one = eval_runs.two.result, eval_runs.one.result
        assert set(two) == set(one) == {"trimmed", "clip", "moment"}
        assert two["moment"]["engine"] == one["moment"]["engine"]
        g, w = _numbers(two), _numbers(one)
        assert set(g) == set(w) and len(w) > 60
        worst = max(w, key=lambda k: abs(g[k] - w[k]))
        assert abs(g[worst] - w[worst]) <= METRIC_TOL, (worst, g[worst], w[worst])

    def test_int8_calibration_file_written_once(self, eval_runs):
        """Rank 0 calibrates once from the first batch of 4 clips (2 a rank,
        no padding) and writes the file: the one process's, byte for byte."""
        files = {who: sorted(p for p in os.listdir(ns.ckpt) if "int8_calib" in p)
                 for who, ns in (("two", eval_runs.two), ("one", eval_runs.one))}
        if eval_runs.mode == "fp32":
            assert files == {"two": [], "one": []}
            return
        assert len(files["two"]) == len(files["one"]) == 1
        two = (eval_runs.two.ckpt / files["two"][0]).read_text()
        assert two == (eval_runs.one.ckpt / files["one"][0]).read_text()
