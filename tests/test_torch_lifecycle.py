"""The port's whole cycle through its command line, on the CPU: the
counterpart of tests/test_lifecycle.py (train → export → evaluate →
serve), then the slice against the JAX package.

- ``python -m vqwild_tpu_torch`` trains va under --debug (validation every
  epoch, ``best`` and ``last``, the final --eval_all on ``testing``),
  exports ``best`` as a reference ``.pth.tar`` and evaluates the export on
  the yuv420 wire; a GalleryIndex built through the loaded export answers
  a record's own query with its own row first.
- The same export through JAX's ``cli.main --evaluate`` and the port's:
  the trimmed metrics agree (METRIC_TOL).
- The server's embed function built from the ``best`` directory equals
  the one built from its export.
- A run and its --resume start where JAX's would and run JAX's schedule
  (epochs and steps of ``train_history``), against JAX's ``run_training``
  on the same DB. The trajectories themselves part within 3 Adam steps
  (tests/test_torch_loop.py compares one step from JAX's weights).
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.apps import cli
from vqwild_tpu_torch.core.logging import get_logger

# the trimmed metrics of one export through both packages' command lines:
# the same weights, features within ~1e-6 (folded fp32 trunk against JAX's),
# and the ranks they give equal unless two gallery rows tie to that level
METRIC_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port here: the suite's parallel workers
    share the CPU, and torch's default of a thread per core oversubscribes
    it (the cycle took 145 s instead of 41 s beside five busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(root, spec, *extra):
    return ["--frame_store", "synthetic", "--data_root", root, "--meta_split", spec,
            "--input_size", "32", "--train_frame", "2", "--test_frame", "2", "--batch_size", "2",
            "--test_batch_size", "4", "--workers", "0", *extra]


def _metrics(run, name):
    with open(os.path.join(run, "metrics", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cycle(tiny_arv, tmp_path_factory):
    """Train, export and evaluate with the port's command line."""
    from tests.test_torch_data import write_split_spec

    d = str(tmp_path_factory.mktemp("torch_lifecycle"))
    spec = write_split_spec(tiny_arv, os.path.join(d, "spec.json"))
    port = lambda *a: _tiny(tiny_arv["root"], spec, "--device", "cpu", *a)  # noqa: E731
    run = os.path.join(d, "run")
    trained = cli.main(port("--method", "va", "--debug", "--run_dir", run, "--eval_per_epoch",
                            "1", "--wire", "yuv420"))
    best = os.path.join(run, "checkpoints", "best")
    pth = os.path.join(d, "exported.pth.tar")
    cli.main(port("--method", "va", "--test_load", best, "--export_torch", pth))
    run_eval = os.path.join(d, "run_eval")
    evaluated = cli.main(port("--method", "va", "--evaluate", "--test_load", pth,
                              "--run_dir", run_eval, "--wire", "yuv420"))
    return SimpleNamespace(d=d, spec=spec, port=port, run=run, best=best, pth=pth,
                           trained=trained, evaluated=evaluated, run_eval=run_eval,
                           root=tiny_arv["root"])


def test_train_export_evaluate(cycle):
    history = _metrics(cycle.run, "train_history")
    assert [(h["epoch"], h["steps"]) for h in history["history"]] == [(0, 2), (1, 2)]
    assert all(np.isfinite(v) for h in history["history"] for v in h["losses"].values())
    assert all(0.0 <= h["ap"] <= 1.0 for h in history["history"])
    assert os.path.isdir(os.path.join(cycle.run, "checkpoints", "last"))
    # the final evaluation: every regime on testing, from `best`
    assert set(cycle.trained) == {"trimmed", "clip", "moment"}
    assert _metrics(cycle.run, "evaluation").keys() == cycle.trained.keys()
    assert cycle.trained["moment"]["engine"] in ("native", "numpy")
    # the export carries the reference's DataParallel prefix and the
    # best checkpoint's weights, with its dead rank_nl block filled
    sd = torch.load(cycle.pth, map_location="cpu", weights_only=True)["state_dict"]
    payload = torch.load(os.path.join(cycle.best, "state.pt"), map_location="cpu",
                         weights_only=True)
    assert {"module." + k for k in payload["model"]} < set(sd)
    for k, v in payload["model"].items():
        assert torch.equal(sd["module." + k], v), k
    assert torch.equal(sd["module.rank_nl.g.weight"], sd["module.cls_nl.g.weight"])
    # evaluated from the export on the yuv420 wire
    assert set(cycle.evaluated) == {"trimmed"}
    assert 0.0 <= cycle.evaluated["trimmed"]["ap"] <= 1.0
    caches = [p for p in os.listdir(cycle.run_eval) if p.startswith("cache-")]
    assert len(caches) == 1 and "-torch-yuv420-float-" in caches[0]


def test_gallery_index_and_query_service(cycle):
    from vqwild_tpu_torch.retrieval.features import FeatureExtractor
    from vqwild_tpu_torch.serve.index import GalleryIndex
    from vqwild_tpu_torch.serve.service import QueryService

    cfg, _ = cli.parse(cycle.port("--method", "va", "--wire", "yuv420"))
    _, db, store, model, _, _ = cli.build_stack(cfg, "cpu")
    cli.load_variables(cycle.pth, "va", model)
    feat_fn = cli._feat_fn(cfg, model, "cpu")
    extractor = FeatureExtractor(feat_fn, store, test_frames=2, test_batch_size=4,
                                 input_size=32, wire="yuv420")
    records = db.flat("testing")[:12]
    index = GalleryIndex.build(records, extractor, device="cpu")
    assert index.n == 12
    svc = QueryService(index, embed_fn=feat_fn, max_wait_ms=1.0)
    try:
        res = svc.query_features(extractor.extract_trimmed([records[3]])[0], k=3)
    finally:
        svc.close()
    assert res[0]["video_id"] == records[3].video_id
    assert res[0]["rank"] == 0 and len(res) == 3


def test_evaluation_equals_jax(cycle, tmp_path):
    """The export through JAX's cli.main --evaluate and the port's, on the
    yuv420 wire: the trimmed ap, its base/novel parts and R@N within
    METRIC_TOL."""
    from vqwild_tpu.apps import cli as jax_cli

    args = ["--method", "va", "--evaluate", "--test_load", cycle.pth, "--wire", "yuv420"]
    want = jax_cli.main(_tiny(cycle.root, cycle.spec, *args,
                              "--run_dir", str(tmp_path / "jax")))["trimmed"]
    got, want = (json.loads(json.dumps(r, default=float))
                 for r in (cycle.evaluated["trimmed"], want))
    pairs = [(got[k], want[k]) for k in ("ap", "base_map", "novel_map")]
    pairs += [(got["recall"][n], want["recall"][n]) for n in ("30", "50", "100")]
    assert max(abs(a - b) for a, b in pairs) <= METRIC_TOL, pairs


def test_server_from_the_directory_equals_the_export(cycle):
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.serve.__main__ import _build_embed_fn

    def args(test_load):
        return SimpleNamespace(test_load=test_load, method="va", meta_split=cycle.spec,
                               data_root=cycle.root, frames_dir="", input_size=32, test_frame=2,
                               test_batch_size=4, frame_store="synthetic",
                               eval_split="testing", trunk_int8=False)

    rng = np.random.default_rng(11)
    y, uv = rgb_to_yuv420_host(rng.integers(0, 256, (3, 2, 32, 32, 3), dtype=np.uint8))
    log = get_logger("test")
    a = _build_embed_fn(args(cycle.best), torch.device("cpu"), torch.float32, log)(y, uv)
    b = _build_embed_fn(args(cycle.pth), torch.device("cpu"), torch.float32, log)(y, uv)
    assert a.shape == (3, 512, 2) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_resume_schedule_equals_jax(cycle, tmp_path):
    """Two epochs, then --resume to three (--profile on the resumed run):
    the port's first run makes the epochs and steps of JAX's run_training
    over the same two epochs (batch 14 of the 14 triplets a tiny epoch
    holds: one step an epoch), and its resume starts at the epoch after
    JAX's ``last``. JAX's own --resume is not run: on the tests' 8 virtual
    devices its restored state sits on one device and its step refuses the
    mesh-sharded batch."""
    from vqwild_tpu.apps import cli as jax_cli
    from vqwild_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

    def argv(run, epochs, *extra):
        return _tiny(cycle.root, cycle.spec, "--method", "va", "--batch_size", "14",
                     "--eval_per_epoch", "99", "--epochs", str(epochs), "--run_dir", run, *extra)

    port, jax_run = str(tmp_path / "port"), str(tmp_path / "jax")
    cli.main(argv(port, 2, "--device", "cpu"))
    first = _metrics(port, "train_history")
    cli.main(argv(port, 3, "--device", "cpu", "--resume", "--profile"))
    resumed = _metrics(port, "train_history")
    jax_cli.main(argv(jax_run, 2))
    jax_start = int(JaxCheckpointManager(os.path.join(jax_run, "checkpoints")).restore(
        "last")["epoch"]) + 1

    def schedule(h):
        return [(e["epoch"], e["steps"]) for e in h["history"]]

    assert schedule(first) == schedule(_metrics(jax_run, "train_history")) == [(0, 1), (1, 1)]
    assert schedule(resumed) == [(jax_start, 1)] and jax_start == 2
    assert os.path.getsize(os.path.join(port, "profile", "trace.json")) > 0
