"""The int8 trunk through the port's command line against the JAX
package's, on the CPU: ``--evaluate --eval_all --wire yuv420
--trunk_int8`` from one exported checkpoint over the tiny DB.

The port evaluates first: its first batch calibrates the int8 trunk and the
calibration is written beside the checkpoint, at
``models.quant.calibration_path``. JAX's ``cli.main`` with the same flags
finds that file under the same name and loads it, so both packages run the
int8 graph from the same scales (tests/test_torch_quant.py holds the graph
itself to JAX's). A file of its own: JAX's int8 evaluation of the three
regimes takes ~30 s here.
"""

import json
import os

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.apps import cli
from vqwild_tpu_torch.models.arv import build_model
from vqwild_tpu_torch.models.convert import save_reference_checkpoint
from vqwild_tpu_torch.models.quant import calibration_path, load_calibration

# every metric of the three regimes: the same int8 activations, embeddings
# within ~1e-8 (the L2 norm's summation order), and the ranks they give
# equal unless two gallery rows tie to that level
INT8_METRIC_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port here: the suite's parallel workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numbers(tree, path=""):
    """{path: number} of a metrics tree, through JSON as the run writes it."""
    tree = json.loads(json.dumps(tree, default=float))
    out = {}

    def walk(node, p):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{p}/{k}")
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            out[p] = float(node)

    walk(tree, path)
    return out


def test_evaluate_eval_all_int8_equals_jax(tiny_arv, tmp_path):
    from tests.test_torch_data import write_split_spec
    from vqwild_tpu.apps import cli as jax_cli

    spec = write_split_spec(tiny_arv, tmp_path / "spec.json")
    tiny = ["--frame_store", "synthetic", "--data_root", tiny_arv["root"], "--meta_split", spec,
            "--input_size", "32", "--test_frame", "2", "--test_batch_size", "4",
            "--workers", "0", "--method", "baseline", "--evaluate", "--eval_all",
            "--wire", "yuv420", "--trunk_int8"]
    cfg = cli.parse(tiny + ["--device", "cpu"])[0]
    model = build_model(cfg.model, "cpu", seed=4)
    with torch.no_grad():  # BN statistics off their init
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    pth = str(tmp_path / "best.pth.tar")
    save_reference_checkpoint(pth, model, "baseline")
    calib = calibration_path(pth)

    got = cli.main(tiny + ["--test_load", pth, "--device", "cpu",
                           "--run_dir", str(tmp_path / "port")])
    written = load_calibration(calib)  # the first batch's, beside the checkpoint
    assert len(written) == 17
    caches = [p for p in os.listdir(tmp_path / "port") if p.startswith("cache-")]
    assert len(caches) == 1 and "-torch-yuv420-int8-" in caches[0]

    want = jax_cli.main(tiny + ["--test_load", pth, "--run_dir", str(tmp_path / "jax")])
    assert load_calibration(calib) == written  # JAX loaded it, wrote nothing
    assert set(got) == set(want) == {"trimmed", "clip", "moment"}
    g, w = _numbers(got), _numbers(want)
    assert set(w) <= set(g) and len(w) > 60
    diffs = {k: abs(g[k] - w[k]) for k in w}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= INT8_METRIC_TOL, (worst, g[worst], w[worst])
    assert all(np.isfinite(v) for v in g.values())
