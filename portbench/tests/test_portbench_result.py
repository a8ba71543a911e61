"""The last line's schema, the refusals, and no JAX in a run."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import common

RUN = os.path.join(common.BENCH_DIR, "run.py")


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, RUN, *args], cwd=common.ROOT, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("cell", ["va-train", "va-serve-clip", "vasa-serve-moment"])
def test_the_last_line_of_a_rehearsal(cell):
    p = _run("--workload", cell, "--seed", str(2**31 + 77), "--seconds", "1", "--trace", "0",
             "--rehearse")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    bench = common.benchmark()
    want = {m["name"]: m["unit"] for m in common.metrics_of(bench, cell, "end_to_end")}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"  # a rehearsal never names a device
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text.startswith(f"check {name} = ") and f"limit {c['limit']!r}" in text


def test_a_rehearsal_refuses_a_trace():
    p = _run("--workload", "va-train", "--seed", "1", "--seconds", "1", "--trace", "1",
             "--rehearse")
    assert p.returncode != 0 and p.stdout == ""


def test_without_a_card_a_run_prints_nothing_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run("--workload", "va-train", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_a_run_fails(tmp_path):
    import shutil

    shutil.copytree(common.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "va-train", "--seed",
                        "1", "--seconds", "1", "--trace", "0", "--rehearse"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_jax_is_named_by_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "vqwild_tpu_torch_lookalike", types.ModuleType("x"))
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vqwild_tpu.ops", types.ModuleType("vqwild_tpu.ops"))
    assert common.forbidden_modules() == ["vqwild_tpu"]


def test_a_rehearsal_loads_no_jax(rehearse):
    for cell in ("va-train", "vasa-serve-moment"):
        rehearse(cell, 5, 0.5)
    assert common.forbidden_modules() == []
