"""Cells, configurations, drivers and metrics are found by name from files
alone, and BENCHMARK.json keeps to the contract's shape."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_names_files_that_exist():
    bench = common.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        wl = common.load_json("workloads", cell["name"])
        assert wl["name"] == cell["name"] and wl["config"] == cell["config"]
        assert cell["traffic"] == cell["name"]
        assert wl["chips"] == cell["chips"]
        cfg = common.load_json("configs", wl["config"])
        assert cfg["name"] in configs
        assert configs[cfg["name"]]["reduced"] == cfg["reduced"]
        assert configs[cfg["name"]]["source"] == cfg["source"]
        assert os.path.isfile(os.path.join(common.BENCH_DIR, "drivers", wl["driver"] + ".py"))
        for m in bench["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                assert hasattr(common.load_module("metrics", m["name"]), "read")


def test_names_units_and_sections_keep_the_contract():
    bench = common.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        for cell in m["workloads"]:
            assert any(m["moves"] == e["name"] and cell in e.get("workloads", [cell])
                       for e in bench["end_to_end"])
    cells = [c["name"] for c in bench["workloads"]]
    for cell in cells:
        reported = common.metrics_of(bench, cell, "end_to_end")
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert common.metrics_of(bench, cell, "per_layer")
    assert sum(c["chips"] == 4 for c in bench["workloads"]) <= max(1, len(cells) // 4)
    for c in bench["configs"]:
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_a_cell_and_a_metric_added_as_files_run_in_the_rehearsal(tmp_path):
    """A throwaway cell and a throwaway per-layer metric, added as new files
    and entries only, are found and run."""
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(common.ROOT, "vqwild_tpu_torch"), root / "vqwild_tpu_torch")
    bench = common.benchmark()
    wl = common.load_json("workloads", "va-serve-clip")
    wl.update(name="tiny-clip", traffic=dict(wl["traffic"], k=5))
    (root / "portbench" / "workloads" / "tiny-clip.json").write_text(json.dumps(wl))
    (root / "portbench" / "metrics" / "answers_seen.py").write_text(
        "def read(out, ctx):\n    return float(out.attempted - out.failed)\n")
    bench["workloads"].append({"name": "tiny-clip", "config": wl["config"],
                               "traffic": "tiny-clip", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "query_p50_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-clip"]})
    bench["per_layer"].append({"name": "answers_seen", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "HTTP front-end",
                               "moves": "query_p50_ms", "workloads": ["tiny-clip"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from portbench.harness import common; from portbench import run;"
            "ctx = common.make_ctx('tiny-clip', 7, 1.0, False, True, time.perf_counter());"
            "ctx.device = torch.device('cpu');"
            "out = common.load_module('drivers', ctx.workload['driver']).run(ctx);"
            "print(run.reported(common.benchmark(), ctx, out, 'per_layer'));"
            "print(sorted(run.reported(common.benchmark(), ctx, out, 'end_to_end')))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    per_layer, e2e = p.stdout.strip().splitlines()[-2:]
    assert "answers_seen" in per_layer and "'unit': 'requests'" in per_layer
    assert e2e == "['query_p50_ms', 'setup_s']"


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        common.load_json("workloads", "no-such-cell")
