"""What every run shares: the registry of files found by name, the run's
context, the compared numbers and the last line.

A configuration is ``configs/<name>.json``, a cell ``workloads/<name>.json``,
an entry kind ``drivers/<driver>.py`` and a per-layer metric
``metrics/<name>.py``; ``BENCHMARK.json`` at the checkout's root says which
metrics a cell reports. Nothing here knows a cell by name.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "vqwild_tpu")


def setup_env() -> None:
    """Every cache the program or its libraries keep, inside this checkout
    at fixed paths (the port's nvcc and g++ builds already go to
    vqwild_tpu_torch/_build), and no JAX behind a library's back."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(CACHE_DIR, "inductor"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE_DIR, "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, name + ".json")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, section: str) -> List[dict]:
    """The ``section`` metrics that ``cell`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


@dataclass
class Check:
    """One number compared with its limit; NaN and infinity fail."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not (math.isnan(self.value) or math.isinf(self.value)) and self.value <= self.limit


@dataclass
class Ctx:
    workload: dict
    config: dict
    params: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    rehearse: bool
    t_start: float
    mode: str = "run"  # run | control | fault:<name>
    device: Any = None
    chips: int = 1

    @property
    def name(self) -> str:
        return self.workload["name"]


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values (``--trace 0``), the
    traced window's summary and the counters the metric readers take
    (``--trace 1``), and the compared numbers."""
    setup_s: float
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Any] = None
    window_s: float = 0.0


def make_ctx(workload_name: str, seed: int, seconds: float, trace: bool, rehearse: bool,
             t_start: float, mode: str = "run", overrides: Optional[dict] = None) -> Ctx:
    wl = load_json("workloads", workload_name)
    cfg = load_json("configs", wl["config"])
    params = {k: v for k, v in cfg.items() if k not in ("name", "source", "reduced", "assumed")}
    params.update(wl.get("traffic", {}))
    if rehearse:
        params.update(wl.get("rehearse", {}))
    params.update(overrides or {})
    if rehearse and "rehearse_limits" in wl:
        wl = dict(wl, limits=dict(wl["limits"], **wl["rehearse_limits"]))
    return Ctx(workload=wl, config=cfg, params=params, seed=seed, seconds=seconds, trace=trace,
               rehearse=rehearse, t_start=t_start, mode=mode, chips=int(wl.get("chips", 1)))


def now() -> float:
    return time.perf_counter()
