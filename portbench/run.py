"""The benchmark of vqwild_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json on this machine's GPUs and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared for ``correct``
beside its limit, which are also the last lines of standard error.

Without CUDA, or with fewer GPUs than the cell asks for, it prints no
result and exits 2; it never falls back to the CPU. ``--rehearse`` runs the
cell at the toy sizes of its workload file's ``rehearse`` block on the
CPU, with the kernels' plain versions, for the CPU tests only: it prints
no device metric and refuses ``--trace 1``.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness.common import (  # noqa: E402
    benchmark, forbidden_modules, load_module, log, make_ctx, metrics_of, setup_env,
)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rate", type=float, default=None,
                   help="an open-loop cell's rate, for the sweep that sets it")
    return p.parse_args(argv)


def _program_present() -> bool:
    try:
        import vqwild_tpu_torch
    except ImportError:
        return False
    return os.path.dirname(os.path.dirname(os.path.abspath(vqwild_tpu_torch.__file__))) == ROOT


def _clean(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def reported(bench: dict, ctx, out, section: str) -> dict:
    """The cell's ``section`` metrics that have a value: end-to-end ones from
    the driver, per-layer ones from their readers (a reader that finds
    nothing to read returns None and the metric is left out)."""
    metrics = {}
    for m in metrics_of(bench, ctx.name, section):
        if section == "end_to_end":
            v = out.setup_s if m["name"] == "setup_s" else out.metrics.get(m["name"])
        else:
            v = load_module("metrics", m["name"]).read(out, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": _clean(float(v)), "unit": m["unit"]}
    return metrics


def main(argv=None) -> int:
    args = parse(argv)
    setup_env()
    if args.rehearse and args.trace:
        log("--rehearse refuses --trace 1: a CPU run has no device trace")
        return 2
    overrides = {} if args.rate is None else {"rate": args.rate}
    ctx = make_ctx(args.workload, args.seed, args.seconds, bool(args.trace), args.rehearse,
                   T_START, overrides=overrides)
    if not _program_present():
        log("vqwild_tpu_torch is not in this checkout")
        return 2
    import torch

    if args.rehearse:
        ctx.device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.chips:
            log(f"needs {ctx.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        ctx.device = torch.device("cuda", 0)
        torch.cuda.set_device(ctx.device)
    driver = load_module("drivers", ctx.workload["driver"])
    out = driver.run(ctx)
    metrics = reported(benchmark(), ctx, out, "per_layer" if args.trace else "end_to_end")

    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package is loaded in this process: {', '.join(bad)}")
        return 3
    correct = all(c.ok for c in out.checks)
    if args.rehearse:
        device = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.chips,
                  "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": _clean(c.value) if _clean(c.value) is not None
                               else str(c.value), "limit": c.limit} for c in out.checks}
    for c in out.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
