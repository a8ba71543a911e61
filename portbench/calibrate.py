"""Readings that set a cell's limits, several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <a>-<b> \
        --modes run,control,fault:half_batch [--seconds 2]

For every mode and seed it runs the cell's driver as ``run.py`` would (a
short window for ``run`` and faults; none for ``control``) and prints one
JSON line with each compared number. ``control`` is the reference in the
next precision down (TF32 with TF32 off stated) in the program's place;
``fault:<name>`` plants a fault in the program (the train driver's
``half_batch``: half of each checked batch left out, the mean over the
rest). Not run by the benchmark's own runs; the limits in the cell's
workload file are set from these readings (PERF.md gives them).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.common import load_module, make_ctx, setup_env  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="first-last")
    p.add_argument("--modes", default="run,control")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rehearse", action="store_true")
    a = p.parse_args()
    setup_env()
    import torch

    lo, hi = (int(x) for x in a.seeds.split("-"))
    for mode in a.modes.split(","):
        for seed in range(lo, hi + 1):
            ctx = make_ctx(a.workload, seed, a.seconds, False, a.rehearse, time.perf_counter(),
                           mode)
            ctx.device = torch.device("cpu") if a.rehearse else torch.device("cuda", 0)
            out = load_module("drivers", ctx.workload["driver"]).run(ctx)
            print(json.dumps({"mode": mode, "seed": seed, "attempted": out.attempted,
                              "checks": out.counters.get("readings") or
                              {c.name: c.value for c in out.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
