"""Check and time one of the port's CUDA kernels, of one checkout, on the GPU.

    python vqwild_tpu_torch/ops/time_kernels.py --kernel sq_l2|stem_pool \\
        [--root DIR] [--shapes ...] [--iters N] [--cold]

``--root`` names the checkout whose ``vqwild_tpu_torch`` is imported
(default: the one this file lies in), so that two versions of a kernel can
be timed in turns on one card, one process each. ``--shapes`` are ``Q,G,D``
for ``sq_l2`` (K1) and ``N,H,W,C`` for ``stem_pool`` (K2, timed in fp32 and
bf16). Per case it prints one JSON line: the kernel's largest difference
from the plain PyTorch version and its device time (CUDA events around
``--iters`` back-to-back launches, enqueued while the card spins). With
``--cold`` each launch is also timed alone after a write of 256 MB that
empties the L2 cache (median of ``--iters`` launches). The first
line is the card's name and power limit, the second ptxas's register and
spill report.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

DEFAULT_SHAPES = {
    "sq_l2": ["16,7670,512", "16,100000,512", "1,7670,512", "5,130,512", "300,1000,64"],
    "stem_pool": ["960,56,56,6", "32,56,56,6"],
}


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # the host enqueues while the card spins
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int) -> float:
    """Median time of one launch that finds the L2 cache emptied."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def cases_sq_l2(shapes, dev):
    """(row, kernel call, plain call) per ``Q,G,D`` shape, N(0,1) data."""
    import torch

    from vqwild_tpu_torch.ops import distance

    gen = torch.Generator(device=dev).manual_seed(1)
    for spec in shapes:
        nq, ng, d = (int(v) for v in spec.split(","))
        q = torch.randn(nq, d, generator=gen, device=dev)
        g = torch.randn(ng, d, generator=gen, device=dev)
        row = {"kernel": "sq_l2", "shape": [nq, ng, d]}
        if hasattr(distance, "launch_plan"):  # an older checkout has no split of K to report
            row["plan"] = distance.launch_plan(nq, ng, d)
        yield (row, lambda q=q, g=g: distance.sq_l2(q, g),
               lambda q=q, g=g: distance.pairwise_sq_l2(q, g))


def cases_stem_pool(shapes, dev):
    """(row, kernel call, plain call) per ``N,H,W,C`` shape and dtype."""
    import torch

    from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

    for spec in shapes:
        n, h, w, c = (int(v) for v in spec.split(","))
        gen = torch.Generator(device=dev).manual_seed(2)
        x32 = torch.randn((n, h, w, c), generator=gen, device=dev)
        w32 = 0.1 * torch.randn(16 * c, 64, generator=gen, device=dev)
        b32 = 0.1 * torch.randn(64, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = (x32.to(dtype), w32.to(dtype), b32.to(dtype))
            row = {"kernel": "stem_pool", "shape": [n, h, w, c],
                   "dtype": str(dtype).replace("torch.", "")}
            yield (row, lambda a=args: stem_s2d_pool(*a), lambda a=args: stem_s2d_pool_plain(*a))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=sorted(DEFAULT_SHAPES))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--shapes", nargs="+")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch

    from vqwild_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "root": args.root}), flush=True)
    _build.build([args.kernel])
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_log(args.kernel).splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)

    cases = {"sq_l2": cases_sq_l2, "stem_pool": cases_stem_pool}[args.kernel]
    for row, kernel, plain in cases(args.shapes or DEFAULT_SHAPES[args.kernel], dev):
        got = kernel()
        torch.cuda.synchronize()
        row["max_abs_err"] = (got.float() - plain().float()).abs().max().item()
        row["kernel_ms"] = time_ms(kernel, args.iters)
        if args.cold:
            row["cold_ms"] = cold_ms(kernel, args.iters)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
