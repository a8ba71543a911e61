"""Check and time kernel K2 (``stem_s2d_pool``) of one checkout on the GPU.

    python vqwild_tpu_torch/ops/time_stem_pool.py [--root DIR] [--shapes N,H,W,C ...]

``--root`` names the checkout whose ``vqwild_tpu_torch`` is imported
(default: the one this file lies in), so that two versions of the kernel can
be timed in turns on one card, one process each. Per shape and dtype it
prints one JSON line: the kernel's largest difference from the plain PyTorch
version and its device time (CUDA events around 20 back-to-back launches).
The first line is the card's name and power limit, the second ptxas's
register and spill report.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--shapes", nargs="+", default=["960,56,56,6", "32,56,56,6"])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch

    from vqwild_tpu_torch.ops import _build
    from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

    if not torch.cuda.is_available():
        print("time_stem_pool: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "root": args.root}), flush=True)
    _build.build(["stem_pool"])
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_log("stem_pool").splitlines()
                                if "registers" in ln or "spill" in ln]}), flush=True)

    for spec in args.shapes:
        n, h, w, c = (int(v) for v in spec.split(","))
        gen = torch.Generator(device=dev).manual_seed(2)
        x32 = torch.randn((n, h, w, c), generator=gen, device=dev)
        w32 = 0.1 * torch.randn(16 * c, 64, generator=gen, device=dev)
        b32 = 0.1 * torch.randn(64, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, wm, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got = stem_s2d_pool(x, wm, b)
            torch.cuda.synchronize()
            err = (got.float() - stem_s2d_pool_plain(x, wm, b).float()).abs().max().item()
            for _ in range(3):
                stem_s2d_pool(x, wm, b)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # the host enqueues while the card spins
            start.record()
            for _ in range(args.iters):
                stem_s2d_pool(x, wm, b)
            end.record()
            end.synchronize()
            print(json.dumps({"shape": [n, h, w, c], "dtype": str(dtype).replace("torch.", ""),
                              "max_abs_err": err,
                              "kernel_ms": start.elapsed_time(end) / args.iters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
