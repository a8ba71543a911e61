"""Shared helpers of the benchmark's CPU tests: a rehearsal of a cell in
this process, at the toy sizes of its workload file."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def rehearse():
    """rehearse(cell, seed, seconds=1.0, mode="run") -> (ctx, outcome)."""
    import torch

    from portbench.harness.common import load_module, make_ctx, setup_env

    setup_env()

    def go(cell, seed, seconds=1.0, mode="run"):
        ctx = make_ctx(cell, seed, seconds, False, True, time.perf_counter(), mode)
        ctx.device = torch.device("cpu")
        return ctx, load_module("drivers", ctx.workload["driver"]).run(ctx)

    return go
