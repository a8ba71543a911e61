"""Profiling hooks (counterpart of vqwild_tpu/core/profiling.py; ``phase``
and ``trace`` are ported, ``sync`` and ``StepTimer`` are not yet).

``trace(run_dir)`` wraps a region in a torch.profiler trace (host ops, and
the card's kernels when a GPU is present), written as a Chrome trace that
Perfetto opens."""

from __future__ import annotations

import contextlib
import os
import time

from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("profiling")


@contextlib.contextmanager
def phase(timings: dict, key: str):
    """Accumulate wall time into ``timings[key]`` — the per-phase cost
    accounting behind the evaluators' ``.timings``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(run_dir: str, enabled: bool = True):
    """torch.profiler trace context; writes {run_dir}/profile/trace.json."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
