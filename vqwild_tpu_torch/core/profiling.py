"""Profiling hooks (counterpart of vqwild_tpu/core/profiling.py; only the
``phase`` timer is ported so far)."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def phase(timings: dict, key: str):
    """Accumulate wall time into ``timings[key]`` — the per-phase cost
    accounting behind the evaluators' ``.timings``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
