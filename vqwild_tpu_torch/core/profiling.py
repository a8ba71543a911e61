"""Profiling hooks (counterpart of vqwild_tpu/core/profiling.py).

``trace(run_dir)`` wraps a region in a torch.profiler trace (host ops, and
the card's kernels when a GPU is present), written as a Chrome trace that
Perfetto opens. ``StepTimer`` gives per-step host-side timings, with
``sync`` waiting for the card first, so that a step's time includes its
device work and not only its enqueueing."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

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


def sync(tree) -> None:
    """Wait for the work that writes ``tree``'s tensors: dicts, lists and
    tuples are walked, and each CUDA device that holds a tensor leaf is
    synchronised once. CPU tensors and other leaves need no wait."""
    devices = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor) and node.is_cuda:
            devices.add(node.device)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Rolling per-step timings: data / compute / total, logged every N."""

    def __init__(self, window: int = 50):
        self.window = window
        self.samples = []
        self._t_last = time.time()

    def step(self, data_time: float, result_tree=None) -> float:
        if result_tree is not None:
            sync(result_tree)
        now = time.time()
        total = now - self._t_last
        self._t_last = now
        self.samples.append((data_time, total))
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return total

    @property
    def avg_total(self) -> float:
        return float(np.mean([t for _, t in self.samples])) if self.samples else 0.0

    @property
    def avg_data(self) -> float:
        return float(np.mean([d for d, _ in self.samples])) if self.samples else 0.0
