"""The traced run: torch.profiler's device activity over the window, and
the benchmark's own host spans.

The profiler records CUDA activity only (kernels, copies, fills): recording
every host-side operator of every serving thread slowed a traced clip
query sevenfold. Host spans are the benchmark's wrappers' own, on the host
clock. A sentinel kernel launched right after a synchronise, at a known
host time, puts the device's timeline on the host clock, so the window's
device activity can be cut to the window and each idle gap named by the
innermost span open on the host in its middle. ``busy_s`` is the union of
the device intervals inside the window.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.harness.common import log, now

SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s_by_name: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_s(self, *fragments: str) -> float:
        """Device seconds of the activities whose name holds any fragment."""
        return sum(s for n, s in self.device_s_by_name.items()
                   if any(f in n for f in fragments))

    def breakdown(self) -> dict:
        top = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


class Tracer:
    """Host spans always cost a list append; the profiler runs only when
    ``enabled``."""

    def __init__(self, torch, device, enabled: bool):
        self.torch, self.device, self.enabled = torch, device, enabled
        self.spans: List[Tuple[float, float, str]] = []
        self._lock = threading.Lock()
        self.summary: Optional[TraceSummary] = None

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.enabled:
            with self._lock:
                self.spans.append((t0, t1, name))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = now()
        try:
            yield
        finally:
            self.add(name, t0, now())

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window; yields its start on the host clock. With the
        profiler on, it ends after a synchronise and is summarized."""
        self._sync()
        if not self.enabled:
            yield now()
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self._sync()
            h_mark = now()
            self.torch.cuda._sleep(1000)
            h0 = now()
            yield h0
            self._sync()
            h1 = now()
        self.summary = summarize(prof, h_mark, h0, h1, self.spans)


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def summarize(prof, h_mark: float, h0: float, h1: float, spans) -> TraceSummary:
    """Device activity in [h0, h1] (host clock) from a finished profiler."""
    dev, mark = [], None
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        start, dur, name = _ns(e, "start"), _ns(e, "duration"), e.name()
        if SENTINEL in name:
            mark = start if mark is None else min(mark, start)
        elif not name.startswith("portbench."):  # a span's device-side mark is no work
            dev.append((start, start + dur, name))
    if mark is None:  # no sentinel seen: the device's first activity stands for the window's start
        log("trace: no sentinel kernel; the window starts at the first device activity")
        mark = min((s for s, _, _ in dev), default=0)
        h_mark = h0
    w0 = mark + int((h0 - h_mark) * 1e9)
    w1 = mark + int((h1 - h_mark) * 1e9)
    by_name: Dict[str, float] = {}
    ivs = []
    for s, e, n in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ivs.append((s, e))
    ivs.sort()
    merged: List[List[int]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps, prev = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = h_mark + ((g0 + g1) / 2 - mark) / 1e9
        inner = [(t1 - t0, n) for t0, t1, n in spans if t0 <= mid <= t1]
        where = min(inner)[1] if inner else "host: outside the benchmark's spans"
        named.append((f"{where} @{(g0 - w0) / 1e9:.3f}s", (g1 - g0) / 1e9))
    return TraceSummary(window_s=h1 - h0, busy_s=busy, device_s_by_name=by_name,
                        idle_gaps=named)
