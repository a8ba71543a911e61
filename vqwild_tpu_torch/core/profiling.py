"""Profiling: the in-program recorder, the operator's trace and the
evaluators' phase timings (counterpart of vqwild_tpu/core/profiling.py).

The recorder keeps spans, counters and device markers of one recording
session, on ``time.perf_counter``:

- ``span(name, id=None)``: a host interval with its parent (the thread's
  innermost open span), its thread, and an id that ties the spans of one
  unit of work (a span without one takes its parent's);
- ``count(name, n=1)``: a named counter;
- ``mark(name, id=None)``: a CUDA event on the current stream with the host
  time it was recorded at. ``begin(device)`` records an anchor event right
  after a synchronise, and the anchor's host time puts every marker's
  device time on the host clock. Markers are resolved without a wait
  (``settle``, where the program already waits) or when they are read.

It is on only while a torch profiler records (``trace`` below, or any
caller's ``torch.profiler.profile``): no flag of its own. Off, a span is one
flag read returning a shared no-op context, and a counter or a marker one
flag read. Each profiler's start begins a session and drops the last one's
records (a hook on torch's own ``_run_on_profiler_start``), so after a
profiler stops the records are its own until the next one starts. It opens
no range of the profiler's own: a traced window would count one as device
activity. A session keeps at most MAX_RECORDS spans and as many markers,
the newest.

``spans()``, ``counters()`` and ``markers()`` read the last session.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("profiling")

MAX_RECORDS = 1 << 17
TRACK_PID = 1 << 30  # the spans' own process in an exported trace


class Counter:
    """A count. Thread-safe: the HTTP handler threads launch kernels
    concurrently, and the loader's threads count batches."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.n += n

    def reset(self) -> None:
        with self._lock:
            self.n = 0


class Span(NamedTuple):
    name: str
    id: object
    start: float
    end: float
    parent: Optional[str]
    thread: int


class Marker(NamedTuple):
    name: str
    id: object
    host: float  # when the host recorded it
    device: float  # when the device reached it, on the host clock


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self):
        """A new session: the last one's records dropped."""
        with self.lock:
            self.spans = collections.deque(maxlen=MAX_RECORDS)
            self.pending = collections.deque(maxlen=MAX_RECORDS)
            self.markers = collections.deque(maxlen=MAX_RECORDS)
            self.counters: Dict[str, Counter] = {}
            self.anchor = None  # (event, host time, Unix ns read beside it)
            self.device = None

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def resolve(self, wait: bool):
        """Pending markers whose event the device reached (with ``wait``,
        every pending marker) onto the host clock."""
        with self.lock:
            if self.anchor is None:
                return
            ev0, host0, _ = self.anchor
            left = collections.deque(maxlen=MAX_RECORDS)
            for name, mid, host, ev in self.pending:
                if wait:
                    ev.synchronize()
                if ev.query():
                    self.markers.append(Marker(name, mid, host,
                                               host0 + ev0.elapsed_time(ev) / 1e3))
                else:
                    left.append((name, mid, host, ev))
            self.pending = left


_rec = _Recorder()
_torch_on_profiler_start = _autograd_profiler._run_on_profiler_start


def _on_profiler_start():
    _torch_on_profiler_start()
    _rec.reset()


_autograd_profiler._run_on_profiler_start = _on_profiler_start


class _Open:
    """A span the recorder records."""

    __slots__ = ("name", "id", "start", "parent", "stack")

    def __init__(self, name, sid):
        self.name, self.id = name, sid

    def __enter__(self):
        self.stack = _rec.stack()
        top = self.stack[-1] if self.stack else None
        self.parent = None if top is None else top.name
        if self.id is None and top is not None:
            self.id = top.id
        self.stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.stack[-1] is self:
            self.stack.pop()
        else:  # closed out of order
            self.stack.remove(self)
        _rec.spans.append(Span(self.name, self.id, self.start, end, self.parent,
                               threading.get_ident()))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, id=None):
    """A context manager that records ``name``'s interval while a profiler
    records; otherwise the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, id)


def add(name: str, start: float, end: float, id=None) -> None:
    """Record an interval the caller timed on ``time.perf_counter``."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _rec.stack()
    top = stack[-1] if stack else None
    if id is None and top is not None:
        id = top.id
    _rec.spans.append(Span(name, id, start, end, None if top is None else top.name,
                           threading.get_ident()))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the session's counter ``name``."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    c = _rec.counters.get(name)
    if c is None:
        with _rec.lock:
            c = _rec.counters.setdefault(name, Counter())
    c.add(n)


def begin(device=None) -> None:
    """Where the program may wait (the start of a training run, ``trace``):
    with a profiler recording, on a CUDA ``device``, record the session's
    marker anchor right after a synchronise, unless it has one."""
    if not _autograd_profiler._is_profiler_enabled or device is None:
        return
    device = torch.device(device)
    if device.type != "cuda" or _rec.anchor is not None:
        return
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    anchor = (ev, time.perf_counter(), time.time_ns())
    with _rec.lock:
        _rec.anchor, _rec.device = anchor, device


def mark(name: str, id=None) -> None:
    """A device marker on the current stream of the anchored device; a no-op
    with no profiler recording or no anchor (on the CPU there is none)."""
    if not _autograd_profiler._is_profiler_enabled or _rec.anchor is None:
        return
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(_rec.device))
    host = time.perf_counter()
    if id is None:
        stack = _rec.stack()
        id = stack[-1].id if stack else None
    with _rec.lock:
        _rec.pending.append((name, id, host, ev))


def settle() -> None:
    """Resolve the markers the device has reached, without waiting; called
    where the program already waits on the device."""
    _rec.resolve(wait=False)


def spans() -> List[Span]:
    """The last session's spans, in the order they ended."""
    return list(_rec.spans)


def counters() -> Dict[str, int]:
    """The last session's counters."""
    return {k: c.n for k, c in list(_rec.counters.items())}


def markers() -> List[Marker]:
    """The last session's markers, each resolved (this waits for the device
    to reach those it has not)."""
    _rec.resolve(wait=True)
    return list(_rec.markers)


@contextlib.contextmanager
def phase(timings: dict, key: str):
    """Accumulate wall time into ``timings[key]`` — the per-phase cost
    accounting behind the evaluators' ``.timings`` — and record it as the
    span ``key``."""
    t0 = time.perf_counter()
    try:
        with span(key):
            yield
    finally:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _track(base_ns: int) -> list:
    """The session's spans, resolved markers and counters (at the end) as
    Chrome-trace events of their own process, on the exported trace's
    clock: the anchor's host time and the Unix time read beside it map one
    clock onto the other."""
    if _rec.anchor is not None:
        _, host0, unix0 = _rec.anchor
    else:
        host0, unix0 = time.perf_counter(), time.time_ns()

    def us(t):
        return (unix0 - base_ns) / 1e3 + (t - host0) * 1e6

    events = [{"ph": "M", "name": "process_name", "pid": TRACK_PID,
               "args": {"name": "vqwild_tpu_torch spans"}},
              {"ph": "M", "name": "thread_name", "pid": TRACK_PID, "tid": 0,
               "args": {"name": "device markers"}}]
    for s in spans():
        events.append({"ph": "X", "name": s.name, "pid": TRACK_PID, "tid": s.thread,
                       "ts": us(s.start), "dur": (s.end - s.start) * 1e6,
                       "args": {"id": repr(s.id), "parent": s.parent}})
    for m in markers():
        events.append({"ph": "i", "s": "t", "name": m.name, "pid": TRACK_PID, "tid": 0,
                       "ts": us(m.device), "args": {"id": repr(m.id)}})
    end = us(time.perf_counter())
    for name, n in counters().items():
        events.append({"ph": "C", "name": name, "pid": TRACK_PID, "ts": end,
                       "args": {"value": n}})
    return events


@contextlib.contextmanager
def trace(run_dir: str, enabled: bool = True):
    """torch.profiler trace context; writes {run_dir}/profile/trace.json,
    with the recorder's spans, markers and counters as a process of their
    own."""
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
        begin(torch.device("cuda") if torch.cuda.is_available() else None)
        yield
    finally:
        settle()
        prof.stop()
        path = os.path.join(out, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"].extend(_track(int(doc.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(doc, f)
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
