"""The program's recorder (vqwild_tpu_torch/core/profiling.py) as the
traced run's per-layer metrics read it.

The recorder is on only while a torch profiler records, so its last
session is the traced window: the steps, uploads and loader batches of the
window and nothing of set-up or of the reference's run after it. Device
markers are read on the host clock. A checkout whose program has no
recorder reads as nothing: every function here returns None or nothing,
and the metric is left out of the line.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

# the markers a train step records, in the order it records them
STEP_MARKERS = ("step.forward", "step.backward", "step.optimizer", "step.end")


def _profiling():
    try:
        from vqwild_tpu_torch.core import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "markers")):
        return None
    return profiling


def window_s(out) -> Optional[float]:
    """The traced window's seconds, or None without a trace."""
    if out.trace is None or not out.trace.window_s > 0:
        return None
    return out.trace.window_s


def durations(name: str) -> List[float]:
    """The seconds of each of the last session's ``name`` spans."""
    p = _profiling()
    if p is None:
        return []
    return [s.end - s.start for s in p.spans() if s.name == name]


def span_share(out, name: str) -> Optional[float]:
    """The ``name`` spans' seconds over the traced window, in %."""
    w, d = window_s(out), durations(name)
    if w is None or not d:
        return None
    return 100.0 * sum(d) / w


def steps() -> List[Dict[str, float]]:
    """Each train step's markers, {name: device time on the host clock}, in
    the order the host recorded them: a ``step.forward`` marker opens a
    step, the others belong to the step it opened."""
    p = _profiling()
    if p is None:
        return []
    out: List[Dict[str, float]] = []
    for m in sorted(p.markers(), key=lambda m: m.host):
        if m.name == STEP_MARKERS[0]:
            out.append({})
        elif m.name not in STEP_MARKERS or not out:
            continue
        out[-1][m.name] = m.device
    return out


def phase_ms(start: str, end: str) -> Optional[float]:
    """The median over the steps of the device ms from marker ``start`` to
    marker ``end``."""
    ms = [1e3 * (s[end] - s[start]) for s in steps() if start in s and end in s]
    return statistics.median(ms) if ms else None


def step_gap_s() -> Optional[float]:
    """The device seconds between one step's last marker and the next
    step's first, summed over the steps."""
    st = steps()
    gaps = [b[STEP_MARKERS[0]] - a[STEP_MARKERS[-1]] for a, b in zip(st, st[1:])
            if STEP_MARKERS[-1] in a]
    return sum(gaps) if gaps else None
