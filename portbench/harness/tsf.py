"""The TimeSformer trunk's records (vqwild_tpu_torch/models/timesformer.py)
as the traced run's per-layer metrics read them, from the program's
recorder (core/profiling.py) over the traced window.

The trunk marks the device at the start of each block's temporal, spatial
and MLP parts (``tsf.temporal``, ``tsf.spatial``, ``tsf.mlp``) and after
its final norm (``tsf.end``). A part's device time is from its marker to
the next of the trunk's markers. A program without the trunk, or without a
recorder, reads as nothing: every function returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from portbench.harness import recorder

PARTS = ("tsf.temporal", "tsf.spatial", "tsf.mlp")
END = "tsf.end"


def forwards() -> List[Dict[str, float]]:
    """Each forward's device seconds by part, summed over its blocks: the
    markers in the order the host recorded them, a ``step.forward`` marker
    opening a step; a forward counts when its ``tsf.end`` was seen."""
    p = recorder._profiling()
    if p is None:
        return []
    out, sums, last = [], None, None
    for m in sorted(p.markers(), key=lambda m: m.host):
        if m.name == recorder.STEP_MARKERS[0]:
            sums, last = {k: 0.0 for k in PARTS}, None
        elif sums is None or m.name not in PARTS + (END,):
            continue
        else:
            if last is not None:
                sums[last.name] += m.device - last.device
            if m.name == END:
                out.append(sums)
                sums, last = None, None
            else:
                last = m
    return out


def part_ms(part: str) -> Optional[float]:
    """The median over the window's forwards of ``part``'s device ms."""
    ms = [1e3 * f[part] for f in forwards()]
    return statistics.median(ms) if ms else None


def relayout_mb() -> Optional[float]:
    """The forward's layout copies (the ``tsf.relayout_bytes`` counter) per
    forward (``tsf.patch_embed`` span), in MB."""
    p = recorder._profiling()
    if p is None:
        return None
    nbytes = p.counters().get("tsf.relayout_bytes")
    n = sum(1 for s in p.spans() if s.name == "tsf.patch_embed")
    return nbytes / n / 1e6 if nbytes and n else None


def attention_calls() -> Optional[Dict[str, int]]:
    """The window's attention calls by kind (forward calls; each has its
    backward), or None."""
    p = recorder._profiling()
    if p is None:
        return None
    c = p.counters()
    calls = {k: c.get(f"tsf.attn.{k}", 0) for k in ("temporal", "spatial")}
    return calls if all(calls.values()) else None
