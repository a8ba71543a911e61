"""The Video Swin trunk's records (vqwild_tpu_torch/models/swin3d.py) as the
traced run's per-layer metrics read them, from the program's recorder
(core/profiling.py) over the traced window.

The trunk marks the device at the start of each block's attention and MLP
parts (``swin.attn``, ``swin.mlp``), at the start of each merge
(``swin.merge``) and after its final norm (``swin.end``). A part's device
time is from its marker to the next of the trunk's markers. A program
without the trunk, or without a recorder, reads as nothing: every function
returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from portbench.harness import recorder

PARTS = ("swin.attn", "swin.mlp", "swin.merge")
END = "swin.end"
STAGES = ("s1", "s2", "s3", "s4")


def forwards() -> List[Dict[str, float]]:
    """Each forward's device seconds by part, summed over its blocks and
    merges: the markers in the order the host recorded them, a
    ``step.forward`` marker opening a step; a forward counts when its
    ``swin.end`` was seen."""
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
    """The forward's layout copies (the ``swin.relayout_bytes`` counter) per
    forward (``swin.patch_embed`` span), in MB."""
    p = recorder._profiling()
    if p is None:
        return None
    nbytes = p.counters().get("swin.relayout_bytes")
    n = sum(1 for s in p.spans() if s.name == "swin.patch_embed")
    return nbytes / n / 1e6 if nbytes and n else None


def attention_calls() -> Optional[Dict[str, int]]:
    """The window's window-attention calls by stage (forward calls, one a
    block; each has its backward), or None where none was counted."""
    p = recorder._profiling()
    if p is None:
        return None
    c = p.counters()
    calls = {s: c.get(f"swin.attn.{s}", 0) for s in STAGES}
    return calls if any(calls.values()) else None
