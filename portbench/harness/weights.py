"""Seeded weights, made on the device in a few large calls.

Every leaf of a layout (reference/arv.py) is drawn from one
``torch.Generator`` on the device: one draw for all leaves of a kind,
split afterwards. BN statistics, the BN affine terms and the visual memory
are made non-trivial, as in a model some way into its training, so that
every parameter the loss reaches has a gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make_state(layout: List[Tuple[str, tuple, str]], seed: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    by_kind: Dict[str, List[Tuple[str, tuple]]] = {}
    for key, shape, kind in layout:
        by_kind.setdefault(kind, []).append((key, shape))
    out: Dict[str, torch.Tensor] = {}
    for kind, leaves in by_kind.items():
        sizes = [math.prod(s) for _, s in leaves]
        total = sum(sizes)
        if kind == "count":
            flat = torch.zeros(total, dtype=torch.long, device=device)
        elif kind in ("conv", "memory", "bn_bias", "running_mean"):
            flat = torch.randn(total, generator=gen, device=device)
        else:
            flat = torch.rand(total, generator=gen, device=device)
        at = 0
        for (key, shape), n in zip(leaves, sizes):
            a = flat[at:at + n].view(shape)
            at += n
            if kind == "conv":  # Kaiming normal, fan_out
                a = a * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
            elif kind in ("linear", "linear_bias"):  # nn.Linear's uniform bound
                fan_in = shape[1] if kind == "linear" else shape[0]
                a = (2.0 * a - 1.0) / math.sqrt(fan_in)
            elif kind in ("bn_weight", "running_var"):
                a = 0.5 + a
            elif kind == "nl_bn_weight":
                a = 0.2 * a
            elif kind in ("bn_bias", "running_mean"):
                a = 0.1 * a
            elif kind == "memory":
                a = a / a.norm(dim=-1, keepdim=True)
            out[key] = a.contiguous()
    return {key: out[key] for key, _, _ in layout}
