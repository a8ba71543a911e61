"""TF32 rounding in plain PyTorch, shared by the CPU emulations of the
fp32 tensor-core kernels (``distance.pairwise_sq_l2_tf32_emulated``,
``stem_pool.stem_s2d_pool_tf32_emulated``, ``conv.conv_tf32_emulated``)."""

from __future__ import annotations

import torch


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (10 mantissa bits), round to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: half a TF32 ULP added to the magnitude,
    the low 13 bits cleared."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """``(hi, lo)`` with ``hi = tf32(v)`` and ``lo = tf32(v - hi)``: the two
    tensor-core operands that together carry v to ~2^-22 relative."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)
