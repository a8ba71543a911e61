"""TF32 rounding and the three-pass split sum in plain PyTorch, shared by
the CPU emulations of the fp32 tensor-core kernels
(``distance.pairwise_sq_l2_tf32_emulated``,
``stem_pool.stem_s2d_pool_tf32_emulated``, ``conv.conv_tf32_emulated``,
``linear.linear_tf32_emulated``)."""

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


def split_sum(fn, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``fn(a, b)`` bilinear, with a and b split by ``tf32_split``, as the
    kernels take it: ``(fn(a_lo, b_hi) + fn(a_hi, b_lo)) + fn(a_hi, b_hi)``,
    each product exact and the sums in fp32 (the dropped ``lo*lo`` term is
    ~2^-22 relative). ``passes=1`` keeps only ``fn(a_hi, b_hi)``, plain
    TF32."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    y = fn(a_hi, b_hi)
    if passes == 3:
        y = (fn(a_lo, b_hi) + fn(a_hi, b_lo)) + y
    return y
