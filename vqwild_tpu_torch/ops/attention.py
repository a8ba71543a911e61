"""Kernel K5: multi-head self-attention over short sequences in fp32, on the
packed output of the qkv linear, forward and backward.

``attention(qkv, heads, scale)`` takes qkv [n, L, 3·D] as the qkv linear
writes it (each row's features in (3, heads, head_dim) order, D =
heads·head_dim) and returns o [n, L, D], each row's heads side by side, as
the output projection reads it: softmax(scale · q kᵀ) v for each (sequence,
head). Its gradient is one packed dqkv [n, L, 3·D], the qkv linear's output
gradient as it lies. It replaces no TPU kernel (the JAX package has no
TimeSformer); the CUDA source and its design note are
``csrc/short_attention.cu``.

A CUDA fp32 tensor launches the kernels (a ``torch.autograd.Function``:
the forward keeps qkv only, the backward recomputes the softmax) or raises
on a shape they do not take (``takes``: 1 <= L <= 16 and a head_dim that is
a multiple of 4 up to 128). A CPU tensor runs the plain PyTorch version,
``attention_plain`` (explicit products and softmax, and their autograd).
An input or gradient that is not contiguous, or not 16-byte aligned, is
copied first.

Launches are counted per pass in ``launches`` (always) and, from the same
call while the recorder is on, as the counters ``attention.fwd``,
``attention.bwd`` and ``attention.bytes``: the least bytes each launch
moves, from its shapes (forward qkv in and o out, backward qkv and dO in
and dqkv out; ``least_bytes``) (``_build.OpCounters``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from vqwild_tpu_torch.ops import _build

PASSES = ("fwd", "bwd")
launches = _build.OpCounters("attention", PASSES)

MAX_LENGTH = 16  # rows of a sequence the kernels hold in registers
MAX_HEAD_DIM = 128  # 32 lanes of four features


def takes(length: int, head_dim: int) -> bool:
    """Whether the kernels take sequences of ``length`` tokens and heads of
    ``head_dim`` features."""
    return 1 <= length <= MAX_LENGTH and 4 <= head_dim <= MAX_HEAD_DIM and head_dim % 4 == 0


def attention_plain(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The same function in plain PyTorch: qkv [n, L, 3·D] → o [n, L, D],
    softmax(scale · q kᵀ) v for each (sequence, head); its gradient is
    autograd's."""
    n, length, three_d = qkv.shape
    d = three_d // 3
    q, k, v = qkv.view(n, length, 3, heads, d // heads).unbind(2)  # [n, L, heads, hd]
    p = (torch.einsum("nihc,njhc->nhij", q, k) * scale).softmax(dim=-1)
    return torch.einsum("nhij,njhc->nihc", p, v).reshape(n, length, d)


def least_bytes(n: int, length: int, d: int, itemsize: int = 4) -> Tuple[int, int]:
    """(forward, backward) bytes a launch must move at least, each read or
    written once: qkv in and o out; qkv and dO in and dqkv out."""
    rows = n * length * itemsize
    return rows * (3 * d + d), rows * (3 * d + d + 3 * d)


def geometry(shape, heads: int) -> Tuple[int, int, int]:
    """(n, L, head_dim) of a packed qkv ``shape`` [n, L, 3·heads·head_dim]
    that the kernels take. Raises ValueError on any other."""
    if len(shape) != 3 or heads < 1 or shape[2] % (3 * heads):
        raise ValueError(f"attention: qkv {tuple(shape)} is not [n, L, 3·heads·head_dim] "
                         f"for {heads} heads")
    n, length, hd = int(shape[0]), int(shape[1]), int(shape[2]) // (3 * heads)
    if n < 1 or not takes(length, hd):
        raise ValueError(f"attention: {n} sequences of {length} tokens, head_dim {hd} (the "
                         f"kernels take 1 to {MAX_LENGTH} tokens and a head_dim that is a "
                         f"multiple of 4 up to {MAX_HEAD_DIM})")
    return n, length, hd


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"short_attention_fwd_launch": (_I, _P, _P) + (_I,) * 4 + (ctypes.c_float, _P),
               "short_attention_bwd_launch": (_I, _P, _P, _P) + (_I,) * 4
               + (ctypes.c_float, _P)}


def _lib():
    return _build.bind("short_attention", _SIGNATURES)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """t, copied first if it is not contiguous or not 16-byte aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def forward_rows(qkv: torch.Tensor, heads: int, scale: float, geo) -> torch.Tensor:
    """The forward kernel: packed contiguous qkv → o [n, L, D]. On the
    current device and stream."""
    n, length, hd = geo
    d = heads * hd
    out = torch.empty((n, length, d), dtype=qkv.dtype, device=qkv.device)
    _build.check(_lib().short_attention_fwd_launch(qkv.data_ptr(), out.data_ptr(), n, length,
                                                   heads, hd, scale, _build.stream(qkv.device)),
                 "attention forward")
    launches.count("fwd", nbytes=least_bytes(n, length, d)[0])
    return out


def backward_rows(qkv: torch.Tensor, dout: torch.Tensor, heads: int, scale: float,
                  geo) -> torch.Tensor:
    """The backward kernel: packed qkv and dO [n, L, D], both contiguous →
    dqkv [n, L, 3·D]."""
    n, length, hd = geo
    d = heads * hd
    dqkv = torch.empty_like(qkv)
    _build.check(_lib().short_attention_bwd_launch(qkv.data_ptr(), dout.data_ptr(),
                                                   dqkv.data_ptr(), n, length, heads, hd, scale,
                                                   _build.stream(qkv.device)),
                 "attention backward")
    launches.count("bwd", nbytes=least_bytes(n, length, d)[1])
    return dqkv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, scale, geo):
        qkv = _packed(qkv)
        with _build.on(qkv.device):
            out = forward_rows(qkv, heads, scale, geo)
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.scale, ctx.geo = heads, scale, geo
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        with _build.on(qkv.device):
            dqkv = backward_rows(qkv, _packed(dout), ctx.heads, ctx.scale, ctx.geo)
        return dqkv, None, None, None


def attention(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """softmax(scale · q kᵀ) v of a packed qkv [n, L, 3·D] over ``heads``
    heads → o [n, L, D], differentiable in qkv.

    A CPU tensor (float32 or float64) runs ``attention_plain``. A CUDA fp32
    tensor launches the kernels on the current stream or raises on anything
    they do not take."""
    if qkv.device.type == "cpu":
        if qkv.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"attention: dtype {qkv.dtype} on the CPU (takes float32, float64)")
        return attention_plain(qkv, heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {qkv.device}")
    if qkv.dtype != torch.float32:
        raise TypeError(f"attention: dtype {qkv.dtype} on the card (takes float32)")
    geo = geometry(tuple(qkv.shape), heads)
    return _Attention.apply(qkv, heads, float(scale), geo)
