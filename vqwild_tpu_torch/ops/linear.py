"""Kernel K4: the TimeSformer trunk's linears in fp32 on the tensor cores,
forward, input gradient and weight gradient.

``y = x Wᵀ + b`` for x [..., K] and W [N, K] (K and N multiples of 32) in
three error-compensated TF32 products: the precision of an fp32 matrix
product, where cuBLAS with TF32 off runs the same product on the CUDA
cores. It replaces no TPU kernel (the JAX package leaves its matrix
products to XLA); the CUDA source and its design note are
``csrc/linear_gemm.cu``.

``linear`` launches the kernels on a CUDA fp32 tensor (a
``torch.autograd.Function`` whose forward and both gradients are kernel
launches; the bias gradient comes with the weight gradient) and runs the
plain PyTorch version, ``linear_plain`` (``F.linear`` and its autograd), on
a CPU tensor. The kernels read x's rows as they lie: an input, a gradient,
a weight or a bias that is not contiguous (or not 16-byte aligned) is
copied once (``relayouts`` counts them). ``linear_tf32_emulated`` repeats
the kernels' split arithmetic in plain PyTorch, in all three passes, for
the tests.

Launches are counted per pass in ``launches`` and copies in
``relayouts`` (always) and, from the same call while the recorder is on,
as the counters ``linear.fwd``, ``linear.dgrad``, ``linear.wgrad``,
``linear.relayout`` and ``linear.flop`` (2·M·N·K of each launch, from the
shapes launched) (``_build.OpCounters``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vqwild_tpu_torch.ops import _build
from vqwild_tpu_torch.ops.tf32 import split_sum

PASSES = ("fwd", "dgrad", "wgrad")
launches = _build.OpCounters("linear", PASSES)  # launches of each pass
relayouts = _build.OpCounters("linear", ("relayout",))  # operands copied to aligned rows

WIDTH_MULTIPLE = 32  # the kernels' K tile: K and N come in whole tiles


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)``; its gradients are autograd's."""
    return F.linear(x, weight, bias)


class _Emulated(torch.autograd.Function):
    """The kernels' arithmetic on fp32 tensors: each pass a three-way split
    sum (``tf32.split_sum``) of the plain pass; the bias and its gradient plain."""

    @staticmethod
    def forward(ctx, x, w, b, passes):
        ctx.save_for_backward(x, w)
        ctx.passes = passes
        ctx.has_bias = b is not None
        y = split_sum(lambda u, v: u @ v.t(), x.reshape(-1, x.shape[-1]), w, passes)
        if b is not None:
            y = y + b
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2 = gy.reshape(-1, w.shape[0])
        dx = split_sum(lambda u, v: u @ v, g2, w, ctx.passes).view(x.shape)
        dw = split_sum(lambda u, v: u.t() @ v, g2, x2, ctx.passes)
        db = g2.sum(0) if ctx.has_bias else None
        return dx, dw, db, None


def linear_tf32_emulated(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, passes: int = 3) -> torch.Tensor:
    """``linear_plain`` in fp32 with the kernels' arithmetic in the forward
    pass and in both gradients: each operand split into ``hi = tf32(v)`` and
    ``lo = tf32(v - hi)``, the product taken as ``lo*hi + hi*lo + hi*hi``,
    each product exact and the sums in fp32. ``passes=1`` keeps only
    ``hi*hi``, plain TF32. Nothing on the training path calls this; the tests
    hold the split's accuracy with it."""
    return _Emulated.apply(x.float(), weight.float(), None if bias is None else bias.float(),
                           passes)


def geometry(x_shape, w_shape, b_shape=None) -> Tuple[int, int, int]:
    """(M, N, K) of a product the kernels take: x [..., K] with M rows in
    all, w [N, K], bias [N] or none, K and N multiples of WIDTH_MULTIPLE, M
    at least 1. Raises ValueError on any other."""
    if len(x_shape) < 1 or len(w_shape) != 2 or int(x_shape[-1]) != int(w_shape[1]):
        raise ValueError(f"linear: weight {tuple(w_shape)} does not fit x {tuple(x_shape)} "
                         "(takes x [..., K], weight [N, K])")
    n, k = int(w_shape[0]), int(w_shape[1])
    if b_shape is not None and tuple(b_shape) != (n,):
        raise ValueError(f"linear: bias {tuple(b_shape)} for {n} outputs")
    if n % WIDTH_MULTIPLE or k % WIDTH_MULTIPLE:
        raise ValueError(f"linear: widths {k} -> {n} (the kernels take multiples of "
                         f"{WIDTH_MULTIPLE})")
    m = 1
    for d in x_shape[:-1]:
        m *= int(d)
    if m < 1:
        raise ValueError(f"linear: no rows in x {tuple(x_shape)}")
    if max(m * k, m * n, n * k) >= 2 ** 31:
        raise ValueError("linear: the kernels index rows in 32 bits")
    return m, n, k


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"linear_fwd_launch": (_I,) + (_P,) * 5 + (_I,) * 3 + (_P,),
               "linear_dgrad_launch": (_I,) + (_P,) * 4 + (_I,) * 3 + (_P,),
               "linear_wgrad_launch": (_I,) + (_P,) * 5 + (_I,) * 3 + (_P,),
               # floats of scratch: the split count x the weight's and the bias's size
               "linear_wgrad_workspace": (ctypes.c_long,) + (_I,) * 3}


def _lib():
    return _build.bind("linear_gemm", _SIGNATURES)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, copied first if it is not contiguous or not 16-byte aligned
    (counted)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        relayouts.count("relayout")
        t = t.contiguous() if not t.is_contiguous() else t.clone()
    return t


def forward_rows(x2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], geo) -> torch.Tensor:
    """The forward kernel: x2 [M, K] rows, w [N, K] and b [N] (or None)
    contiguous → y [M, N]. On the current device and stream."""
    m, n, k = geo
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    wbuf = torch.empty(2 * w.numel(), dtype=x2.dtype, device=x2.device)
    _build.check(_lib().linear_fwd_launch(x2.data_ptr(), w.data_ptr(),
                                          None if b is None else b.data_ptr(), y.data_ptr(),
                                          wbuf.data_ptr(), m, n, k, _build.stream(x2.device)),
                 "linear forward")
    launches.count("fwd", 2 * m * n * k)
    return y


def input_grad_rows(g2: torch.Tensor, w: torch.Tensor, geo) -> torch.Tensor:
    """The input-gradient kernel: g2 [M, N] rows → dx [M, K]."""
    m, n, k = geo
    dx = torch.empty((m, k), dtype=g2.dtype, device=g2.device)
    wbuf = torch.empty(2 * w.numel(), dtype=g2.dtype, device=g2.device)
    _build.check(_lib().linear_dgrad_launch(g2.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                            wbuf.data_ptr(), m, n, k, _build.stream(g2.device)),
                 "linear input gradient")
    launches.count("dgrad", 2 * m * n * k)
    return dx


def weight_grad(x2: torch.Tensor, g2: torch.Tensor, geo,
                bias: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The weight-gradient kernels (split sums, then their ordered
    reduction): x2 [M, K], g2 [M, N] rows → (dw [N, K], db [N] where
    ``bias``, else None)."""
    m, n, k = geo
    lib = _lib()
    dw = torch.empty((n, k), dtype=g2.dtype, device=g2.device)
    db = torch.empty((n,), dtype=g2.dtype, device=g2.device) if bias else None
    ws = torch.empty(_build.workspace("linear_gemm", "linear_wgrad_workspace", g2.device.index,
                                      geo), dtype=g2.dtype, device=g2.device)
    _build.check(lib.linear_wgrad_launch(x2.data_ptr(), g2.data_ptr(), dw.data_ptr(),
                                         None if db is None else db.data_ptr(),
                                         ws.data_ptr(), m, n, k, _build.stream(g2.device)),
                 "linear weight gradient")
    launches.count("wgrad", 2 * m * n * k)
    return dw, db


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, geo):
        x2 = _aligned(x).view(-1, geo[2])
        with _build.on(x.device):
            y = forward_rows(x2, w, b, geo)
        ctx.save_for_backward(x2, w)
        ctx.geo, ctx.x_shape, ctx.has_bias = geo, x.shape, b is not None
        return y.view(*x.shape[:-1], geo[1])

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        g2 = _aligned(gy).view(-1, ctx.geo[1])
        dx = dw = db = None
        with _build.on(gy.device):
            if ctx.needs_input_grad[0]:
                dx = input_grad_rows(g2, w, ctx.geo).view(ctx.x_shape)
            if ctx.needs_input_grad[1] or (ctx.has_bias and ctx.needs_input_grad[2]):
                dw, db = weight_grad(x2, g2, ctx.geo, ctx.has_bias and ctx.needs_input_grad[2])
        return (dx, dw if ctx.needs_input_grad[1] else None, db, None)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x Wᵀ + b`` of x [..., K] by weight [N, K] and bias [N] (or None) →
    [..., N], differentiable in all three.

    A CPU tensor (float32 or float64) runs ``linear_plain``. A CUDA fp32
    tensor launches the kernels on the current stream or raises on anything
    they do not take."""
    if x.device.type == "cpu":
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"linear: dtype {x.dtype} on the CPU (takes float32, float64)")
        return linear_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear: unsupported device {x.device}")
    tensors = (x, weight) + (() if bias is None else (bias,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"linear: dtypes {[t.dtype for t in tensors]} on the card "
                        "(takes float32)")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"linear: x on {x.device}, weight or bias elsewhere")
    geo = geometry(tuple(x.shape), tuple(weight.shape),
                   None if bias is None else tuple(bias.shape))
    return _Linear.apply(x, _aligned(weight), None if bias is None else _aligned(bias), geo)
