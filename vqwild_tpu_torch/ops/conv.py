"""Kernel K3: the trunk's block convolutions in fp32 on the tensor cores,
forward, input gradient and weight gradient.

A bias-free 2D conv (square kernel up to 3x3, stride 1 or 2, zero padding,
channels in multiples of 32) as an implicit GEMM over NHWC activations in
three error-compensated TF32 passes: the precision of an fp32 conv, where
cuDNN with TF32 off runs the same conv on the CUDA cores. It replaces no
TPU kernel (the JAX package leaves convolutions to XLA); the CUDA source
and its design note are ``csrc/conv_igemm.cu``.

``conv2d`` launches the kernels on a CUDA fp32 tensor (a
``torch.autograd.Function`` whose forward and both gradients are kernel
launches) and runs the plain PyTorch version, ``conv2d_plain``
(``F.conv2d`` and its autograd), on a CPU tensor. Activations travel as
NCHW views with channels_last strides, i.e. NHWC storage, which the
kernels read and write without copies; a tensor that arrives in another
layout is made channels_last once (``relayouts`` counts them).
``conv_tf32_emulated`` repeats the kernels' split arithmetic in plain
PyTorch, in all three passes, for the tests.

Launches are counted per pass in ``launches`` and relayouts in
``relayouts`` (always) and, from the same call while the recorder is on,
as the counters ``conv.fwd``, ``conv.dgrad``, ``conv.wgrad`` and
``conv.relayout`` (``_build.OpCounters``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vqwild_tpu_torch.ops import _build
from vqwild_tpu_torch.ops.tf32 import split_sum

PASSES = ("fwd", "dgrad", "wgrad")
launches = _build.OpCounters("conv", PASSES)  # launches of each pass
relayouts = _build.OpCounters("conv", ("relayout",))  # inputs and gradients made channels_last

CHANNEL_MULTIPLE = 32  # the kernels' K tile: channels come in whole tiles
MAX_KERNEL = 3


def _w4(w: torch.Tensor) -> torch.Tensor:
    """The conv weight [O,I,kh,kw] of a [O,I,1,kh,kw] Conv3d-shaped one."""
    return w[:, :, 0] if w.dim() == 5 else w


def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """``F.conv2d(x, w, stride, padding)`` (w [O,I,kh,kw] or [O,I,1,kh,kw]),
    in x's dtype; its gradients are autograd's."""
    return F.conv2d(x, _w4(w).to(x.dtype), stride=stride, padding=padding)


class _Emulated(torch.autograd.Function):
    """The kernels' arithmetic on fp32 tensors: each pass a three-way split
    sum (``tf32.split_sum``) of the plain pass."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, passes):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, passes)
        return split_sum(lambda a, b: F.conv2d(a, b, stride=stride, padding=padding),
                          x, _w4(w), passes)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, passes = ctx.conf
        w4 = _w4(w)
        dx = split_sum(lambda a, b: torch.nn.grad.conv2d_input(
            x.shape, b, a, stride=stride, padding=padding), gy, w4, passes)
        dw = split_sum(lambda a, b: torch.nn.grad.conv2d_weight(
            b, w4.shape, a, stride=stride, padding=padding), gy, x, passes)
        return dx, dw.reshape(w.shape), None, None, None


def conv_tf32_emulated(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
                       passes: int = 3) -> torch.Tensor:
    """``conv2d_plain`` in fp32 with the kernels' arithmetic in the forward
    pass and in both gradients: each operand split into ``hi = tf32(v)`` and
    ``lo = tf32(v - hi)``, the pass taken as ``lo*hi + hi*lo + hi*hi``, each
    product exact and the sums in fp32. ``passes=1`` keeps only ``hi*hi``,
    plain TF32. Nothing on the training path calls this; the tests hold the
    split's accuracy with it."""
    return _Emulated.apply(x.float(), w.float(), stride, padding, passes)


def out_size(h: int, w: int, r: int, stride: int, padding: int) -> Tuple[int, int]:
    """The output's (P, Q) of an r x r conv over h x w."""
    return (h + 2 * padding - r) // stride + 1, (w + 2 * padding - r) // stride + 1


def geometry(x_shape, w_shape, stride: int, padding: int) -> Tuple[int, ...]:
    """(N, H, W, C, K, R) of a conv the kernels take: x [N,C,H,W], w
    [K,C,R,R] or [K,C,1,R,R], C and K multiples of CHANNEL_MULTIPLE, R at
    most MAX_KERNEL, stride 1 or 2, 0 <= padding < R, a non-empty output.
    Raises ValueError on any other."""
    if len(x_shape) != 4:
        raise ValueError(f"conv2d: x must be [N,C,H,W], got {tuple(x_shape)}")
    w4 = tuple(w_shape)
    if len(w4) == 5 and w4[2] == 1:
        w4 = w4[:2] + w4[3:]
    n, c, h, wd = (int(v) for v in x_shape)
    if len(w4) != 4 or w4[1] != c or w4[2] != w4[3]:
        raise ValueError(f"conv2d: weight {tuple(w_shape)} does not fit x {tuple(x_shape)} "
                         "(takes [K,C,R,R] or [K,C,1,R,R])")
    k, r = int(w4[0]), int(w4[2])
    if c % CHANNEL_MULTIPLE or k % CHANNEL_MULTIPLE:
        raise ValueError(f"conv2d: channels {c} -> {k} (the kernels take multiples of "
                         f"{CHANNEL_MULTIPLE})")
    if not 1 <= r <= MAX_KERNEL or stride not in (1, 2) or not 0 <= padding < r:
        raise ValueError(f"conv2d: kernel {r}x{r}, stride {stride}, padding {padding} "
                         f"(takes up to {MAX_KERNEL}x{MAX_KERNEL}, stride 1 or 2, "
                         "0 <= padding < kernel)")
    p, q = out_size(h, wd, r, stride, padding)
    if n < 1 or p < 1 or q < 1:
        raise ValueError(f"conv2d: empty output for x {tuple(x_shape)}")
    if max(n * h * wd * c, n * p * q * k) >= 2 ** 31:
        raise ValueError("conv2d: the kernels index in 32 bits")
    return n, h, wd, c, k, r


@functools.lru_cache(maxsize=1024)
def takes(w_shape, stride: int, padding: int) -> bool:
    """Whether the kernels take a conv of this weight shape (a tuple),
    stride and padding (the input's size aside)."""
    try:
        geometry((1, w_shape[1], 8, 8), w_shape, stride, padding)
    except ValueError:
        return False
    return True


_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = (_I,) + (_P,) * 4 + (_I,) * 8 + (_P,)  # 4 pointers, geo, stream
_SIGNATURES = {"conv_fwd_launch": _LAUNCH, "conv_dgrad_launch": _LAUNCH,
               "conv_wgrad_launch": _LAUNCH,
               # floats of scratch: the split count x the weight's size
               "conv_wgrad_workspace": (ctypes.c_long,) + (_I,) * 8}


def _lib():
    return _build.bind("conv_igemm", _SIGNATURES)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """The NHWC storage of an NCHW tensor, made channels_last first if it
    is not (counted)."""
    if not t.is_contiguous(memory_format=torch.channels_last):
        relayouts.count("relayout")
        t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


def forward_nhwc(xh: torch.Tensor, w: torch.Tensor, geo) -> torch.Tensor:
    """The forward kernel: xh [N,H,W,C] NHWC, w contiguous, ``geo`` =
    (N, H, W, C, K, R, stride, padding) → y [N,P,Q,K] NHWC. On the current
    device and stream."""
    n, h, wd, c, k, r, stride, padding = geo
    p, q = out_size(h, wd, r, stride, padding)
    y = torch.empty((n, p, q, k), dtype=xh.dtype, device=xh.device)
    wbuf = torch.empty(2 * w.numel(), dtype=xh.dtype, device=xh.device)
    _build.check(_lib().conv_fwd_launch(xh.data_ptr(), w.data_ptr(), y.data_ptr(),
                                        wbuf.data_ptr(), *geo, _build.stream(xh.device)),
                 "conv2d forward")
    launches.count("fwd")
    return y


def input_grad_nhwc(gyh: torch.Tensor, w: torch.Tensor, geo) -> torch.Tensor:
    """The input-gradient kernel: gyh [N,P,Q,K] NHWC → dx [N,H,W,C] NHWC."""
    n, h, wd, c = geo[:4]
    dx = torch.empty((n, h, wd, c), dtype=gyh.dtype, device=gyh.device)
    wbuf = torch.empty(2 * w.numel(), dtype=gyh.dtype, device=gyh.device)
    _build.check(_lib().conv_dgrad_launch(gyh.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                          wbuf.data_ptr(), *geo, _build.stream(gyh.device)),
                 "conv2d input gradient")
    launches.count("dgrad")
    return dx


def weight_grad(xh: torch.Tensor, gyh: torch.Tensor, w: torch.Tensor, geo) -> torch.Tensor:
    """The weight-gradient kernels (split sums, then their ordered
    reduction): xh [N,H,W,C], gyh [N,P,Q,K] NHWC → dw, shaped as w."""
    lib = _lib()
    dw = torch.empty_like(w)
    ws = torch.empty(_build.workspace("conv_igemm", "conv_wgrad_workspace", gyh.device.index,
                                      geo), dtype=gyh.dtype, device=gyh.device)
    _build.check(lib.conv_wgrad_launch(xh.data_ptr(), gyh.data_ptr(), dw.data_ptr(),
                                       ws.data_ptr(), *geo, _build.stream(gyh.device)),
                 "conv2d weight gradient")
    launches.count("wgrad")
    return dw


@functools.lru_cache(maxsize=1024)
def _launch_geometry(x_shape, w_shape, stride: int, padding: int) -> Tuple[int, ...]:
    """``geometry`` and the stride and padding: the launchers' last eight
    arguments (one Python evaluation per shape)."""
    return geometry(x_shape, w_shape, stride, padding) + (stride, padding)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, geo):
        xh = _nhwc(x)
        with _build.on(x.device):
            y = forward_nhwc(xh, w, geo)
        ctx.save_for_backward(xh, w)
        ctx.geo = geo
        return y.permute(0, 3, 1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        xh, w = ctx.saved_tensors
        gyh = _nhwc(gy)
        dx = dw = None
        with _build.on(gy.device):
            if ctx.needs_input_grad[0]:
                dx = input_grad_nhwc(gyh, w, ctx.geo).permute(0, 3, 1, 2)
            if ctx.needs_input_grad[1]:
                dw = weight_grad(xh, gyh, w, ctx.geo)
        return dx, dw, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Bias-free conv of x [N,C,H,W] by w [K,C,R,R] or [K,C,1,R,R] →
    [N,K,P,Q], differentiable in x and w.

    A CPU tensor (float32 or float64) runs ``conv2d_plain``. A CUDA fp32
    tensor launches the kernels on the current stream (the output is
    channels_last) or raises on anything they do not take."""
    if x.device.type == "cpu":
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"conv2d: dtype {x.dtype} on the CPU (takes float32, float64)")
        return conv2d_plain(x, w, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: unsupported device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv2d: dtypes {x.dtype}, {w.dtype} on the card (takes float32)")
    if w.device != x.device:
        raise ValueError(f"conv2d: x on {x.device}, weight on {w.device}")
    if not w.is_contiguous():
        raise ValueError("conv2d: the weight must be contiguous")
    return _Conv.apply(x, w, _launch_geometry(tuple(x.shape), tuple(w.shape), stride, padding))
