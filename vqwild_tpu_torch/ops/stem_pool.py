"""Kernel K2: the folded yuv-s2d stem (4x4/1 conv + bias + ReLU + 3x3/2
maxpool) in one pass, so the [N,H,W,64] pre-pool activation never reaches
device memory.

Counterpart of vqwild_tpu/ops/pallas_kernels.py ``stem_s2d_pool_pallas``;
the CUDA source and its design note are ``csrc/stem_pool.cu`` (an implicit
GEMM on the tensor cores: one bf16 pass, or three error-compensated TF32
passes for fp32). ``stem_s2d_pool`` launches the kernel on a CUDA tensor
and runs the plain PyTorch version, ``stem_s2d_pool_plain``, on a CPU
tensor. ``stem_s2d_pool_tf32_emulated`` repeats the fp32 kernel's split
arithmetic in plain PyTorch, for the tests. ``time_kernels.py`` beside
this module checks and times the kernel of a checkout on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vqwild_tpu_torch.ops import _build
from vqwild_tpu_torch.ops.tf32 import split_sum

launches = _build.OpCounters("stem_pool", ("fwd",))  # launches of the kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stem_s2d_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,C], w [16C,64] ((i,j,c) rows of the HWIO kernel), b [64] →
    [N,H/2,W/2,64], all NHWC. The conv accumulates in fp32; the cast to
    x.dtype comes before the pool, which commutes with it."""
    n, h, wd, c = x.shape
    k = w.reshape(4, 4, c, -1).permute(3, 2, 0, 1).float()  # HWIO → OIHW
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2).float(), (2, 1, 2, 1)), k)
    y = torch.relu(y + b.float()[None, :, None, None]).to(x.dtype)
    y = F.max_pool2d(y, 3, 2, padding=1)  # implicit -inf padding, as flax's
    return y.permute(0, 2, 3, 1).contiguous()


def stem_s2d_pool_tf32_emulated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                passes: int = 3) -> torch.Tensor:
    """``stem_s2d_pool_plain`` with the fp32 kernel's arithmetic: x and w
    are split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, and the conv
    is ``x_lo*w_hi + x_hi*w_lo + x_hi*w_hi``, each product exact and the sums
    in fp32. ``passes=1`` keeps only ``x_hi*w_hi``, plain TF32. Nothing on
    the serving path calls this; the tests hold the split's accuracy with it."""
    c = x.shape[3]
    xf = F.pad(x.permute(0, 3, 1, 2).float(), (2, 1, 2, 1))
    k = w.reshape(4, 4, c, -1).permute(3, 2, 0, 1).float()  # HWIO → OIHW
    y = split_sum(F.conv2d, xf, k, passes)
    y = torch.relu(y + b.float()[None, :, None, None]).to(x.dtype)
    return F.max_pool2d(y, 3, 2, padding=1).permute(0, 2, 3, 1).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"stem_s2d_pool_launch": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)}


def _lib():
    return _build.bind("stem_pool", _SIGNATURES)


def stem_s2d_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,C] (H, W even), w [16C,64], b [64] → [N,H/2,W/2,64] NHWC.

    A CPU tensor runs ``stem_s2d_pool_plain``; a CUDA tensor launches the
    kernel on the current stream, or raises on anything it does not take."""
    if x.device.type == "cpu":
        return stem_s2d_pool_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"stem_s2d_pool: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"stem_s2d_pool: dtype {x.dtype} (takes float32, bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"stem_s2d_pool: x must be [N,H,W,C], got {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"stem_s2d_pool: H and W must be even, got {h}x{wd}")
    if tuple(w.shape) != (16 * c, 64) or tuple(b.shape) != (64,):
        raise ValueError(
            f"stem_s2d_pool: w must be [{16 * c},64] and b [64], got "
            f"{tuple(w.shape)} and {tuple(b.shape)}"
        )
    for t in (w, b):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("stem_s2d_pool: x, w and b must share dtype and device")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("stem_s2d_pool: x, w and b must be contiguous")
    out = torch.empty((n, h // 2, wd // 2, 64), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    fn = _lib().stem_s2d_pool_launch
    with _build.on(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, h, wd, c, _DTYPES[x.dtype], _build.stream(x.device))
    _build.check(rc, "stem_s2d_pool")
    launches.count("fwd")
    return out
