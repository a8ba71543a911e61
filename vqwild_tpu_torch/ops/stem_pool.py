"""Kernel K2: the folded yuv-s2d stem (4x4/1 conv + bias + ReLU + 3x3/2
maxpool) in one pass, so the [N,H,W,64] pre-pool activation never reaches
device memory.

Counterpart of vqwild_tpu/ops/pallas_kernels.py ``stem_s2d_pool_pallas``;
the CUDA source and its design note are ``csrc/stem_pool.cu``.
``stem_s2d_pool`` launches the kernel on a CUDA tensor and runs the plain
PyTorch version, ``stem_s2d_pool_plain``, on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vqwild_tpu_torch.ops import _build

launches = _build.LaunchCount()

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


def _lib():
    lib = _build.load("stem_pool")
    fn = lib.stem_s2d_pool_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                n, h, wd, c, _DTYPES[x.dtype], stream)
    _build.check(rc, "stem_s2d_pool")
    launches.add()
    return out
