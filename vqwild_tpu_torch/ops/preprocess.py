"""Clip preprocessing: the device normalize of the two wire formats, and the
host RGB → YUV 4:2:0 conversion that makes the yuv420 planes.

Counterparts of vqwild_tpu/ops/preprocess.py ``normalize_clips``,
``normalize_clips_yuv420`` and ``rgb_to_yuv420_host`` (the last a copy).
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _normalize01(x: torch.Tensor, out_dtype) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    inv_std = torch.as_tensor(1.0 / IMAGENET_STD, device=x.device)
    return ((x - mean) * inv_std).to(out_dtype)


def normalize_clips(clips_u8: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., C] (already cropped/flipped) → ImageNet-normalized."""
    return _normalize01(clips_u8.float() * (1.0 / 255.0), out_dtype)


def normalize_clips_yuv420(y_u8: torch.Tensor, uv_u8: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """(Y [...,H,W], UV [...,H/2,W/2,2]) uint8 → [...,H,W,3] ImageNet-normalized:
    nearest-neighbour chroma upsample, BT.601 full-range → RGB clipped to
    [0,255], /255, normalize."""
    y = y_u8.float()
    uv = uv_u8.float() - 128.0
    uv = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    cb, cr = uv[..., 0], uv[..., 1]
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    x = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0) * (1.0 / 255.0)
    return _normalize01(x, out_dtype)


def rgb_to_yuv420_host(rgb_u8: np.ndarray):
    """[..., H, W, 3] uint8 → (Y [..., H, W], UV [..., H/2, W/2, 2]) uint8.

    H and W must be even. Chroma is the mean of each 2x2 block (the standard
    4:2:0 downsample); since the RGB→YUV map is linear, Cb/Cr are computed
    directly from the 2x2-block-mean RGB."""
    h, w = rgb_u8.shape[-3], rgb_u8.shape[-2]
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dims, got {h}x{w}")
    lead = rgb_u8.shape[:-3]
    r = rgb_u8[..., 0]
    g = rgb_u8[..., 1]
    b = rgb_u8[..., 2]
    # luma: one float32 plane, accumulated in place
    yf = np.multiply(r, np.float32(0.299), dtype=np.float32)
    yf += np.multiply(g, np.float32(0.587), dtype=np.float32)
    yf += np.multiply(b, np.float32(0.114), dtype=np.float32)
    np.rint(yf, out=yf)
    y = yf.astype(np.uint8)  # 0.299+0.587+0.114 = 1 → already in [0,255]
    # chroma from block-mean RGB (uint8 2x2 sums fit uint16)
    blk = rgb_u8.reshape(lead + (h // 2, 2, w // 2, 2, 3))
    s = blk.astype(np.uint16).sum(axis=-2, dtype=np.uint16).sum(axis=-3, dtype=np.uint16)
    rm = s[..., 0].astype(np.float32)
    gm = s[..., 1]
    bm = s[..., 2]
    q = np.float32(0.25)
    cb = np.multiply(rm, np.float32(-0.168736) * q, dtype=np.float32)
    cb += np.multiply(gm, np.float32(-0.331264) * q, dtype=np.float32)
    cb += np.multiply(bm, np.float32(0.5) * q, dtype=np.float32)
    cb += np.float32(128.0)
    cr = np.multiply(rm, np.float32(0.5) * q, dtype=np.float32)
    cr += np.multiply(gm, np.float32(-0.418688) * q, dtype=np.float32)
    cr += np.multiply(bm, np.float32(-0.081312) * q, dtype=np.float32)
    cr += np.float32(128.0)
    uv = np.empty(lead + (h // 2, w // 2, 2), np.uint8)
    np.clip(np.rint(cb, out=cb), 0, 255, out=cb)
    np.clip(np.rint(cr, out=cr), 0, 255, out=cr)
    uv[..., 0] = cb
    uv[..., 1] = cr
    return y, uv
