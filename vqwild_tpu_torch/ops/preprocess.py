"""Clip preprocessing: host crop/flip and YUV 4:2:0 packing, device normalize.

Counterpart of vqwild_tpu/ops/preprocess.py. Crop and flip are numpy
slicing on the host (``crop_clips_host``, ``crop_yuv420_host``), so the
cropped uint8 clip is what crosses to the device; ``normalize_clips`` and
``normalize_clips_yuv420`` are the device halves of the two wire formats.
The host functions are copies of the JAX package's, byte for byte in what
they return. ``preprocess_clips`` crops, flips and normalizes on the
device; as in the JAX package it is the reference entry point, not the
loader's path.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _channel_constant(values: np.ndarray, device) -> torch.Tensor:
    """fp32 ``values`` as a tensor on ``device``, made by fill kernels: a
    copy from pageable host memory would make the host wait for the card
    (twice a train step, for the mean and the inverse std)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in np.asarray(values, np.float32)])


def _normalize01(x: torch.Tensor, out_dtype) -> torch.Tensor:
    mean = _channel_constant(IMAGENET_MEAN, x.device)
    inv_std = _channel_constant(1.0 / IMAGENET_STD, x.device)
    return ((x - mean) * inv_std).to(out_dtype)


def normalize_clips(clips_u8: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., C] (already cropped/flipped) → ImageNet-normalized."""
    return _normalize01(clips_u8.float() * (1.0 / 255.0), out_dtype)


def crop_clips_device(frames: torch.Tensor, offsets, flips, size: int) -> torch.Tensor:
    """frames [B,T,H,W,C] → [B,T,size,size,C] (same dtype) on their device:
    clip b cropped at ``offsets[b]`` = (top, left) and, where ``flips[b]``,
    flipped along W; one crop and flip for all T frames of a clip. An offset
    is read as ``jax.lax.dynamic_slice`` reads a start index: a negative one
    counts from the end, then it is clamped so that the crop fits. One
    gather, no host synchronisation."""
    b, t, h, w, _ = frames.shape
    dev = frames.device
    off = torch.as_tensor(offsets, device=dev).long().reshape(b, 2)
    flip = torch.as_tensor(flips, device=dev).bool().reshape(b)
    top, left = off[:, 0], off[:, 1]
    top = torch.where(top < 0, top + h, top).clamp(0, h - size)
    left = torch.where(left < 0, left + w, left).clamp(0, w - size)
    ar = torch.arange(size, device=dev)
    rows = top[:, None] + ar  # [B, size]
    cols = left[:, None] + torch.where(flip[:, None], size - 1 - ar, ar)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ti = torch.arange(t, device=dev)[None, :, None, None]
    return frames[bi, ti, rows[:, None, :, None], cols[:, None, None, :]]


def preprocess_clips(frames, offsets, flips, size: int, out_dtype=torch.float32,
                     device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """frames [B,T,H,W,C] uint8, offsets [B,2] (top,left), flips [B] bool
    → [B,T,size,size,C] normalized, on the device of ``frames`` (a numpy
    ``frames`` goes to ``device`` first).

    The whole-clip crop/flip semantics match video_transforms.py: one
    parameterization applied to all T frames of a clip.
    """
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames)).to(resolve_device(device))
    return normalize_clips(crop_clips_device(frames, offsets, flips, size), out_dtype)


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


def yuv420_to_rgb_host(y_u8: np.ndarray, uv_u8: np.ndarray) -> np.ndarray:
    """Numpy mirror of the device conversion: (Y, UV) → RGB uint8.

    Nearest-neighbor chroma upsample + BT.601 full-range. Used by the packed
    YUV store's RGB-interface fallback and parity tests."""
    y = y_u8.astype(np.float32)
    uv = uv_u8.astype(np.float32) - 128.0
    uv = np.repeat(np.repeat(uv, 2, axis=-3), 2, axis=-2)
    cb, cr = uv[..., 0], uv[..., 1]
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def crop_yuv420_host(y: np.ndarray, uv: np.ndarray, offsets, flips, size: int):
    """Whole-clip crop+flip directly in YUV420 planes.

    y [B,T,H,W], uv [B,T,H/2,W/2,2] → cropped (y, uv) at ``size``. Crop
    offsets are rounded down to even so the chroma grid stays aligned (a
    ≤1-pixel shift vs the RGB path; ``size`` must be even)."""
    if size % 2:
        raise ValueError("YUV420 crop size must be even")
    b = y.shape[0]
    oy = np.empty((b, y.shape[1], size, size), y.dtype)
    ouv = np.empty((b, uv.shape[1], size // 2, size // 2, 2), uv.dtype)
    for i in range(b):
        top = (int(offsets[i][0]) // 2) * 2
        left = (int(offsets[i][1]) // 2) * 2
        cy = y[i, :, top : top + size, left : left + size]
        cuv = uv[i, :, top // 2 : top // 2 + size // 2, left // 2 : left // 2 + size // 2, :]
        if flips[i]:
            cy = cy[:, :, ::-1]
            cuv = cuv[:, :, ::-1, :]
        oy[i] = cy
        ouv[i] = cuv
    return oy, ouv


def crop_clips_host(frames: np.ndarray, offsets, flips, size: int) -> np.ndarray:
    """Host crop+flip: [B,T,H,W,C] u8 + per-clip (top,left)/flip → [B,T,s,s,C] u8.

    Pure slicing — each clip is one contiguous-ish memcpy; runs inside loader
    threads (numpy releases the GIL)."""
    b = frames.shape[0]
    out = np.empty((b, frames.shape[1], size, size, frames.shape[4]), frames.dtype)
    for i in range(b):
        top, left = int(offsets[i][0]), int(offsets[i][1])
        clip = frames[i, :, top : top + size, left : left + size, :]
        out[i] = clip[:, :, ::-1, :] if flips[i] else clip
    return out


def preprocess_host(frames: np.ndarray, offsets, flips, size: int) -> np.ndarray:
    """Numpy mirror for tests/parity."""
    from vqwild_tpu_torch.data import transforms

    out = []
    for clip, (top, left), flip in zip(frames, offsets, flips):
        p = transforms.CropParams(top=int(top), left=int(left), size=size, flip=bool(flip))
        out.append(transforms.normalize_imagenet(transforms.apply_crop(clip, p)))
    return np.stack(out, axis=0)
