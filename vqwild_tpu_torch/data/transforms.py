"""Whole-clip spatial transforms.

The reference applies one crop/flip parameterization to all T frames of a clip
(misc_utils/video_transforms.py). We split each transform into (a) a host-side
parameter sampler and (b) a pure apply function, so the *apply* step can run
either on host numpy or fused on device (see ops/preprocess.py): the loader
emits raw uint8 frames + crop offsets + flip flags, and normalization/crop
happen on the device.

ImageNet normalization constants are the ones baked into read_video
(utils_dataset.py:104-106).
"""

from __future__ import annotations

import dataclasses

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class CropParams:
    top: int
    left: int
    size: int
    flip: bool = False


def random_crop_params(
    rng: np.random.Generator, height: int, width: int, size: int, flip_prob: float = 0.0
) -> CropParams:
    """RandomCrop parameterization (video_transforms.py:9-49): uniform
    top/left such that the crop fits; one draw per clip."""
    if height < size or width < size:
        raise ValueError(f"frame {height}x{width} smaller than crop {size}")
    top = int(rng.integers(0, height - size + 1))
    left = int(rng.integers(0, width - size + 1))
    flip = bool(rng.random() < flip_prob) if flip_prob > 0 else False
    return CropParams(top=top, left=left, size=size, flip=flip)


def center_crop_params(height: int, width: int, size: int) -> CropParams:
    """CenterCrop parameterization (video_transforms.py:52-81): round-down
    center, matching ``int(round((h - size) / 2.))``."""
    top = int(round((height - size) / 2.0))
    left = int(round((width - size) / 2.0))
    return CropParams(top=top, left=left, size=size, flip=False)


def apply_crop(frames: np.ndarray, p: CropParams) -> np.ndarray:
    """frames [T,H,W,C] → [T,size,size,C]; optional horizontal flip."""
    out = frames[:, p.top : p.top + p.size, p.left : p.left + p.size, :]
    if p.flip:
        out = out[:, :, ::-1, :]
    return out


def normalize_imagenet(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 [.., C=3] → float32 normalized, ToTensor+Normalize semantics."""
    x = frames_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(frames: np.ndarray) -> np.ndarray:
    return frames * IMAGENET_STD + IMAGENET_MEAN


def scaled_resize(frames: np.ndarray, size: int) -> np.ndarray:
    """Per-frame bilinear resize to (size, size) — the reference's
    ScaledCenterCrop transform (video_transforms.py:109-121, unused by its
    main path; provided for capability parity). Uses cv2 when present,
    otherwise a numpy bilinear resize with cv2's half-pixel convention."""
    t, h, w, c = frames.shape
    try:
        import cv2

        return np.stack([cv2.resize(f, dsize=(size, size)) for f in frames])
    except ImportError:
        pass
    sy, sx = h / size, w / size
    ys = np.clip((np.arange(size) + 0.5) * sy - 0.5, 0, h - 1)
    xs = np.clip((np.arange(size) + 0.5) * sx - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    if frames.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(frames.dtype)
