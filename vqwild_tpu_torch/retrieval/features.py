"""Feature extraction for the serving path.

Counterpart of vqwild_tpu/retrieval/features.py ``make_feat_fn`` (its
folded, single-device branch): the eval forward → per-frame embeddings
L2-normalized over the channel dim → numpy [B, C, T], the reference's
feat_func contract.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.models.fold import make_embed_fn
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F


def make_feat_fn(trunk: ResNet18F2F, *, wire: str = "rgb", dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda") -> Callable:
    """Returns f(clips [B,T,s,s,C] uint8-cropped or float) → np [B, C, T].

    ``wire="yuv420"`` returns f(y [B,T,s,s] u8, uv [B,T,s/2,s/2,2] u8)
    instead; the chroma upsample, BT.601 and normalize then fold into the
    space-to-depth stem (fold.stem_to_yuv_s2d), which runs as kernel K2.
    Both run the BN-folded trunk in ``dtype`` on ``device``."""
    if wire not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire format {wire!r}")
    dev = resolve_device(device)
    fwd = make_embed_fn(trunk.state_dict(), dtype=dtype,
                        stem_mode="yuv_s2d" if wire == "yuv420" else "conv7", device=dev)

    def feat_fn(*arrays):
        tensors = [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]
        return fwd(*tensors).cpu().numpy()

    return feat_fn
