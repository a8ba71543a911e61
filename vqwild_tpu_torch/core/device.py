"""Device selection: every entry point runs on ``cuda`` unless the caller
asks for the CPU, and never falls back from one to the other."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` → torch.device; raises if a CUDA device is asked for and
    none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def disable_tf32() -> None:
    """Full-fp32 convs and matmuls: cuDNN runs fp32 convs in TF32 by default,
    which keeps ~3 decimal digits where the JAX reference computes at
    HIGHEST precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
