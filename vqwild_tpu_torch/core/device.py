"""Device selection: every entry point runs on ``cuda`` unless the caller
asks for the CPU, and never falls back from one to the other."""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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


@contextlib.contextmanager
def cpu_seeded(seed: int) -> Iterator[None]:
    """Draws made inside come from the CPU generator seeded with ``seed``.
    The generator is forked, so torch's global CPU generator is left as it
    was, and no CUDA generator is touched (``torch.manual_seed`` would
    reseed them all)."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        yield
