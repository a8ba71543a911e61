"""Model/optimizer introspection tables (reference misc_utils/utils_torch.py).

Counterpart of vqwild_tpu/core/summaries.py. ``model_summary`` tabulates
parameter shapes + totals (utils_torch.py:22-46) from the module's
``named_parameters()``, and counts its buffers (BN statistics, the visual
memory) as the JAX function counts its state entries; ``optimizer_summary``
reports the optimizer's hyperparameters (utils_torch.py:49-91 equivalent).
Both log through the structured logger.
"""

from __future__ import annotations

import torch

from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("summaries")


def model_summary(model: torch.nn.Module) -> int:
    """Log a parameter table; returns total parameter count."""
    total = 0
    log.info("%-64s %-20s %s", "parameter", "shape", "count")
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        log.info("%-64s %-20s %d", name, str(tuple(p.shape)), n)
    log.info("total parameters: %.3fM (%d)", total / 1e6, total)
    buffers = list(model.buffers())
    if buffers:
        stotal = sum(b.numel() for b in buffers)
        log.info("state entries: %d arrays, %.3fM values", len(buffers), stotal / 1e6)
    return total


def optimizer_summary(
    init_lr: float, weight_decay: float, lr_decay_epoch: int, accum_grad: int = 1
):
    log.info(
        "optimizer: Adam lr=%g (x0.1 @ epoch %d) weight_decay=%g accum_grad=%d",
        init_lr,
        lr_decay_epoch,
        weight_decay,
        accum_grad,
    )
