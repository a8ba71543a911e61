"""The training step.

Counterpart of vqwild_tpu/train/step.py. Per-method loss assembly mirrors
the reference train loops (main.py:332-531):
  baseline: CE(classifier logits)
  va:       CE(non-local logits) + CE(register logits)
  vasa:     + CE(word logits)
all with targets expanded per clip (anchor, positive, negative → 3 labels
per triplet, main.py:348-359), CE in fp32.

The optimizer is torch's own Adam(betas (0.9, 0.999), eps 1e-8) or SGD
(momentum, dampening 0, no Nesterov), with L2 decay added to the gradient
before the moments: the semantics the JAX package's optax chain reproduces.
The lr steps ×0.1 once ``updates_per_epoch · lr_decay_epoch`` optimizer
updates are done (main.py:176-191). With ``accum_grad = k`` the gradients
are averaged over k calls (the running mean of ``optax.MultiSteps``) and the
optimizer steps on the k-th; BN statistics and the EMA memory advance on
every call. Every parameter takes part in every update, a parameter that no
loss reaches with a zero gradient, as under optax (weight decay still
moves it).

The step consumes cropped uint8 clips (``rgb``) or cropped 4:2:0 planes
(``yuv420``) and normalizes them on the device (ops/preprocess.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqwild_tpu_torch.models.arv import ARVModel
from vqwild_tpu_torch.ops.preprocess import normalize_clips, normalize_clips_yuv420


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What ``make_optimizer`` returns: torch's optimizer is built on the
    model's parameters by ``create_train_state``."""

    name: str  # "adam" | "sgd"
    init_lr: float
    weight_decay: float
    momentum: float
    decay_at: int  # optimizer updates after which the lr is scaled
    decay_factor: float
    accum_grad: int

    def build(self, params) -> torch.optim.Optimizer:
        if self.name == "adam":
            return torch.optim.Adam(params, lr=self.init_lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.weight_decay)
        return torch.optim.SGD(params, lr=self.init_lr, momentum=self.momentum, dampening=0.0,
                               nesterov=False, weight_decay=self.weight_decay)

    def lr(self, updates: int) -> float:
        """optax.piecewise_constant_schedule at update count ``updates``."""
        return self.init_lr * (self.decay_factor if updates >= self.decay_at else 1.0)


def make_optimizer(init_lr: float, weight_decay: float, steps_per_epoch: int,
                   lr_decay_epoch: int, lr_decay_factor: float = 0.1, accum_grad: int = 1,
                   optimizer: str = "adam", momentum: float = 0.9) -> OptimizerConfig:
    """``optimizer`` mirrors the reference's adam|sgd switch (main.py:553-567)."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"invalid optimizer {optimizer!r} (adam|sgd)")
    accum_grad = max(1, accum_grad)
    # the decay boundary counts optimizer updates, one per accum_grad calls
    updates_per_epoch = max(1, steps_per_epoch // accum_grad)
    return OptimizerConfig(optimizer, init_lr, weight_decay, momentum,
                     updates_per_epoch * lr_decay_epoch, lr_decay_factor, accum_grad)


@dataclasses.dataclass
class TrainState:
    """The model (parameters, BN statistics, visual memory), torch's
    optimizer, the calls done (``step``), the running mean of the pending
    calls' gradients under ``accum_grad`` and the dropout generator (on the
    model's device; JAX's ``dropout_rng``). A step updates it in place."""

    step: int
    model: ARVModel
    optimizer: torch.optim.Optimizer
    tx: OptimizerConfig
    generator: torch.Generator
    grad_acc: Optional[List[torch.Tensor]] = None

    @property
    def accum_count(self) -> int:
        """Calls since the last optimizer update."""
        return self.step % self.tx.accum_grad

    @property
    def updates(self) -> int:
        """Optimizer updates done."""
        return self.step // self.tx.accum_grad


def create_train_state(model: ARVModel, tx: OptimizerConfig, seed: int = 0) -> TrainState:
    dev = next(model.parameters()).device
    return TrainState(step=0, model=model, optimizer=tx.build(model.parameters()), tx=tx,
                      generator=torch.Generator(device=dev).manual_seed(seed))


def _optimizer_update(state: TrainState, grads: List[torch.Tensor]) -> None:
    """One call's gradients into the running mean; the optimizer steps on
    the ``accum_grad``-th call with the mean and the scheduled lr."""
    k, n = state.tx.accum_grad, state.accum_count
    if k > 1:
        if state.grad_acc is None:
            state.grad_acc = [torch.zeros_like(g) for g in grads]
        for acc, g in zip(state.grad_acc, grads):
            acc.add_((g - acc) / (n + 1))
        if n + 1 < k:
            return
        grads, state.grad_acc = state.grad_acc, None
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p, g in zip(params, grads):
        p.grad = g
    for group in state.optimizer.param_groups:
        group["lr"] = state.tx.lr(state.updates)
    state.optimizer.step()
    for p in params:
        p.grad = None


def make_train_step(model: ARVModel, tx: OptimizerConfig, semantic_memory=None,
                    ranking_weight: float = 0.0, triplet_margin: float = 1.0,
                    wire: str = "rgb") -> Callable:
    """Returns ``step(state, *wire_arrays, labels, weights=None) → (state,
    losses)``: rgb wire (clips_u8 [B,T,s,s,C], labels [B]); yuv420 wire
    (y_u8 [B,T,s,s], uv_u8 [B,T,s/2,s/2,2], labels [B]). Arrays may be
    numpy or tensors; they go to the model's device. ``losses`` are 0-d
    tensors on the device (no host wait): ``ce_loss``, per method
    ``reg_loss``/``word_loss``, ``ranking_loss`` if ``ranking_weight > 0``,
    and ``loss``.

    ``weights`` (0/1 per row): padded rows carry weight 0; losses become
    weighted means and the EMA memory skips them (BN batch statistics still
    see them, as in the JAX step). ``ranking_weight > 0`` adds a triplet
    ranking loss over the (anchor, positive, negative) rows of whole
    triplets, each weighted by its members' least weight."""
    if wire not in ("rgb", "yuv420"):
        raise ValueError(f"unknown wire format {wire!r}")
    method = model.method
    dev = next(model.parameters()).device
    sem = None if semantic_memory is None else torch.as_tensor(
        np.asarray(semantic_memory, np.float32)).to(dev)

    def to_dev(a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(dev, dtype=dtype, non_blocking=True)

    def step_fn(state: TrainState, *wire_and_labels, weights=None):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        *wire_arrays, labels = wire_and_labels
        labels = to_dev(labels, torch.long)
        w = None if weights is None else to_dev(weights, torch.float32)
        arrays = [to_dev(a) for a in wire_arrays]
        if wire == "yuv420":
            clips = normalize_clips_yuv420(*arrays, out_dtype=model.dtype)
        else:
            clips = normalize_clips(*arrays, out_dtype=model.dtype)
        out = model(clips, targets=labels, semantic_memory=sem, train=True, sample_weights=w,
                    generator=state.generator)

        def wmean(per_row):
            if w is None:
                return per_row.mean()
            return (per_row * w).sum() / torch.clamp_min(w.sum(), 1.0)

        def xent(logits):
            # CE in fp32 whatever the compute dtype
            return wmean(F.cross_entropy(logits.float(), labels, reduction="none"))

        if method == "baseline":
            losses = {"ce_loss": xent(out.logits)}
        else:
            losses = {"ce_loss": xent(out.nled_logits), "reg_loss": xent(out.reg_logits)}
            if method == "vasa":
                losses["word_loss"] = xent(out.word_logits)
        total = sum(losses.values())
        if ranking_weight > 0.0:
            # padded rows sit at the tail: truncate to whole triplets
            n3 = (out.clip_embed.shape[0] // 3) * 3
            e = out.clip_embed[:n3].reshape(-1, 3, out.clip_embed.shape[-1])
            d_ap = torch.sum((e[:, 0] - e[:, 1]) ** 2, dim=-1)
            d_an = torch.sum((e[:, 0] - e[:, 2]) ** 2, dim=-1)
            per_triplet = torch.relu(d_ap - d_an + triplet_margin)
            if w is None:
                rank_loss = per_triplet.mean()
            else:
                w3 = w[:n3].reshape(-1, 3).amin(dim=1)
                rank_loss = (per_triplet * w3).sum() / torch.clamp_min(w3.sum(), 1.0)
            losses["ranking_loss"] = rank_loss
            total = total + ranking_weight * rank_loss
        losses["loss"] = total

        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        _optimizer_update(state, [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(params, grads)])
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    return step_fn


def make_scanned_train_step(model: ARVModel, tx: OptimizerConfig, semantic_memory=None,
                            ranking_weight: float = 0.0, triplet_margin: float = 1.0,
                            wire: str = "rgb") -> Callable:
    """K train steps a call (JAX's ``lax.scan`` window, here K eager steps).

    Returned fn: ``(state, *wire_arrays, labels, weights=None)`` where every
    array has a leading axis [K, ...]; returns ``(state, losses)`` with each
    loss stacked [K] (the per-step trajectory)."""
    step_fn = make_train_step(model, tx, semantic_memory=semantic_memory,
                              ranking_weight=ranking_weight, triplet_margin=triplet_margin,
                              wire=wire)

    def scanned(state: TrainState, *wire_and_labels, weights=None):
        per_step = []
        for i in range(len(wire_and_labels[-1])):
            state, losses = step_fn(state, *(a[i] for a in wire_and_labels),
                                    weights=None if weights is None else weights[i])
            per_step.append(losses)
        return state, {k: torch.stack([ls[k] for ls in per_step]) for k in per_step[0]}

    return scanned
