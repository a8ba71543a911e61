"""Retrieval-model heads: BatchNorm with torch's statistics, non-local
batch↔memory attention, semantic adaptor, memory-distance logits and the
sequential EMA memory update.

Counterpart of vqwild_tpu/models/heads.py (the reference's misc_utils/nl.py,
models/resnet18_va.py:154-202, models/resnet18_vasa.py:177-237). The JAX
package's ``dense_torch`` / ``torch_linear_init`` reproduce ``nn.Linear``'s
default init; here the layers are ``nn.Linear`` (and ``nn.Conv1d`` with a
kernel of 1, whose default init is the same) with that init as it is.

Compute dtype: every module takes ``dtype`` as the JAX module's ``dtype=``.
Parameters stay fp32 and are cast to it per call; BatchNorm takes its batch
statistics in fp32 and normalizes in the compute dtype. Where a bf16 and an
fp32 operand meet in a matmul, both go to the promoted type, as JAX does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.core import profiling


class TorchBatchNorm(nn.Module):
    """BatchNorm over dim 1 with torch's running-statistics semantics, the
    layout of the reference checkpoint (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``).

    ``train=True`` normalizes with the biased batch variance and updates
    ``running_var`` with the unbiased one (×n/(n−1), ``max(n−1, 1)``);
    ``momentum`` is torch's (new = (1−m)·old + m·batch; JAX's flax ``m`` is
    ``1 − momentum``). An fp32 input goes through ``F.batch_norm``, which has
    exactly these semantics; any other dtype goes through
    ``split_statistics``. On an H100 each is the faster of the two forward
    and backward on its own dtype (chip_smoke.py's ``train_choices`` line).
    ``train=False`` reads the running statistics and normalizes in the
    input's dtype.

    Under a ``mesh`` of more than one rank (parallel/mesh.py) the batch is
    the global one, as XLA computes it over a JAX mesh: ``cross_rank``."""

    def __init__(self, num_features: int, eps: float, momentum: float = 0.1,
                 weight_init: float = 1.0):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.full((num_features,), float(weight_init)))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None) -> torch.Tensor:
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not train:
            inv = (torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()).to(dt)
            return (x - self.running_mean.to(dt).view(shape)) * inv.view(shape) + self.bias.to(
                dt).view(shape)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        if mesh is not None and mesh.size > 1:
            return self.cross_rank(x, mesh)
        if dt == torch.float32 and n > 1:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                True, self.momentum, self.eps)
        return self.split_statistics(x)

    def split_statistics(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode as the JAX module computes it under ``dtype=bfloat16``:
        the statistics in fp32 or wider (``var_mean``), the running ones
        updated, and the normalization in the input's dtype. A bf16 step with
        ``F.batch_norm``, which normalizes in fp32 and rounds once, leaves
        the losses outside the bf16 step's tolerance against JAX
        (tests/test_torch_train_step.py::TestAgainstJax::test_bf16)."""
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        axes = [0] + list(range(2, x.dim()))
        var, mean = torch.var_mean(x.to(torch.promote_types(dt, torch.float32)), dim=axes,
                                   correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_((var * (n / max(n - 1, 1))).to(
                self.running_var.dtype), alpha=m)
        inv = (torch.rsqrt(var + self.eps) * self.weight).to(dt)
        return (x - mean.to(dt).view(shape)) * inv.view(shape) + self.bias.to(dt).view(shape)

    def cross_rank(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """Train mode over the global batch of ``mesh``'s ranks. Each rank's
        (count, mean, M2) in fp32 (``var_mean``) are gathered and combined
        in rank order with Chan's parallel formula, so every rank holds the
        same statistics; a sum of x and x² would lose digits to
        cancellation. The running variance takes the unbiased variance over
        the global count. ``_CrossRankNorm``'s backward sums the two
        per-channel gradient sums over the ranks. Normalizes in the input's
        dtype, as ``split_statistics`` does."""
        axes = [0] + list(range(2, x.dim()))
        n_local = x.numel() // x.shape[1]
        with torch.no_grad():
            var, mean = torch.var_mean(x.detach().to(torch.promote_types(x.dtype,
                                                                         torch.float32)),
                                       dim=axes, correction=0)
            local = torch.stack([torch.full_like(mean, float(n_local)), mean, var * n_local])
            parts = mesh.gather(local[None])  # [world, 3, C]
            count, mean, m2 = parts[0].unbind(0)
            for nb, mb, m2b in (p.unbind(0) for p in parts[1:]):
                total = count + nb
                delta = mb - mean
                mean = mean + delta * (nb / total)
                m2 = m2 + m2b + delta * delta * (count * nb / total)
                count = total
            n = float(count[0])
            var = m2 / n
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_((var * (n / max(n - 1, 1))).to(
                self.running_var.dtype), alpha=m)
        return _CrossRankNorm.apply(x, self.weight, self.bias, mean, torch.rsqrt(var + self.eps),
                                    n, mesh)


class _CrossRankNorm(torch.autograd.Function):
    """y = (x − μ)·γ/σ + β with μ, 1/σ those of the global batch of ``n``
    rows; the backward of batch normalization, its two per-channel sums
    (Σ dy and Σ dy·x̂) summed over the ranks for dx. γ's and β's gradients
    stay this rank's share: the step sums every gradient over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, mesh):
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.n, ctx.mesh = n, mesh
        inv = (invstd * weight).to(dt)
        return (x - mean.to(dt).view(shape)) * inv.view(shape) + bias.to(dt).view(shape)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = [0] + list(range(2, x.dim()))
        gf = g.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        sum_dy = gf.sum(dim=axes)
        sum_dy_xhat = (gf * xhat).sum(dim=axes)
        both = ctx.mesh.all_sum(torch.stack([sum_dy, sum_dy_xhat]))
        n = ctx.n
        dx = (weight * invstd / n).view(shape) * (
            n * gf - both[0].view(shape) - xhat * both[1].view(shape))
        return (dx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None,
                None, None, None)


def linear(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (``nn.Linear`` [O,I], or a kernel-1 ``nn.Conv1d`` [O,I,1])
    over the last dim of ``x``, input and parameters cast to ``dtype``."""
    w = layer.weight
    if w.dim() == 3:
        w = w[:, :, 0]
    return F.linear(x.to(dtype), w.to(dtype), layer.bias.to(dtype))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep where uniform < 1−p, scaled by 1/(1−p);
    the mask is drawn from ``generator`` (the global generator if None).
    Under a ``mesh`` of more than one rank the mask is drawn for the global
    batch (every rank's generator is in the same state) and each rank keeps
    its rows, so a step on W ranks draws what one process draws for the
    same batch."""
    if not train or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if mesh is not None and mesh.size > 1:
        n = x.shape[0]
        u = torch.rand((n * mesh.size,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)
        keep = u[mesh.rank * n:(mesh.rank + 1) * n] < (1.0 - p)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=axis, keepdim=True), eps)


def pairwise_l2(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Pairwise Euclidean distances ||a_i − b_j||₂ → [N, M], as the clamped
    expansion with its ``sqrt`` (JAX's value and gradient near zero; not
    ``torch.cdist``)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)[None, :]
    sq = torch.clamp_min(a2 + b2 - 2.0 * _matmul(a, b.T), 0.0)
    return torch.sqrt(sq + eps)


def memory_distance_logits(embed: torch.Tensor, memory: torch.Tensor,
                           temperature: float) -> torch.Tensor:
    """reg/word logits: −‖e − m‖₂ / τ per class (resnet18_va.py:172-184)."""
    return -pairwise_l2(embed, memory) / temperature


@torch.no_grad()
def ema_memory_update(memory: torch.Tensor, embeds: torch.Tensor, targets: torch.Tensor,
                      mv: float, weights: Optional[torch.Tensor] = None,
                      mesh=None) -> torch.Tensor:
    """Sequential EMA visual-memory update (resnet18_va.py:186-192) into a
    new tensor: mem[y_i] = normalize(mv·mem[y_i] + (1−mv)·e_i) in batch
    order, so repeated labels compound. No gradient flows. ``weights`` (0/1
    per row) skips the rows whose weight is 0. Rows are indexed with length-1
    index tensors, so the loop never waits for the device. Under a ``mesh``
    the rows of every rank are gathered in global order and every rank runs
    the same loop over them, so the memory replicas stay bit-identical.
    Under a profiler it records the span ``heads.memory_update``."""
    with profiling.span("heads.memory_update"):
        mem = memory.clone()
        embeds = embeds.detach()
        if mesh is not None and mesh.size > 1:
            embeds = mesh.gather(embeds)
            targets = mesh.gather(targets)
            weights = None if weights is None else mesh.gather(weights)
        for i in range(embeds.shape[0]):
            y = targets[i : i + 1]
            old = mem.index_select(0, y)
            upd = l2_normalize(mv * old + (1.0 - mv) * embeds[i : i + 1], axis=-1)
            if weights is not None:
                upd = torch.where(weights[i : i + 1, None] > 0, upd, old)
            mem.index_copy_(0, y, upd.to(mem.dtype))
        return mem


def param_free_layernorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(x − mean) / (std + eps) over the last dim, torch-std (ddof=1)
    (nl.py:7-15)."""
    mean = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, correction=1)
    return (x - mean) / (std + eps)


class _NonLocal(nn.Module):
    """θ/φ/g and W as the reference's 1x1 Conv1d ([O, I, 1] weights, keys
    ``theta``, ``phi``, ``g``, ``W.0``) and ``W.1`` a BatchNorm that starts
    at γ = 0 (the block starts as the identity), eps 1e-5, torch momentum
    0.1, its variance free of the one-pass E[x²]−E[x]² cancellation (its
    rows are near-identical attention outputs): two-pass on the CPU,
    Welford on the card, ``var_mean`` in bf16."""

    def __init__(self, channels: int, inter_channels: int, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inter_channels = inter_channels
        self.dropout = dropout
        self.dtype = dtype
        self.theta = nn.Conv1d(channels, inter_channels, 1)
        self.phi = nn.Conv1d(channels, inter_channels, 1)
        self.g = nn.Conv1d(channels, inter_channels, 1)
        self.W = nn.Sequential(nn.Conv1d(inter_channels, channels, 1),
                               TorchBatchNorm(channels, 1e-5, 0.1, weight_init=0.0))

    def _attend(self, q: torch.Tensor, kv: torch.Tensor, train: bool,
                generator: Optional[torch.Generator], mesh=None) -> torch.Tensor:
        """q [..., N, C] attends kv [..., M, C] → the block's output + q."""
        dt = self.dtype
        theta = linear(self.theta, q, dt)
        phi = linear(self.phi, kv, dt)
        g = linear(self.g, kv, dt)
        attn = torch.softmax((theta @ phi.transpose(-1, -2)) / math.sqrt(self.inter_channels),
                             dim=-1)
        y = torch.relu(param_free_layernorm(attn @ g))
        y = linear(self.W[0], y, dt)
        c = y.shape[-1]
        y = self.W[1](y.reshape(-1, c), train, mesh).reshape(y.shape)
        return dropout(y, self.dropout, train, generator, mesh) + q


class NonLocal1D(_NonLocal):
    """Support-batch ↔ class-memory attention (nl.py:18-159): softmax(θ(x) ·
    φ(q)ᵀ / √C) · g(q), parameter-free LayerNorm, ReLU → W → BatchNorm
    (per-channel statistics over the N support rows) → dropout → + x."""

    def forward(self, x_support: torch.Tensor, query: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
        """``mesh``: the support rows are this rank's block of the global
        batch (the BatchNorm and the dropout mask are the global batch's)."""
        return self._attend(x_support, query, train, generator, mesh)


class NonLocalND(_NonLocal):
    """Self-attention over a channels-last feature map's positions
    ([B, *spatial, C]; the NONLocalBlock2D/3D wrappers, nl.py:161-184).
    ``sub_sample`` max-pools φ/g by 2 over the last two spatial dims (the
    temporal dim untouched, as the (1,2,2) 3D pool; by 2 over a 1D map)."""

    def __init__(self, channels: int, inter_channels: int, sub_sample: bool = False,
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__(channels, inter_channels, dropout, dtype)
        self.sub_sample = sub_sample

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        kv = x
        if self.sub_sample:
            nd = x.dim() - 2
            window = (1,) * (nd - 2) + (2, 2) if nd >= 2 else (2,)
            pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
            kv = pool(x.movedim(-1, 1), window, window).movedim(1, -1)
        out = self._attend(x.reshape(b, -1, c), kv.reshape(b, -1, c), train, generator)
        return out.reshape(x.shape)


class SemanticAdaptor(nn.Module):
    """MLP 512→640→768→896→semantic_dim with inner ReLUs
    (resnet18_vasa.py:75-89); ``in_dim`` is the trunk's width (512 for the
    reference's ResNet18-F2F)."""

    def __init__(self, semantic_dim: int, dtype: torch.dtype = torch.float32, in_dim: int = 512):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_dim, 640)
        self.fc2 = nn.Linear(640, 768)
        self.fc3 = nn.Linear(768, 896)
        self.fc4 = nn.Linear(896, semantic_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = torch.relu(linear(self.fc, x, dt))
        x = torch.relu(linear(self.fc2, x, dt))
        x = torch.relu(linear(self.fc3, x, dt))
        return linear(self.fc4, x, dt)
