"""Deep-metric-learning loss zoo (reference misc_utils/metric_learning_loss.py).

Counterpart of vqwild_tpu/train/dml.py. Upstream vendors the Roth & Brattoli
DML library but never wires it into the active training path; it is kept
here as a loss library, as in the JAX package:

* **Samplers run on the host** (data-dependent index selection on detached
  embeddings): random / semihard / distance-weighted triplet samplers and
  the npair sampler, copies of the JAX package's numpy functions, return
  int32 index arrays. The same ``np.random.Generator`` state gives the same
  indices.
* **Losses are plain torch functions** of (embeddings, index arrays) on the
  embeddings' device, differentiable by autograd: batched gathers and
  reductions. The index arrays become ``long`` tensors on that device.
* Trainable extras (MarginLoss per-class β, ProxyNCA proxies, the
  cross-entropy head) are leaf tensors the caller's optimizer owns.

Semantics notes (vs upstream): TripletLoss uses *squared* L2 (FaceNet form,
:343-355); MarginLoss uses true L2 with 1e-8 under the sqrt and normalizes by
the count of active pairs (:524-566); ProxyNCA multiplies normalized
embeddings and proxies by 3 (:604-605); NPair adds an l2 weight penalty on
anchor+positive only (:421-431).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vqwild_tpu_torch.core.device import resolve_device

# --------------------------------------------------------------------------
# host-side samplers
# --------------------------------------------------------------------------


def _pdist(batch: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    prod = batch @ batch.T
    norm = np.diag(prod)[:, None]
    sq = np.clip(norm + norm.T - 2 * prod, 0, None)
    return np.sqrt(np.clip(sq, eps, None))


def random_triplets(
    batch: np.ndarray, labels: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """All valid (a,p,n) triples enumerated, then len(batch) sampled
    (metric_learning_loss.py:113-148)."""
    labels = np.asarray(labels)
    unique = np.unique(labels)
    indices = np.arange(len(labels))
    class_idx = {c: indices[labels == c] for c in unique}
    triplets = []
    for a_cls in unique:
        for n_cls in unique:
            if a_cls == n_cls:
                continue
            for a, p, n in itertools.product(
                class_idx[a_cls], class_idx[a_cls], class_idx[n_cls]
            ):
                if a != p:
                    triplets.append((a, p, n))
    if not triplets:
        raise ValueError("batch has no valid triplets")
    sel = rng.choice(len(triplets), size=len(labels), replace=len(triplets) < len(labels))
    return np.asarray([triplets[i] for i in sel], np.int32)


def semihard_triplets(
    batch: np.ndarray, labels: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Per-anchor semihard positive/negative selection (:150-196)."""
    labels = np.asarray(labels)
    d = _pdist(batch)
    triplets = []
    for i in range(len(labels)):
        pos = labels == labels[i]
        pos[i] = False
        neg = ~(labels == labels[i])
        if not pos.any() or not neg.any():
            continue
        neg_mask = neg & (d[i] < d[i][pos].max())
        pos_mask = pos & (d[i] > d[i][neg].min())
        p = rng.choice(np.where(pos_mask if pos_mask.any() else pos)[0])
        n = rng.choice(np.where(neg_mask if neg_mask.any() else neg)[0])
        triplets.append((i, p, n))
    return np.asarray(triplets, np.int32)


def distance_weighted_triplets(
    batch: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    lower_cutoff: float = 0.5,
) -> np.ndarray:
    """'Sampling Matters in Deep Embedding Learning' negatives (:198-238,
    inverse sphere distances :291-324)."""
    labels = np.asarray(labels)
    bs, dim = batch.shape
    d = np.clip(_pdist(batch), lower_cutoff, None)
    triplets = []
    for i in range(bs):
        pos = labels == labels[i]
        pos[i] = False
        if not pos.any() or pos.sum() == bs - 1:
            continue
        log_q = (2.0 - dim) * np.log(d[i]) - ((dim - 3) / 2.0) * np.log(
            np.clip(1.0 - 0.25 * d[i] ** 2, 1e-12, None)
        )
        log_q[labels == labels[i]] = 0.0
        q = np.exp(log_q - log_q.max())
        q[labels == labels[i]] = 0.0
        q = q / q.sum()
        p = rng.choice(np.where(pos)[0])
        n = rng.choice(bs, p=q)
        triplets.append((i, p, n))
    return np.asarray(triplets, np.int32)


def npair_tuples(
    labels: np.ndarray, rng: np.random.Generator
) -> Optional[np.ndarray]:
    """[K, 2+K-1] rows (anchor, positive, negatives — one positive of every
    other class), K = #classes with ≥2 samples (:240-274)."""
    labels = np.asarray(labels)
    label_set, counts = np.unique(labels, return_counts=True)
    label_set = label_set[counts >= 2]
    if len(label_set) < 2:
        return None
    pos_pairs = np.array(
        [rng.choice(np.where(labels == c)[0], 2, replace=False) for c in label_set]
    )
    rows = []
    for idx, (a, p) in enumerate(pos_pairs):
        negs = pos_pairs[np.delete(np.arange(len(pos_pairs)), idx), 1]
        rows.append([a, p, *negs.tolist()])
    return np.asarray(rows, np.int32)


SAMPLERS = {
    "random": random_triplets,
    "semihard": semihard_triplets,
    "distance": distance_weighted_triplets,
}


# --------------------------------------------------------------------------
# losses on torch tensors
# --------------------------------------------------------------------------


def _index(idx, device: torch.device) -> torch.Tensor:
    """An index array (numpy int32 or a tensor) as ``long`` on ``device``."""
    return torch.as_tensor(idx, device=device).long()


def triplet_loss(batch: torch.Tensor, triplets, margin: float = 1.0) -> torch.Tensor:
    """FaceNet triplet loss on squared L2 (:329-379), mean over triplets."""
    t = _index(triplets, batch.device)
    a, p, n = batch[t[:, 0]], batch[t[:, 1]], batch[t[:, 2]]
    d_ap = ((a - p) ** 2).sum(-1)
    d_an = ((a - n) ** 2).sum(-1)
    return F.relu(d_ap - d_an + margin).mean()


def npair_loss(batch: torch.Tensor, npairs, l2: float = 0.02) -> torch.Tensor:
    """Multi-class N-pair loss + l2 penalty on anchors/positives (:384-457)."""
    t = _index(npairs, batch.device)
    a = batch[t[:, 0]]  # [K, D]
    p = batch[t[:, 1]]
    negs = batch[t[:, 2:]]  # [K, K-1, D]
    inner = torch.einsum("kd,knd->kn", a, negs - p[:, None, :])
    loss = torch.log1p(torch.exp(inner).sum(1)).mean()
    penalty = (a**2 + p**2).sum(-1).mean()
    return loss + l2 * penalty


def margin_loss(batch: torch.Tensor, triplets, anchor_classes, beta,
                margin: float = 0.2, nu: float = 0.0) -> torch.Tensor:
    """'Sampling Matters' margin loss with (optionally trainable) per-class β
    (:462-566). ``beta``: scalar or [n_classes] tensor; ``anchor_classes``:
    class id per triplet anchor."""
    t = _index(triplets, batch.device)
    a, p, n = batch[t[:, 0]], batch[t[:, 1]], batch[t[:, 2]]
    d_ap = torch.sqrt(((a - p) ** 2).sum(-1) + 1e-8)
    d_an = torch.sqrt(((a - n) ** 2).sum(-1) + 1e-8)
    beta = torch.as_tensor(beta, dtype=batch.dtype, device=batch.device)
    b = beta[_index(anchor_classes, batch.device)] if beta.ndim > 0 else beta
    pos_loss = F.relu(d_ap - b + margin)
    neg_loss = F.relu(b - d_an + margin)
    pair_count = ((pos_loss > 0) | (neg_loss > 0)).sum().to(batch.dtype)
    total = (pos_loss + neg_loss).sum()
    loss = torch.where(pair_count == 0, total, total / pair_count.clamp_min(1.0))
    if nu:
        loss = loss + nu * b.sum()
    return loss


def proxy_nca_loss(batch: torch.Tensor, labels, proxies: torch.Tensor) -> torch.Tensor:
    """ProxyNCA with ×3-scaled normalized embeddings/proxies (:574-635). The
    log-sum-exp over the negatives masks the label's column with -inf, so
    its gradient there is 0."""

    def norm(x):
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    b = 3.0 * norm(batch)
    prox = 3.0 * norm(proxies)
    d = ((b[:, None, :] - prox[None, :, :]) ** 2).sum(-1)  # [B, C]
    onehot = F.one_hot(_index(labels, batch.device), proxies.shape[0]).bool()
    d_pos = d.masked_fill(~onehot, 0.0).sum(1)
    neg_lse = torch.logsumexp((-d).masked_fill(onehot, -math.inf), dim=1)
    return (d_pos + neg_lse).mean()


def init_margin_beta(n_classes: int, beta: float = 1.2,
                     device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    return torch.full((n_classes,), beta, dtype=torch.float32, device=resolve_device(device))


def init_proxies(generator: torch.Generator, n_classes: int, dim: int,
                 device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """N(0, 1/64) proxies drawn from ``generator`` (on its own device)."""
    dev = resolve_device(device)
    draw = torch.randn(n_classes, dim, generator=generator, device=generator.device)
    return (draw / 8.0).to(dev)


def loss_select(name: str, nclass: int, embed_dim: int,
                generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda") -> Tuple:
    """loss name → (host_sample_fn(batch_np, labels_np, rng) → aux,
    loss_fn(batch, labels, aux, extra_params) → scalar, extra_params dict of
    leaf tensors on ``device`` with ``requires_grad``).

    Mirrors the upstream dispatcher (:33-84); 'crossentropy' maps to a linear
    head + softmax CE like CEClassLoss. ``generator`` draws the proxies and
    the head (a CPU generator seeded 0 when None).
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def leaves(params):
        return {k: v.detach().requires_grad_() for k, v in params.items()}

    if name == "triplet":
        return (
            lambda b, l, rng: {"triplets": random_triplets(b, l, rng)},
            lambda batch, labels, aux, params: triplet_loss(batch, aux["triplets"]),
            {},
        )
    if name == "npair":
        return (
            lambda b, l, rng: {"npairs": npair_tuples(l, rng)},
            lambda batch, labels, aux, params: (
                batch[:0].sum()  # 0 with a zero gradient, as JAX's zeros((), …)
                if aux.get("npairs") is None
                else npair_loss(batch, aux["npairs"])
            ),
            {},
        )
    if name == "marginloss":
        return (
            lambda b, l, rng: {
                "triplets": (t := distance_weighted_triplets(b, l, rng)),
                "anchor_classes": np.asarray(l)[t[:, 0]],
            },
            lambda batch, labels, aux, params: margin_loss(
                batch, aux["triplets"], aux["anchor_classes"], params["beta"]
            ),
            leaves({"beta": init_margin_beta(nclass, device=dev)}),
        )
    if name == "proxynca":
        return (
            lambda b, l, rng: {},
            lambda batch, labels, aux, params: proxy_nca_loss(
                batch, labels, params["proxies"]
            ),
            leaves({"proxies": init_proxies(gen, nclass, embed_dim, device=dev)}),
        )
    if name == "crossentropy":
        w = torch.randn(embed_dim, nclass, generator=gen, device=gen.device) / math.sqrt(embed_dim)
        return (
            lambda b, l, rng: {},
            lambda batch, labels, aux, params: F.cross_entropy(
                batch @ params["w"] + params["b"], _index(labels, batch.device)
            ),
            leaves({"w": w.to(dev), "b": torch.zeros(nclass, device=dev)}),
        )
    raise ValueError(f"Loss {name!r} not available")
