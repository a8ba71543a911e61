"""TimeSformer's divided space-time trunk with the ARV VA heads, in plain
PyTorch: the tests' reference for vqwild_tpu_torch's TimeSformer
(models/timesformer.py) and its training through the port's step.

Written from the published code (facebookresearch/TimeSformer,
``timesformer/models/vit.py``: ``PatchEmbed``, ``Attention``, ``Block``
with ``attention_type='divided_space_time'``, ``VisionTransformer.
forward_features``) in the published layout: the class token sits at the
front of one token sequence ``b (n t) m`` and every rearrangement of the
published code is done as it is written there. The VA heads are those of
the ARV model (resnet18_va.py: classifier ``fc`` behind clip dropout,
register logits against the memory before its EMA update, the non-local
block over the updated memory, ``nled_fc``), and the optimizer torch's
Adam with L2 decay. Imports nothing of the port and nothing of JAX.

Departures from the published code, each the port's too:
- the clip embedding is the class token after ``norm`` (the published
  head's input); ``frame_embed`` is the mean of each frame's normed patch
  tokens, an addition;
- drop-path masks are drawn in float32 (the published code draws in the
  input's dtype), all of them before anything else the step draws: block
  by block, the temporal (clip, patch) rows, the spatial (clip, frame)
  rows, the MLP's clip rows;
- inputs are 4:2:0 planes, decoded and ImageNet-normalized in float32 as
  the port's wire does, and the cross-entropies are taken in float32
  whatever the compute dtype, as the port's step takes them.

``fault`` plants a layout fault, for the tests that the comparison catches
one: ``"frame_major"`` lays the tokens out ``b (t n) m`` while the blocks
read ``b (n t) m``; ``"cls_first_frame"`` takes the class token's spatial
output from the first frame's copy instead of the mean over the frames.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
NL_EPS, NL_MOMENTUM = 1e-5, 0.1


def decode_yuv420(y_u8, uv_u8, dtype=torch.float32):
    """(Y [..., H, W], UV [..., H/2, W/2, 2]) uint8 -> ImageNet-normalized
    RGB [..., H, W, 3]: nearest chroma upsample, BT.601 full range, clipped
    to [0, 255], in float32, then cast to ``dtype``."""
    y = y_u8.float()
    uv = uv_u8.float() - 128.0
    uv = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    cb, cr = uv[..., 0], uv[..., 1]
    rgb = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)
    rgb = rgb.clamp(0.0, 255.0) * (1.0 / 255.0)
    mean = torch.tensor(MEAN, dtype=torch.float32)
    inv_std = 1.0 / torch.tensor(STD, dtype=torch.float32)
    return ((rgb - mean) * inv_std).to(dtype)


def drop_path_rates(drop_path: float, depth: int) -> List[float]:
    """Block i's rate, ``linspace(0, drop_path, depth)[i]`` (vit.py)."""
    return torch.linspace(0, drop_path, depth).tolist()


def draw_masks(gen, b: int, t: int, n: int, rates) -> List[Optional[tuple]]:
    """Each block's (temporal, spatial, MLP) drop-path masks, None at rate 0."""
    out = []
    for p in rates:
        if p == 0.0:
            out.append(None)
            continue
        out.append(tuple(torch.floor((1.0 - p) + torch.rand(rows, generator=gen))
                         for rows in (b * n, b * t, b)))
    return out


def _linear(x, P, prefix):
    return F.linear(x, P[f"{prefix}.weight"], P[f"{prefix}.bias"])


def _ln(x, P, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{prefix}.weight"], P[f"{prefix}.bias"], eps)


def _drop(x, mask, p):
    if mask is None:
        return x
    return x.div(1.0 - p) * mask.to(x.dtype).view(-1, 1, 1)


def attention(x, P, prefix, heads):
    """vit.py ``Attention.forward``."""
    b, n, c = x.shape
    qkv = _linear(x, P, f"{prefix}.qkv").reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q @ k.transpose(-2, -1)) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    return _linear((attn @ v).transpose(1, 2).reshape(b, n, c), P, f"{prefix}.proj")


def block(x, P, i, b, t, n, cfg, masks, p, fault=None):
    """vit.py ``Block.forward``, divided space-time; x [B, 1 + n·t, m]."""
    m, pre, eps = x.shape[-1], f"blocks.{i}", cfg["ln_eps"]
    mt, ms, mm = masks if masks is not None else (None, None, None)
    # temporal: b (h w t) m -> (b h w) t m
    xt = x[:, 1:].reshape(b * n, t, m)
    r = _drop(attention(_ln(xt, P, f"{pre}.temporal_norm1", eps), P, f"{pre}.temporal_attn",
                        cfg["heads"]), mt, p)
    r = _linear(r.reshape(b, n * t, m), P, f"{pre}.temporal_fc")
    xt = x[:, 1:] + r
    # spatial: the class token repeated per frame, b (h w t) m -> (b t) (h w) m
    init_cls = x[:, 0:1]
    cls = init_cls.repeat(1, t, 1).reshape(b * t, m).unsqueeze(1)
    xs = xt.reshape(b, n, t, m).permute(0, 2, 1, 3).reshape(b * t, n, m)
    xs = torch.cat([cls, xs], 1)
    rs = _drop(attention(_ln(xs, P, f"{pre}.norm1", eps), P, f"{pre}.attn", cfg["heads"]), ms, p)
    cls = rs[:, 0].reshape(b, t, m)
    cls = cls[:, :1] if fault == "cls_first_frame" else torch.mean(cls, 1, True)
    rs = rs[:, 1:].reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b, n * t, m)
    x = torch.cat([init_cls, xt], 1) + torch.cat([cls, rs], 1)
    # MLP
    h = F.gelu(_linear(_ln(x, P, f"{pre}.norm2", eps), P, f"{pre}.mlp.fc1"))
    return x + _drop(_linear(h, P, f"{pre}.mlp.fc2"), mm, p)


def trunk(P, x, cfg, masks=None, fault=None):
    """x [B, T, H, W, 3] -> (frame_embed [B, T, m], clip_embed [B, m]);
    ``masks`` from ``draw_masks`` (None: eval, nothing dropped)."""
    b, t, h, w, c = x.shape
    pt = cfg["patch"]
    n = (h // pt) * (w // pt)
    # PatchEmbed: (b t) c h w -> (b t) n m
    xf = F.conv2d(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), P["patch_embed.proj.weight"],
                  P["patch_embed.proj.bias"], stride=pt)
    xf = xf.flatten(2).transpose(1, 2)
    m = xf.shape[-1]
    xf = torch.cat([P["cls_token"].expand(b * t, -1, -1), xf], 1) + P["pos_embed"]
    cls = xf[:b, 0, :].unsqueeze(1)
    # (b t) n m -> (b n) t m, + time_embed, -> b (n t) m
    xp = xf[:, 1:].reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b * n, t, m)
    xp = (xp + P["time_embed"]).reshape(b, n * t, m)
    if fault == "frame_major":
        xp = xp.reshape(b, n, t, m).transpose(1, 2).reshape(b, t * n, m)
    x = torch.cat([cls, xp], 1)
    rates = drop_path_rates(cfg["drop_path"], cfg["depth"])
    for i in range(cfg["depth"]):
        x = block(x, P, i, b, t, n, cfg, None if masks is None else masks[i], rates[i], fault)
    x = _ln(x, P, "norm", cfg["ln_eps"])
    return x[:, 1:].reshape(b, n, t, m).mean(1), x[:, 0]


def _dropout(x, p, gen):
    keep = torch.rand(x.shape, generator=gen) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype))


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _dist(a, mem):
    sq = (a * a).sum(-1, keepdim=True) + (mem * mem).sum(-1)[None, :] - 2.0 * (a @ mem.T)
    return torch.sqrt(sq.clamp_min(0.0))


def _nl_linear(x, P, prefix):
    return F.linear(x, P[f"{prefix}.weight"][:, :, 0], P[f"{prefix}.bias"])


def va_losses(P, x, labels, gen, cfg, fault=None):
    """One VA train-mode forward -> (loss, the updated visual memory). Draws
    the drop-path masks, the clip dropout mask, then the non-local block's,
    from ``gen``; updates the non-local BatchNorm's statistics in ``P``."""
    b, t, h, w = x.shape[:4]
    n = (h // cfg["patch"]) * (w // cfg["patch"])
    masks = draw_masks(gen, b, t, n, drop_path_rates(cfg["drop_path"], cfg["depth"]))
    _, ce = trunk(P, x, cfg, masks, fault)
    return head_losses(P, ce, labels, gen, cfg)


def head_losses(P, ce, labels, gen, cfg):
    """The VA heads from the clip embeddings ``ce`` on -> (loss, the updated
    visual memory). Draws the clip dropout mask, then the non-local
    block's, from ``gen``; updates the non-local BatchNorm's statistics in
    ``P``."""
    _linear(_dropout(ce, cfg["dropout"], gen), P, "fc")  # the classifier: no loss under va
    ne = _l2n(ce)
    mem = P["visual_memory"]
    reg = -_dist(ne, mem) / cfg["temperature"]
    mv = cfg["moving_average"]
    new_mem = mem.clone()
    for i, e in enumerate(ne.detach()):
        c = int(labels[i])
        new_mem[c] = _l2n(mv * new_mem[c] + (1.0 - mv) * e)
    theta = _nl_linear(ce, P, "cls_nl.theta")
    phi, g = _nl_linear(new_mem, P, "cls_nl.phi"), _nl_linear(new_mem, P, "cls_nl.g")
    attn = torch.softmax(theta @ phi.T / math.sqrt(theta.shape[-1]), dim=-1)
    z = attn @ g
    z = (z - z.mean(-1, keepdim=True)) / (z.std(-1, keepdim=True) + 1e-6)
    z = _nl_linear(torch.relu(z), P, "cls_nl.W.0")
    P["cls_nl.W.1.num_batches_tracked"] += 1
    z = F.batch_norm(z, P["cls_nl.W.1.running_mean"], P["cls_nl.W.1.running_var"],
                     P["cls_nl.W.1.weight"], P["cls_nl.W.1.bias"], True, NL_MOMENTUM, NL_EPS)
    nled = _linear(_dropout(z, cfg["nl_dropout"], gen) + ce, P, "nled_fc")
    xent = [F.cross_entropy(z.float(), labels, reduction="none").mean() for z in (nled, reg)]
    return xent[0] + xent[1], new_mem


BUFFERS = ("visual_memory", "cls_nl.W.1.running_mean", "cls_nl.W.1.running_var",
           "cls_nl.W.1.num_batches_tracked")


class VATrainer:
    """Train steps from a state dict: torch's Adam with L2 decay added to
    the gradient, every parameter in every update, the non-local BatchNorm's
    statistics and the memory updated each step. ``grads`` holds the last
    step's gradients by key. ``losses`` is the model's train-mode forward,
    ``va_losses`` here."""

    losses = staticmethod(va_losses)

    def __init__(self, state: Dict[str, torch.Tensor], cfg, dropout_seed: int, fault=None):
        self.P = {k: v.detach().clone() for k, v in state.items()}
        self.params = [k for k in self.P if k not in BUFFERS and self.P[k].is_floating_point()]
        for k in self.params:
            self.P[k].requires_grad_(True)
        self.opt = torch.optim.Adam([self.P[k] for k in self.params], lr=cfg["init_lr"],
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=cfg["weight_decay"], foreach=False)
        self.gen = torch.Generator().manual_seed(dropout_seed)
        self.cfg, self.fault = cfg, fault
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self, y_u8, uv_u8, labels, dtype) -> float:
        labels = labels.long()
        loss, new_mem = self.losses(self.P, decode_yuv420(y_u8, uv_u8, dtype), labels, self.gen,
                                    self.cfg, self.fault)
        grads = torch.autograd.grad(loss, [self.P[k] for k in self.params], allow_unused=True)
        self.grads = {k: torch.zeros_like(self.P[k]) if g is None else g
                      for k, g in zip(self.params, grads)}
        for k in self.params:
            self.P[k].grad = self.grads[k]
        self.opt.step()
        for k in self.params:
            self.P[k].grad = None
        self.P["visual_memory"] = new_mem.detach()
        return float(loss.detach())
