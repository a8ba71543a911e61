"""TimeSformer's divided space-time trunk with the ARV VA heads, in plain
PyTorch: the benchmark's frozen copy of the tests' reference
(tests/timesformer_reference.py), with the seeded layout ``make_state``
draws, the control's TF32, and the trunk computed in blocks of clips.

Written from the published code (facebookresearch/TimeSformer,
``timesformer/models/vit.py``, ``vit_base_patch16_224`` with
``attention_type='divided_space_time'``) in the published layout: the class
token at the front of one token sequence ``b (n t) m``, every
rearrangement done as the published code writes it, attention as explicit
products and a softmax. The heads, the 4:2:0 decode, the TF32 rounding and
the dropout draws are reference/arv.py's. It imports nothing of the
program under test.

Departures from the published code, each the program's too: the clip
embedding is the class token after ``norm``; ``frame_embed`` (the mean of
each frame's normed patch tokens) is an addition; the drop-path masks are
drawn in float32, all of them before the heads' dropout: block by block,
the temporal (clip, patch) rows, the spatial (clip, frame) rows, the MLP's
clip rows; the ARV Adam recipe replaces TimeSformer's SGD.

In blocks: the step draws every mask for the whole batch first, runs the
trunk without a graph in blocks of ``chunk`` clips for the clip
embeddings, runs the heads and the loss on the whole batch, then runs the
trunk again block by block with a graph and takes its gradients from the
heads' gradient on each block's embeddings. The trunk has no BatchNorm, so
each clip's path through it is its own and the blocks change no number
but by rounding.

``tf32=True`` rounds every product's operands and result to TF32 (and the
gradients flowing into them), the control's precision, as
reference/arv.py does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import arv

Layout = List[Tuple[str, tuple, str]]


def trunk_layout(dim: int, depth: int, mlp: int, patch: int, frames: int, crop: int) -> Layout:
    """(key, shape, kind) of the trunk in the published order: embeddings
    as ``bn_bias``, the patch conv as ``conv``, LayerNorms as
    ``bn_weight``/``bn_bias``, linears as ``linear``/``linear_bias``, so
    that every leaf, ``temporal_fc`` included, is non-zero."""
    n = (crop // patch) ** 2

    def ln(p):
        return [(f"{p}.weight", (dim,), "bn_weight"), (f"{p}.bias", (dim,), "bn_bias")]

    def lin(p, o, i):
        return [(f"{p}.weight", (o, i), "linear"), (f"{p}.bias", (o,), "linear_bias")]

    out = [("cls_token", (1, 1, dim), "bn_bias"), ("pos_embed", (1, n + 1, dim), "bn_bias"),
           ("time_embed", (1, frames, dim), "bn_bias"),
           ("patch_embed.proj.weight", (dim, 3, patch, patch), "conv"),
           ("patch_embed.proj.bias", (dim,), "linear_bias")]
    for i in range(depth):
        b = f"blocks.{i}"
        out += ln(f"{b}.norm1") + lin(f"{b}.attn.qkv", 3 * dim, dim)
        out += lin(f"{b}.attn.proj", dim, dim) + ln(f"{b}.temporal_norm1")
        out += lin(f"{b}.temporal_attn.qkv", 3 * dim, dim) + lin(f"{b}.temporal_attn.proj", dim, dim)
        out += lin(f"{b}.temporal_fc", dim, dim) + ln(f"{b}.norm2")
        out += lin(f"{b}.mlp.fc1", mlp, dim) + lin(f"{b}.mlp.fc2", dim, mlp)
    return out + ln("norm")


def va_layout(nclass: int, dim: int, depth: int, mlp: int, patch: int, frames: int,
              crop: int) -> Layout:
    """(key, shape, kind) of the VA model on this trunk: the memory, the
    trunk, then reference/arv.py's heads at width ``dim``."""
    resnet = {k for k, _, _ in arv.trunk_layout()}
    heads = [e for e in arv.va_layout(nclass, dim)[1:] if e[0] not in resnet]
    return ([("visual_memory", (nclass, dim), "memory")]
            + trunk_layout(dim, depth, mlp, patch, frames, crop) + heads)


def drop_path_rates(drop_path: float, depth: int) -> List[float]:
    """Block i's rate, ``linspace(0, drop_path, depth)[i]`` (vit.py)."""
    return torch.linspace(0, drop_path, depth).tolist()


def draw_masks(gen, b: int, t: int, n: int, rates, device) -> List[Optional[tuple]]:
    """Each block's (temporal, spatial, MLP) drop-path masks over the whole
    batch, None at rate 0."""
    out = []
    for p in rates:
        if p == 0.0:
            out.append(None)
            continue
        out.append(tuple(torch.floor((1.0 - p) + torch.rand(rows, generator=gen, device=device))
                         for rows in (b * n, b * t, b)))
    return out


def _block_masks(masks, c0: int, c1: int, t: int, n: int):
    """The masks of clips [c0, c1)."""
    return [None if m is None else (m[0][c0 * n:c1 * n], m[1][c0 * t:c1 * t], m[2][c0:c1])
            for m in masks]


def _linear(x, P, prefix, tf32):
    return arv._mm(x, P[f"{prefix}.weight"].T, tf32) + P[f"{prefix}.bias"]


def _ln(x, P, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{prefix}.weight"], P[f"{prefix}.bias"], eps)


def _drop(x, mask, p):
    if mask is None:
        return x
    return x.div(1.0 - p) * mask.to(x.dtype).view(-1, 1, 1)


def attention(x, P, prefix, heads, tf32):
    """vit.py ``Attention.forward``."""
    b, n, c = x.shape
    qkv = _linear(x, P, f"{prefix}.qkv", tf32).reshape(b, n, 3, heads, c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = arv._mm(q, k.transpose(-2, -1), tf32) * (c // heads) ** -0.5
    attn = attn.softmax(dim=-1)
    return _linear(arv._mm(attn, v, tf32).transpose(1, 2).reshape(b, n, c), P, f"{prefix}.proj",
                   tf32)


def block(x, P, i, b, t, n, cfg, masks, p, tf32):
    """vit.py ``Block.forward``, divided space-time; x [B, 1 + n·t, m]."""
    m, pre, eps, heads = x.shape[-1], f"blocks.{i}", cfg["ln_eps"], cfg["heads"]
    mt, ms, mm = masks if masks is not None else (None, None, None)
    # temporal: b (h w t) m -> (b h w) t m
    xt = x[:, 1:].reshape(b * n, t, m)
    r = _drop(attention(_ln(xt, P, f"{pre}.temporal_norm1", eps), P, f"{pre}.temporal_attn",
                        heads, tf32), mt, p)
    r = _linear(r.reshape(b, n * t, m), P, f"{pre}.temporal_fc", tf32)
    xt = x[:, 1:] + r
    # spatial: the class token repeated per frame, b (h w t) m -> (b t) (h w) m
    init_cls = x[:, 0:1]
    cls = init_cls.repeat(1, t, 1).reshape(b * t, m).unsqueeze(1)
    xs = xt.reshape(b, n, t, m).permute(0, 2, 1, 3).reshape(b * t, n, m)
    xs = torch.cat([cls, xs], 1)
    rs = _drop(attention(_ln(xs, P, f"{pre}.norm1", eps), P, f"{pre}.attn", heads, tf32), ms, p)
    cls = torch.mean(rs[:, 0].reshape(b, t, m), 1, True)
    rs = rs[:, 1:].reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b, n * t, m)
    x = torch.cat([init_cls, xt], 1) + torch.cat([cls, rs], 1)
    # MLP
    h = F.gelu(_linear(_ln(x, P, f"{pre}.norm2", eps), P, f"{pre}.mlp.fc1", tf32))
    return x + _drop(_linear(h, P, f"{pre}.mlp.fc2", tf32), mm, p)


def trunk(P, x, cfg, masks=None, tf32: bool = False):
    """x [B, T, H, W, 3] normalized RGB -> (frame_embed [B, T, m],
    clip_embed [B, m]); ``masks`` from ``draw_masks`` (None: eval)."""
    b, t, h, w, c = x.shape
    pt = cfg["patch"]
    n = (h // pt) * (w // pt)
    xf = arv._r(F.conv2d(arv._r(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), tf32),
                         arv._r(P["patch_embed.proj.weight"], tf32), stride=pt), tf32)
    xf = xf + P["patch_embed.proj.bias"][:, None, None]
    xf = xf.flatten(2).transpose(1, 2)  # (b t) n m
    m = xf.shape[-1]
    xf = torch.cat([P["cls_token"].expand(b * t, -1, -1), xf], 1) + P["pos_embed"]
    cls = xf[:b, 0, :].unsqueeze(1)
    # (b t) n m -> (b n) t m, + time_embed, -> b (n t) m
    xp = xf[:, 1:].reshape(b, t, n, m).permute(0, 2, 1, 3).reshape(b * n, t, m)
    x = torch.cat([cls, (xp + P["time_embed"]).reshape(b, n * t, m)], 1)
    rates = drop_path_rates(cfg["drop_path"], cfg["depth"])
    for i in range(cfg["depth"]):
        x = block(x, P, i, b, t, n, cfg, None if masks is None else masks[i], rates[i], tf32)
    x = _ln(x, P, "norm", cfg["ln_eps"])
    return x[:, 1:].reshape(b, n, t, m).mean(1), x[:, 0]


def va_head_losses(P, ce, labels, gen, hp, tf32=False):
    """reference/arv.py's ``va_losses`` from the clip embeddings on:
    (loss, the updated visual memory). Draws the clip dropout mask, then
    the non-local block's, from ``gen``."""
    arv._linear(arv._dropout(ce, hp["dropout"], gen), P, "fc", tf32)  # no loss under va
    ne = arv._l2n(ce)
    mem = P["visual_memory"]
    reg = -arv._dist(ne, mem, tf32) / hp["temperature"]
    mv = hp["moving_average"]
    new_mem = mem.clone()
    ned = ne.detach()
    for i in range(ned.shape[0]):
        c = int(labels[i])
        new_mem[c] = arv._l2n(mv * new_mem[c] + (1.0 - mv) * ned[i])
    theta = arv._linear(ce, P, "cls_nl.theta", tf32)
    phi, g = arv._linear(new_mem, P, "cls_nl.phi", tf32), arv._linear(new_mem, P, "cls_nl.g", tf32)
    attn = torch.softmax(arv._mm(theta, phi.T, tf32) / math.sqrt(theta.shape[-1]), dim=-1)
    z = arv._mm(attn, g, tf32)
    z = (z - z.mean(-1, keepdim=True)) / (z.std(-1, keepdim=True) + 1e-6)
    z = arv._linear(torch.relu(z), P, "cls_nl.W.0", tf32)
    z = arv._bn_apply(z, P, "cls_nl.W.1", arv.NL_EPS, arv.NL_MOMENTUM, True)
    nled = arv._linear(arv._dropout(z, hp["nl_dropout"], gen) + ce, P, "nled_fc", tf32)
    loss = F.cross_entropy(nled, labels) + F.cross_entropy(reg, labels)
    return loss, new_mem


class TSFTrainer:
    """The VA model's train steps on this trunk from a state dict, as
    reference/arv.py's ``VATrainer`` takes them (torch's Adam with L2 decay,
    every parameter in every update, the statistics and the memory updated
    each step), the trunk in blocks of ``chunk`` clips."""

    def __init__(self, state: Dict[str, torch.Tensor], layout: Layout, hp, cfg,
                 dropout_seed: int, tf32: bool = False, chunk: int = 6):
        self.P = {k: v.detach().clone() for k, v in state.items()}
        self.params = [k for k, _, kind in layout if kind not in arv.BUFFER_KINDS]
        trunk_keys = {k for k, _, _ in trunk_layout(cfg["feat_dim"], cfg["depth"], cfg["mlp"],
                                                     cfg["patch"], cfg["frames"], cfg["crop"])}
        self.trunk_keys = [k for k in self.params if k in trunk_keys]
        self.head_keys = [k for k in self.params if k not in trunk_keys]
        for k in self.params:
            self.P[k].requires_grad_(True)
        self.opt = torch.optim.Adam([self.P[k] for k in self.params], lr=hp["init_lr"],
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=hp["weight_decay"], foreach=False)
        self.device = next(iter(self.P.values())).device
        self.gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        self.hp, self.cfg, self.tf32, self.chunk = hp, cfg, tf32, chunk
        self.raw_grads: List[torch.Tensor] = []

    def _trunk_blocks(self, x, masks, grad_out=None):
        """The clip embeddings block by block; with ``grad_out``, the trunk's
        gradients from the embeddings' gradient instead."""
        b, t = x.shape[:2]
        n = (x.shape[2] // self.cfg["patch"]) * (x.shape[3] // self.cfg["patch"])
        keys = self.trunk_keys
        grads = [torch.zeros_like(self.P[k]) for k in keys] if grad_out is not None else None
        embeds = []
        for c0 in range(0, b, self.chunk):
            c1 = min(b, c0 + self.chunk)
            bm = _block_masks(masks, c0, c1, t, n)
            if grad_out is None:
                with torch.no_grad():
                    embeds.append(trunk(self.P, x[c0:c1], self.cfg, bm, self.tf32)[1])
                continue
            _, ce = trunk(self.P, x[c0:c1], self.cfg, bm, self.tf32)
            for acc, g in zip(grads, torch.autograd.grad(
                    ce, [self.P[k] for k in keys], grad_outputs=grad_out[c0:c1],
                    allow_unused=True)):
                if g is not None:
                    acc += g
        return torch.cat(embeds) if grad_out is None else grads

    def step(self, y_u8, uv_u8, labels) -> float:
        labels = labels.long()
        x = arv.decode_yuv420(y_u8, uv_u8)
        b, t, h, w = x.shape[:4]
        n = (h // self.cfg["patch"]) * (w // self.cfg["patch"])
        masks = draw_masks(self.gen, b, t, n, drop_path_rates(self.cfg["drop_path"],
                                                              self.cfg["depth"]), self.device)
        ce = self._trunk_blocks(x, masks).requires_grad_(True)
        loss, new_mem = va_head_losses(self.P, ce, labels, self.gen, self.hp, self.tf32)
        head = torch.autograd.grad(loss, [self.P[k] for k in self.head_keys] + [ce],
                                   allow_unused=True)
        grads = dict(zip(self.head_keys, head[:-1]))
        grads.update(zip(self.trunk_keys, self._trunk_blocks(x, masks, grad_out=head[-1])))
        self.raw_grads = [torch.zeros_like(self.P[k]) if grads[k] is None else grads[k]
                          for k in self.params]
        for k, g in zip(self.params, self.raw_grads):
            self.P[k].grad = g
        self.opt.step()
        for k in self.params:
            self.P[k].grad = None
        self.P["visual_memory"] = new_mem.detach()
        return float(loss.detach())

    def optimizer_grad(self, key: str) -> torch.Tensor:
        """The gradient as the optimizer took it in its first update, from
        Adam's first moment: (1 - beta1) * (g + wd * p)."""
        return self.opt.state[self.P[key]]["exp_avg"] / 0.1
