"""The ARV model of "Activity Retrieval in the Wild" in plain PyTorch.

A ResNet18-F2F trunk (every conv of the 3D ResNet-18 has temporal extent 1,
so it runs as a 2D conv over [B*T, C, H, W]) with the reference
checkpoint's key names and shapes, and the VA heads: classifier ``fc``
behind clip dropout, register logits -||e - m||/tau against the visual
memory before its update, the sequential EMA memory update, and the
non-local block over the updated memory feeding ``nled_fc``. Written from
the reference code's description (main.py, models/resnet18_3d_f2f.py,
models/resnet18_va.py, misc_utils/nl.py); it imports nothing of the
program under test.

Inputs are 4:2:0 planes (BT.601 full range, nearest chroma upsample),
decoded to ImageNet-normalized RGB here.

``tf32=True`` computes every convolution and matrix product in TF32, the
control's precision: each operand rounded to TF32's 10-bit mantissa (round
to nearest, ties away) and the products summed in float32, forward and
backward alike (the gradient flowing into a product is rounded too),
whatever kernel cuDNN or cuBLAS picks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))
BN_EPS, BN_MOMENTUM = 1e-3, 0.01  # stem and block BNs (resnet18_3d_f2f.py)
DS_EPS, DS_MOMENTUM = 1e-5, 0.1  # the downsample BNs keep torch's defaults
NL_EPS, NL_MOMENTUM = 1e-5, 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _bn(prefix: str, c: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}.weight", (c,), "bn_weight"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "running_mean"),
            (f"{prefix}.running_var", (c,), "running_var"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def trunk_layout() -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of the trunk in the reference checkpoint's order."""
    out = [("conv1.weight", (64, 3, 1, 7, 7), "conv")] + _bn("bn1", 64)
    cin = 64
    for li, (planes, blocks) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            stride = 2 if li > 1 and bi == 0 else 1
            p = f"layer{li}.{bi}"
            out.append((f"{p}.conv1.weight", (planes, cin, 1, 3, 3), "conv"))
            out += _bn(f"{p}.bn1", planes)
            out.append((f"{p}.conv2.weight", (planes, planes, 1, 3, 3), "conv"))
            out += _bn(f"{p}.bn2", planes)
            if stride != 1 or cin != planes:
                out.append((f"{p}.downsample.0.weight", (planes, cin, 1, 1, 1), "conv"))
                out += _bn(f"{p}.downsample.1", planes)
            cin = planes
    return out


def va_layout(nclass: int, dim: int = 512) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of the VA model: the trunk, then its heads."""
    out = [("visual_memory", (nclass, dim), "memory")] + trunk_layout()
    out += [("fc.weight", (nclass, dim), "linear"), ("fc.bias", (nclass,), "linear_bias")]
    for name in ("theta", "phi", "g", "W.0"):
        out += [(f"cls_nl.{name}.weight", (dim, dim, 1), "linear"),
                (f"cls_nl.{name}.bias", (dim,), "linear_bias")]
    out += [(k, s, "nl_bn_weight" if kind == "bn_weight" else kind)
            for k, s, kind in _bn("cls_nl.W.1", dim)]
    out += [("nled_fc.weight", (nclass, dim), "linear"), ("nled_fc.bias", (nclass,), "linear_bias")]
    return out


BUFFER_KINDS = ("running_mean", "running_var", "count", "memory")


def decode_yuv420(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """(Y [..., H, W], UV [..., H/2, W/2, 2]) uint8 -> ImageNet-normalized
    RGB [..., H, W, 3] fp32: nearest chroma upsample, BT.601 full range,
    clipped to [0, 255]."""
    y = y_u8.float()
    uv = uv_u8.float() - 128.0
    uv = uv.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    cb, cr = uv[..., 0], uv[..., 1]
    rgb = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)
    rgb = rgb.clamp(0.0, 255.0) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    return (rgb - mean) / std


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa), ties away."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    """Rounds to TF32 going forward and rounds the gradient coming back."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def _r(x, tf32: bool):
    return _TF32.apply(x) if tf32 else x


def _mm(a, b, tf32: bool = False):
    return _r(_r(a, tf32) @ _r(b, tf32), tf32)


def _conv(x, w, stride=1, padding=0, tf32=False):
    return _r(F.conv2d(_r(x, tf32), _r(w[:, :, 0], tf32), stride=stride, padding=padding), tf32)


def _bn_apply(x, P, prefix, eps, momentum, train):
    """Batch normalization: the batch's biased variance in train mode (and
    the running statistics updated in place with the unbiased one), the
    running statistics otherwise."""
    if train:
        P[f"{prefix}.num_batches_tracked"] += 1
    return F.batch_norm(x, P[f"{prefix}.running_mean"], P[f"{prefix}.running_var"],
                        P[f"{prefix}.weight"], P[f"{prefix}.bias"], train, momentum, eps)


def trunk_forward(P: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
                  tf32: bool = False) -> torch.Tensor:
    """x [B, T, H, W, 3] normalized RGB -> frame features [B, T, 512]."""
    b, t = x.shape[:2]
    x = x.reshape((b * t,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
    x = torch.relu(_bn_apply(_conv(x, P["conv1.weight"], 2, 3, tf32), P, "bn1", BN_EPS,
                             BN_MOMENTUM, train))
    x = F.max_pool2d(x, 3, 2, padding=1)
    cin = 64
    for li, (planes, blocks) in enumerate(STAGES, start=1):
        for bi in range(blocks):
            stride = 2 if li > 1 and bi == 0 else 1
            p = f"layer{li}.{bi}"
            res = x
            if stride != 1 or cin != planes:
                res = _bn_apply(_conv(x, P[f"{p}.downsample.0.weight"], stride, 0, tf32), P,
                                f"{p}.downsample.1", DS_EPS, DS_MOMENTUM, train)
            y = torch.relu(_bn_apply(_conv(x, P[f"{p}.conv1.weight"], stride, 1, tf32), P,
                                     f"{p}.bn1", BN_EPS, BN_MOMENTUM, train))
            y = _bn_apply(_conv(y, P[f"{p}.conv2.weight"], 1, 1, tf32), P, f"{p}.bn2", BN_EPS,
                          BN_MOMENTUM, train)
            x = torch.relu(y + res)
            cin = planes
    return x.mean(dim=(2, 3)).reshape(b, t, -1)


def clip_embedding(P, y_u8, uv_u8, tf32: bool = False) -> torch.Tensor:
    """The served clip embedding: the trunk in eval mode, each frame's
    feature L2-normalized, their mean over time -> [B, 512]."""
    fe = trunk_forward(P, decode_yuv420(y_u8, uv_u8), train=False, tf32=tf32)
    fe = fe / fe.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return fe.mean(dim=1)


def _linear(x, P, prefix, tf32=False):
    w = P[f"{prefix}.weight"]
    return _mm(x, (w[:, :, 0] if w.dim() == 3 else w).T, tf32) + P[f"{prefix}.bias"]


def _dropout(x, p, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def _l2n(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _dist(a, m, tf32=False):
    """||a_i - m_j|| as the clamped expansion (its gradient at a distance
    of zero is that of the square root)."""
    sq = (a * a).sum(-1, keepdim=True) + (m * m).sum(-1)[None, :] - 2.0 * _mm(a, m.T, tf32)
    return torch.sqrt(sq.clamp_min(0.0))


def va_losses(P, y_u8, uv_u8, labels, gen, hp, tf32=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One VA train-mode forward: (loss, the updated visual memory). Draws
    the clip dropout mask, then the non-local block's, from ``gen``."""
    fe = trunk_forward(P, decode_yuv420(y_u8, uv_u8), train=True, tf32=tf32)
    ce = fe.mean(dim=1)
    _linear(_dropout(ce, hp["dropout"], gen), P, "fc", tf32)  # the classifier: no loss under va
    ne = _l2n(ce)
    mem = P["visual_memory"]
    reg = -_dist(ne, mem, tf32) / hp["temperature"]
    mv = hp["moving_average"]
    new_mem = mem.clone()
    ned = ne.detach()
    for i in range(ned.shape[0]):
        c = int(labels[i])
        new_mem[c] = _l2n(mv * new_mem[c] + (1.0 - mv) * ned[i])
    theta, phi, g = (_linear(ce, P, "cls_nl.theta", tf32), _linear(new_mem, P, "cls_nl.phi", tf32),
                     _linear(new_mem, P, "cls_nl.g", tf32))
    attn = torch.softmax(_mm(theta, phi.T, tf32) / math.sqrt(theta.shape[-1]), dim=-1)
    z = _mm(attn, g, tf32)
    z = (z - z.mean(-1, keepdim=True)) / (z.std(-1, keepdim=True) + 1e-6)
    z = _linear(torch.relu(z), P, "cls_nl.W.0", tf32)
    z = _bn_apply(z, P, "cls_nl.W.1", NL_EPS, NL_MOMENTUM, True)
    nled = _linear(_dropout(z, hp["nl_dropout"], gen) + ce, P, "nled_fc", tf32)
    loss = F.cross_entropy(nled, labels) + F.cross_entropy(reg, labels)
    return loss, new_mem


class VATrainer:
    """The VA model's train steps from a state dict: torch's Adam with L2
    decay added to the gradient, every parameter in every update (one that
    no loss reaches has a zero gradient), the BN statistics and the memory
    updated each step."""

    def __init__(self, state: Dict[str, torch.Tensor], layout, hp, dropout_seed: int,
                 tf32: bool = False):
        self.P = {k: v.detach().clone() for k, v in state.items()}
        self.params = [k for k, _, kind in layout if kind not in BUFFER_KINDS]
        for k in self.params:
            self.P[k].requires_grad_(True)
        self.opt = torch.optim.Adam([self.P[k] for k in self.params], lr=hp["init_lr"],
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=hp["weight_decay"], foreach=False)
        dev = next(iter(self.P.values())).device
        self.gen = torch.Generator(device=dev).manual_seed(dropout_seed)
        self.hp, self.tf32 = hp, tf32
        self.raw_grads: List[torch.Tensor] = []

    def step(self, y_u8, uv_u8, labels) -> float:
        labels = labels.long()
        loss, new_mem = va_losses(self.P, y_u8, uv_u8, labels, self.gen, self.hp, self.tf32)
        grads = torch.autograd.grad(loss, [self.P[k] for k in self.params], allow_unused=True)
        self.raw_grads = [torch.zeros_like(self.P[k]) if g is None else g
                          for k, g in zip(self.params, grads)]
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
