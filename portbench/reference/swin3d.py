"""The Video Swin Transformer with the ARV VA heads, in plain PyTorch: the
benchmark's frozen copy of the tests' reference (tests/swin3d_reference.py),
with the seeded layout ``make_state`` draws, the control's TF32, and the
trunk computed in blocks of clips.

Written from the published code (SwinTransformer/Video-Swin-Transformer,
``mmaction/models/backbones/swin_transformer.py``) in the published layout:
clips come in [B, C, D, H, W], each stage turns them channels-last and
back, windows are partitioned window-major [B·nW, N, C], and the attention
is explicit products, ``+`` the gathered relative-position bias,
``view(B_ // nW, nW, ...) + mask`` and a softmax. The heads, the 4:2:0
decode, the TF32 rounding and the dropout draws are reference/arv.py's and
reference/timesformer.py's. It imports nothing of the program under test.

Departures from the published code, each the program's too: the clip
embedding is the mean over every final token after ``norm``;
``frame_embed`` is left out (the heads take the clip embedding alone); the
drop-path masks are drawn per clip in float32, all of them before the
heads' dropout: block by block, the attention branch's, then the MLP's;
the ARV Adam recipe replaces the published AdamW.

In blocks: the step draws every mask for the whole batch first, runs the
trunk without a graph in blocks of ``chunk`` clips for the clip
embeddings, runs the heads and the loss on the whole batch, then runs the
trunk again block by block with a graph and takes its gradients from the
heads' gradient on each block's embeddings. The trunk has no BatchNorm, so
each clip's path through it is its own and the blocks change no number
but by rounding.

``tf32=True`` rounds every product's operands and result to TF32 (and the
gradients flowing into them), the control's precision, as reference/arv.py
does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.harness.weights import make_state as make_layout_state
from portbench.reference import arv
from portbench.reference.timesformer import va_head_losses

Layout = List[Tuple[str, tuple, str]]
INDEX = "relative_position_index"


def trunk_layout(embed_dim: int, depths, heads, window, patch, mlp_ratio: int) -> Layout:
    """(key, shape, kind) of the trunk in the published order: LayerNorms
    as ``bn_weight``/``bn_bias``, the patch conv as ``conv``, linears as
    ``linear``/``linear_bias``, the bias tables as ``bn_bias`` (normal at
    0.1, so that the bias matters), each window's relative-position index as
    a ``count`` buffer that ``make_state`` sets to its value."""
    table = math.prod(2 * w - 1 for w in window)
    n = math.prod(window)

    def ln(p, c):
        return [(f"{p}.weight", (c,), "bn_weight"), (f"{p}.bias", (c,), "bn_bias")]

    def lin(p, o, i):
        return [(f"{p}.weight", (o, i), "linear"), (f"{p}.bias", (o,), "linear_bias")]

    out = [("patch_embed.proj.weight", (embed_dim, 3) + tuple(patch), "conv"),
           ("patch_embed.proj.bias", (embed_dim,), "linear_bias")]
    out += ln("patch_embed.norm", embed_dim)
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed_dim * 2 ** i
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            out += ln(f"{b}.norm1", c)
            out += [(f"{b}.attn.relative_position_bias_table", (table, h), "bn_bias"),
                    (f"{b}.attn.{INDEX}", (n, n), "count")]
            out += lin(f"{b}.attn.qkv", 3 * c, c) + lin(f"{b}.attn.proj", c, c)
            out += ln(f"{b}.norm2", c)
            out += lin(f"{b}.mlp.fc1", mlp_ratio * c, c) + lin(f"{b}.mlp.fc2", c, mlp_ratio * c)
        if i < len(depths) - 1:
            out += [(f"layers.{i}.downsample.reduction.weight", (2 * c, 4 * c), "linear")]
            out += ln(f"layers.{i}.downsample.norm", 4 * c)
    return out + ln("norm", embed_dim * 2 ** (len(depths) - 1))


def va_layout(nclass: int, dim: int, embed_dim: int, depths, heads, window, patch,
              mlp_ratio: int) -> Layout:
    """(key, shape, kind) of the VA model on this trunk: the memory, the
    trunk, then reference/arv.py's heads at width ``dim``."""
    resnet = {k for k, _, _ in arv.trunk_layout()}
    head = [e for e in arv.va_layout(nclass, dim)[1:] if e[0] not in resnet]
    return ([("visual_memory", (nclass, dim), "memory")]
            + trunk_layout(embed_dim, depths, heads, window, patch, mlp_ratio) + head)


def relative_position_index(window_size):
    """WindowAttention3D.__init__'s ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window_size[0]),
                                        torch.arange(window_size[1]),
                                        torch.arange(window_size[2]), indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 2] += window_size[2] - 1
    relative_coords[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    relative_coords[:, :, 1] *= (2 * window_size[2] - 1)
    return relative_coords.sum(-1)


def make_state(layout: Layout, seed: int, window, device) -> Dict[str, torch.Tensor]:
    """harness/weights.make_state's seeded leaves, each relative-position
    index at its computed value."""
    out = make_layout_state(layout, seed, device)
    index = relative_position_index(window).to(device)
    return {k: index.clone() if k.endswith(INDEX) else v for k, v in out.items()}


def get_window_size(x_size, window_size, shift_size):
    use_window_size = list(window_size)
    use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            use_shift_size[i] = 0
    return tuple(use_window_size), tuple(use_shift_size)


def window_partition(x, window_size):
    B, D, H, W, C = x.shape
    x = x.view(B, D // window_size[0], window_size[0], H // window_size[1], window_size[1],
               W // window_size[2], window_size[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, math.prod(window_size), C)


def window_reverse(windows, window_size, B, D, H, W):
    x = windows.view(B, D // window_size[0], H // window_size[1], W // window_size[2],
                     window_size[0], window_size[1], window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)


def compute_mask(D, H, W, window_size, shift_size, device=None):
    img_mask = torch.zeros((1, D, H, W, 1), device=device)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                           float(0.0))


def drop_path_rates(drop_path: float, depths) -> List[float]:
    """Block k's rate, ``linspace(0, drop_path_rate, sum(depths))[k]``."""
    return torch.linspace(0, drop_path, sum(depths)).tolist()


def draw_masks(gen, b: int, rates, device) -> List[Optional[tuple]]:
    """Each block's (attention, MLP) drop-path masks over the clips, None at
    rate 0."""
    return [None if p == 0.0 else
            tuple(torch.floor((1.0 - p) + torch.rand(b, generator=gen, device=device))
                  for _ in range(2))
            for p in rates]


def _linear(x, P, prefix, tf32):
    y = arv._mm(x, P[f"{prefix}.weight"].T, tf32)
    bias = P.get(f"{prefix}.bias")
    return y if bias is None else y + bias


def _ln(x, P, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{prefix}.weight"], P[f"{prefix}.bias"], eps)


def _drop(x, mask, p):
    if mask is None:
        return x
    return x.div(1.0 - p) * mask.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))


def window_attention(x, P, prefix, heads, mask, tf32):
    """WindowAttention3D.forward on [B·nW, N, C]."""
    B_, N, C = x.shape
    qkv = _linear(x, P, f"{prefix}.qkv", tf32).reshape(B_, N, 3, heads, C // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (C // heads) ** -0.5
    attn = arv._mm(q, k.transpose(-2, -1), tf32)
    index = P[f"{prefix}.{INDEX}"][:N, :N].reshape(-1)
    bias = P[f"{prefix}.relative_position_bias_table"][index].reshape(N, N, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, N, N)
    attn = attn.softmax(dim=-1)
    return _linear(arv._mm(attn, v, tf32).transpose(1, 2).reshape(B_, N, C), P,
                   f"{prefix}.proj", tf32)


def block(x, P, pre, heads, window, shift, mask_matrix, masks, p, eps, tf32):
    """SwinTransformerBlock3D.forward; x [B, D, H, W, C]."""
    B, D, H, W, C = x.shape
    window_size, shift_size = get_window_size((D, H, W), window, shift)
    ma, mm = masks if masks is not None else (None, None)
    shortcut = x
    x = _ln(x, P, f"{pre}.norm1", eps)
    pad_d1 = (window_size[0] - D % window_size[0]) % window_size[0]
    pad_b = (window_size[1] - H % window_size[1]) % window_size[1]
    pad_r = (window_size[2] - W % window_size[2]) % window_size[2]
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
    _, Dp, Hp, Wp, _ = x.shape
    if any(i > 0 for i in shift_size):
        shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1], -shift_size[2]),
                               dims=(1, 2, 3))
        attn_mask = mask_matrix
    else:
        shifted_x = x
        attn_mask = None
    x_windows = window_partition(shifted_x, window_size)
    attn_windows = window_attention(x_windows, P, f"{pre}.attn", heads, attn_mask, tf32)
    attn_windows = attn_windows.view(-1, *(window_size + (C,)))
    shifted_x = window_reverse(attn_windows, window_size, B, Dp, Hp, Wp)
    if any(i > 0 for i in shift_size):
        x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1], shift_size[2]),
                       dims=(1, 2, 3))
    else:
        x = shifted_x
    if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
        x = x[:, :D, :H, :W, :].contiguous()
    x = shortcut + _drop(x, ma, p)
    h = F.gelu(_linear(_ln(x, P, f"{pre}.norm2", eps), P, f"{pre}.mlp.fc1", tf32))
    return x + _drop(_linear(h, P, f"{pre}.mlp.fc2", tf32), mm, p)


def patch_merging(x, P, pre, eps, tf32):
    """PatchMerging.forward; x [B, D, H, W, C]."""
    B, D, H, W, C = x.shape
    if (H % 2 == 1) or (W % 2 == 1):
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    return _linear(_ln(torch.cat([x0, x1, x2, x3], -1), P, f"{pre}.norm", eps), P,
                   f"{pre}.reduction", tf32)


def basic_layer(x, P, i, cfg, masks, rates, tf32):
    """BasicLayer.forward; x [B, C, D, H, W] -> [B, C', D, H', W']."""
    window = tuple(cfg["window"])
    shift = tuple(s // 2 for s in window)
    B, C, D, H, W = x.shape
    window_size, shift_size = get_window_size((D, H, W), window, shift)
    x = x.permute(0, 2, 3, 4, 1)  # rearrange 'b c d h w -> b d h w c'
    Dp = int(math.ceil(D / window_size[0])) * window_size[0]
    Hp = int(math.ceil(H / window_size[1])) * window_size[1]
    Wp = int(math.ceil(W / window_size[2])) * window_size[2]
    attn_mask = compute_mask(Dp, Hp, Wp, window_size, shift_size, x.device)
    for j in range(cfg["depths"][i]):
        k = sum(cfg["depths"][:i]) + j
        x = block(x, P, f"layers.{i}.blocks.{j}", cfg["heads"][i], window,
                  (0, 0, 0) if j % 2 == 0 else shift, attn_mask, masks[k], rates[k],
                  cfg["ln_eps"], tf32)
    x = x.reshape(B, D, H, W, -1)
    if i < len(cfg["depths"]) - 1:
        x = patch_merging(x, P, f"layers.{i}.downsample", cfg["ln_eps"], tf32)
    return x.permute(0, 4, 1, 2, 3)  # rearrange 'b d h w c -> b c d h w'


def trunk(P, x, cfg, masks=None, tf32: bool = False):
    """x [B, T, H, W, 3] normalized RGB -> clip_embed [B, C]; ``masks``
    from ``draw_masks`` (None: eval)."""
    pd, ph, pw = cfg["patch"]
    x = x.permute(0, 4, 1, 2, 3)  # the published input, [B, 3, T, H, W]
    _, _, D, H, W = x.size()
    if W % pw != 0:
        x = F.pad(x, (0, pw - W % pw))
    if H % ph != 0:
        x = F.pad(x, (0, 0, 0, ph - H % ph))
    if D % pd != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, pd - D % pd))
    x = arv._r(F.conv3d(arv._r(x, tf32), arv._r(P["patch_embed.proj.weight"], tf32),
                        stride=(pd, ph, pw)), tf32)
    x = x + P["patch_embed.proj.bias"][:, None, None, None]
    D, Wh, Ww = x.size(2), x.size(3), x.size(4)
    x = _ln(x.flatten(2).transpose(1, 2), P, "patch_embed.norm", cfg["ln_eps"])
    x = x.transpose(1, 2).reshape(-1, cfg["embed_dim"], D, Wh, Ww)
    rates = drop_path_rates(cfg["drop_path"], cfg["depths"])
    masks = masks if masks is not None else [None] * len(rates)
    for i in range(len(cfg["depths"])):
        x = basic_layer(x.contiguous(), P, i, cfg, masks, rates, tf32)
    x = _ln(x.permute(0, 2, 3, 4, 1), P, "norm", cfg["ln_eps"])  # 'n c d h w -> n d h w c'
    return x.mean(dim=(1, 2, 3))


def _block_masks(masks, c0: int, c1: int):
    """The masks of clips [c0, c1)."""
    return [None if m is None else (m[0][c0:c1], m[1][c0:c1]) for m in masks]


class SwinTrainer:
    """The VA model's train steps on this trunk from a state dict, as
    reference/arv.py's ``VATrainer`` takes them (torch's Adam with L2 decay,
    every parameter in every update, the statistics and the memory updated
    each step), the trunk in blocks of ``chunk`` clips."""

    def __init__(self, state: Dict[str, torch.Tensor], layout: Layout, hp, cfg,
                 dropout_seed: int, tf32: bool = False, chunk: int = 1):
        self.P = {k: v.detach().clone() for k, v in state.items()}
        self.params = [k for k, _, kind in layout if kind not in arv.BUFFER_KINDS]
        trunk_keys = {k for k, _, _ in trunk_layout(cfg["embed_dim"], cfg["depths"],
                                                     cfg["heads"], cfg["window"], cfg["patch"],
                                                     cfg["mlp_ratio"])}
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
        b = x.shape[0]
        keys = self.trunk_keys
        grads = [torch.zeros_like(self.P[k]) for k in keys] if grad_out is not None else None
        embeds = []
        for c0 in range(0, b, self.chunk):
            c1 = min(b, c0 + self.chunk)
            bm = _block_masks(masks, c0, c1)
            if grad_out is None:
                with torch.no_grad():
                    embeds.append(trunk(self.P, x[c0:c1], self.cfg, bm, self.tf32))
                continue
            ce = trunk(self.P, x[c0:c1], self.cfg, bm, self.tf32)
            for acc, g in zip(grads, torch.autograd.grad(
                    ce, [self.P[k] for k in keys], grad_outputs=grad_out[c0:c1],
                    allow_unused=True)):
                if g is not None:
                    acc += g
        return torch.cat(embeds) if grad_out is None else grads

    def step(self, y_u8, uv_u8, labels) -> float:
        labels = labels.long()
        x = arv.decode_yuv420(y_u8, uv_u8)
        masks = draw_masks(self.gen, x.shape[0],
                           drop_path_rates(self.cfg["drop_path"], self.cfg["depths"]),
                           self.device)
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
