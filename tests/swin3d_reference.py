"""The Video Swin Transformer (Swin-B's layers) with the ARV VA heads, in
plain PyTorch: the tests' reference for vqwild_tpu_torch's Video Swin trunk
(models/swin3d.py) and its training through the port's step.

Written from the published code (SwinTransformer/Video-Swin-Transformer,
``mmaction/models/backbones/swin_transformer.py``: ``PatchEmbed3D``,
``SwinTransformer3D.forward``, ``BasicLayer``, ``SwinTransformerBlock3D``
``forward_part1``/``forward_part2``, ``WindowAttention3D``,
``PatchMerging``, ``window_partition``, ``window_reverse``,
``get_window_size``, ``compute_mask``) in the published layout: clips come
in [B, C, D, H, W], each stage turns them channels-last and back
(``rearrange`` written as the permute it is), windows are partitioned
window-major [B·nW, N, C], and the attention is explicit products, ``+``
the gathered relative-position bias, ``view(B_ // nW, nW, ...) + mask``
and a softmax. The VA heads and the optimizer are
tests/timesformer_reference.py's. Imports nothing of the port and nothing
of JAX.

Departures from the published code, each the port's too:
- the clip embedding is the mean over every final token after ``norm``
  (the published I3D head's average pool); ``frame_embed``, each
  tubelet's spatial mean given to both of its frames, is an addition;
- drop-path masks are drawn per clip in float32 (the published code draws
  in the input's dtype), all of them before anything else the step draws:
  block by block, the attention branch's, then the MLP's;
- inputs are 4:2:0 planes, decoded and ImageNet-normalized in float32 as
  the port's wire does, and the cross-entropies are taken in float32
  whatever the compute dtype, as the port's step takes them.

``fault`` plants a layout fault, for the tests that the comparison catches
one: ``"unrolled_shift"`` leaves the shifted windows rolled (no roll back
after the attention); ``"merge_order"`` concatenates a merge's neighbours
(1,0), (0,0), (0,1), (1,1); ``"index_off_by_one"`` reads the bias table one
row on.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from tests import timesformer_reference as tsf_ref

decode_yuv420 = tsf_ref.decode_yuv420


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


def drop_path_rates(drop_path: float, depths) -> List[float]:
    """Block k's rate, ``linspace(0, drop_path_rate, sum(depths))[k]``."""
    return torch.linspace(0, drop_path, sum(depths)).tolist()


def draw_masks(gen, b: int, rates) -> List[Optional[tuple]]:
    """Each block's (attention, MLP) drop-path masks over the clips, None at
    rate 0."""
    return [None if p == 0.0 else
            tuple(torch.floor((1.0 - p) + torch.rand(b, generator=gen)) for _ in range(2))
            for p in rates]


def _linear(x, P, prefix):
    return F.linear(x, P[f"{prefix}.weight"], P.get(f"{prefix}.bias"))


def _ln(x, P, prefix, eps):
    return F.layer_norm(x, (x.shape[-1],), P[f"{prefix}.weight"], P[f"{prefix}.bias"], eps)


def _drop(x, mask, p):
    if mask is None:
        return x
    return x.div(1.0 - p) * mask.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))


def window_attention(x, P, prefix, heads, mask, fault=None):
    """WindowAttention3D.forward on [B·nW, N, C]."""
    B_, N, C = x.shape
    qkv = _linear(x, P, f"{prefix}.qkv").reshape(B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (C // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = P[f"{prefix}.relative_position_bias_table"]
    index = P[f"{prefix}.relative_position_index"][:N, :N].reshape(-1)
    if fault == "index_off_by_one":
        index = (index + 1) % table.shape[0]
    relative_position_bias = table[index].reshape(N, N, -1).permute(2, 0, 1).contiguous()
    attn = attn + relative_position_bias.unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, heads, N, N) + mask.to(x.dtype).unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, N, N)
    attn = attn.softmax(dim=-1)
    return _linear((attn @ v).transpose(1, 2).reshape(B_, N, C), P, f"{prefix}.proj")


def block(x, P, pre, heads, window, shift, mask_matrix, masks, p, eps, fault=None):
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
    attn_windows = window_attention(x_windows, P, f"{pre}.attn", heads, attn_mask, fault)
    attn_windows = attn_windows.view(-1, *(window_size + (C,)))
    shifted_x = window_reverse(attn_windows, window_size, B, Dp, Hp, Wp)
    if any(i > 0 for i in shift_size) and fault != "unrolled_shift":
        x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1], shift_size[2]),
                       dims=(1, 2, 3))
    else:
        x = shifted_x
    if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
        x = x[:, :D, :H, :W, :].contiguous()
    x = shortcut + _drop(x, ma, p)
    h = F.gelu(_linear(_ln(x, P, f"{pre}.norm2", eps), P, f"{pre}.mlp.fc1"))
    return x + _drop(_linear(h, P, f"{pre}.mlp.fc2"), mm, p)


def patch_merging(x, P, pre, eps, fault=None):
    """PatchMerging.forward; x [B, D, H, W, C]."""
    B, D, H, W, C = x.shape
    if (H % 2 == 1) or (W % 2 == 1):
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    parts = [x1, x0, x2, x3] if fault == "merge_order" else [x0, x1, x2, x3]
    return _linear(_ln(torch.cat(parts, -1), P, f"{pre}.norm", eps), P, f"{pre}.reduction")


def basic_layer(x, P, i, cfg, masks, rates, fault=None):
    """BasicLayer.forward; x [B, C, D, H, W] -> [B, C', D, H', W']."""
    window = tuple(cfg["window"])
    shift = tuple(s // 2 for s in window)
    B, C, D, H, W = x.shape
    window_size, shift_size = get_window_size((D, H, W), window, shift)
    x = x.permute(0, 2, 3, 4, 1)  # rearrange 'b c d h w -> b d h w c'
    Dp = int(math.ceil(D / window_size[0])) * window_size[0]
    Hp = int(math.ceil(H / window_size[1])) * window_size[1]
    Wp = int(math.ceil(W / window_size[2])) * window_size[2]
    attn_mask = compute_mask(Dp, Hp, Wp, window_size, shift_size)
    for j in range(cfg["depths"][i]):
        k = sum(cfg["depths"][:i]) + j
        x = block(x, P, f"layers.{i}.blocks.{j}", cfg["heads"][i], window,
                  (0, 0, 0) if j % 2 == 0 else shift, attn_mask, masks[k], rates[k],
                  cfg["ln_eps"], fault)
    x = x.reshape(B, D, H, W, -1)
    if i < len(cfg["depths"]) - 1:
        x = patch_merging(x, P, f"layers.{i}.downsample", cfg["ln_eps"], fault)
    return x.permute(0, 4, 1, 2, 3)  # rearrange 'b d h w c -> b c d h w'


def trunk(P, x, cfg, masks=None, fault=None):
    """x [B, T, H, W, 3] -> (frame_embed [B, T, C], clip_embed [B, C]);
    ``masks`` from ``draw_masks`` (None: eval, nothing dropped)."""
    t = x.shape[1]
    pd, ph, pw = cfg["patch"]
    x = x.permute(0, 4, 1, 2, 3)  # the published input, [B, 3, T, H, W]
    # PatchEmbed3D
    _, _, D, H, W = x.size()
    if W % pw != 0:
        x = F.pad(x, (0, pw - W % pw))
    if H % ph != 0:
        x = F.pad(x, (0, 0, 0, ph - H % ph))
    if D % pd != 0:
        x = F.pad(x, (0, 0, 0, 0, 0, pd - D % pd))
    x = F.conv3d(x, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"],
                 stride=(pd, ph, pw))
    D, Wh, Ww = x.size(2), x.size(3), x.size(4)
    x = _ln(x.flatten(2).transpose(1, 2), P, "patch_embed.norm", cfg["ln_eps"])
    x = x.transpose(1, 2).reshape(-1, cfg["embed_dim"], D, Wh, Ww)
    rates = drop_path_rates(cfg["drop_path"], cfg["depths"])
    masks = masks if masks is not None else [None] * len(rates)
    for i in range(len(cfg["depths"])):
        x = basic_layer(x.contiguous(), P, i, cfg, masks, rates, fault)
    x = _ln(x.permute(0, 2, 3, 4, 1), P, "norm", cfg["ln_eps"])  # 'n c d h w -> n d h w c'
    frame_embed = x.mean(dim=(2, 3)).repeat_interleave(pd, dim=1)[:, :t]
    return frame_embed, x.mean(dim=(1, 2, 3))


def va_losses(P, x, labels, gen, cfg, fault=None):
    """One VA train-mode forward -> (loss, the updated visual memory). Draws
    the drop-path masks, then the heads' dropout masks, from ``gen``."""
    masks = draw_masks(gen, x.shape[0], drop_path_rates(cfg["drop_path"], cfg["depths"]))
    _, ce = trunk(P, x, cfg, masks, fault)
    return tsf_ref.head_losses(P, ce, labels, gen, cfg)


class VATrainer(tsf_ref.VATrainer):
    """tests/timesformer_reference.py's train steps, on this trunk."""

    losses = staticmethod(va_losses)
