"""TimeSformer with divided space-time attention, as a trunk of the ARV model.

Bertasius, Wang and Torresani, "Is Space-Time Attention All You Need for
Video Understanding?", ICML 2021 (arXiv:2102.05095); the published code is
facebookresearch/TimeSformer, ``timesformer/models/vit.py``
(``VisionTransformer`` with ``attention_type='divided_space_time'``,
``vit_base_patch16_224``). Published sizes: width D 768, 12 blocks, 12 heads
of 64, MLP 3,072, 16x16 patches, qkv bias, LayerNorm eps 1e-6, exact GELU,
attention scale 64^-0.5, drop path linear over depth to 0.1, no dropout,
8 frames of 224x224.

Input [B, T, H, W, 3] normalized RGB; with N = (H/16)(W/16) patches a frame:

- embedding: each frame's 16x16 patches through the patch conv, plus
  ``pos_embed[1:]``; the patch tokens plus ``time_embed`` (by frame), in
  patch-major, frame-minor order ``b (n t) m``; one class token a clip,
  ``cls_token + pos_embed[0]``, with no time embedding.
- block, temporal: each patch position attends over its T frames,
  ``r = drop_path(temporal_attn(temporal_norm1(x_t)))``, then
  ``x_t = x_t + temporal_fc(r)``.
- block, spatial: each frame's N patches and a copy of the class token
  attend over each other, ``r = drop_path(attn(norm1(.)))``; the patches
  take their rows of ``r``, the class token the mean over the frames of
  its T copies' rows.
- block, MLP: ``x = x + drop_path(fc2(GELU(fc1(norm2(x)))))``.
- output: ``norm``; the clip embedding is the class token [B, D] (what the
  published head reads), and ``frame_embed`` the mean over each frame's
  patch tokens [B, T, D]: an addition of the port's, for the evaluators'
  per-frame [B, C, T] contract.

The published code's nearest interpolation of ``pos_embed`` and
``time_embed`` to another patch grid or frame count is kept (evaluation
clips may have other lengths than training clips).

Drop path (``drop_path`` below) is drawn per leading row as the published
code draws it: per (clip, patch) in the temporal branch, per (clip, frame)
in the spatial branch, per clip in the MLP; block i's rate is
``linspace(0, drop_path, depth)[i]``, so block 0 draws nothing. The masks
come from the caller's generator in that order, block by block, and are
drawn in float32 whatever the compute dtype (the published code draws in
the input's dtype).

The arithmetic is the published code's; the layout is the port's. The
class token is kept apart from the patch tokens, [B, 1, D] beside
[B, N, T, D]: the published ``cat(cls, tokens)`` [B, 1 + N·T, D] is never
built, because the cat and the slice ``x[:, 1:]`` would each copy every
token in every block. So the temporal attention runs on a view of the
tokens, [(B N), T, D]; the spatial branch gathers them frame-major with
each frame's copy of the class token in one copy (a relayout), and its
patch rows come back through a transposed view inside the residual add;
the MLP and the final LayerNorm, which act token by token, run on the class
token and the tokens apart. The patch conv runs as one matrix product over
patches gathered in token order (a relayout), its weight [D, 3, 16, 16]
read as [D, 16·16·3]. Attention over a CUDA float32 input of at most 16
tokens (the temporal branch's frames) runs on K5 (``ops/attention.py``:
exact fp32 on the packed qkv, whose gradient comes back packed); any other
(the spatial branch, the CPU, float64, bf16) is
``F.scaled_dot_product_attention``, on a card limited to the
memory-efficient kernel (float32 through error-compensated TF32 products,
CUTLASS's ``OpMultiplyAddFastF32``) and the math kernel: never a kernel
that computes float32 in TF32 or less. The
linears and the patch product run on K4 (``ops/linear.py``: three
error-compensated TF32 products on the tensor cores) for a CUDA float32
input, and in ``F.linear`` for any other.

The keys are the published ones, at the top level of the module that
holds the trunk: ``cls_token``, ``pos_embed``, ``time_embed``,
``patch_embed.proj.*``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
temporal_norm1, temporal_attn.qkv, temporal_attn.proj, temporal_fc, norm2,
mlp.fc1, mlp.fc2}.*``, ``norm.*`` (the published classifier ``head`` is
not built: the ARV heads take the class token). The trunk has no
BatchNorm, so it takes a ``mesh`` for its drop-path masks alone.

Under a profiler it records (core/profiling.py) the spans
``tsf.patch_embed`` and, in each block, ``tsf.temporal``, ``tsf.spatial``
and ``tsf.mlp``; device markers at the start of each block's three parts
(``tsf.temporal``, ``tsf.spatial``, ``tsf.mlp``) and after the final norm
(``tsf.end``); and the counters ``tsf.tokens`` (tokens a forward embeds),
``tsf.attn.temporal`` and ``tsf.attn.spatial`` (attention calls) and
``tsf.relayout_bytes`` (the bytes the forward copies only to change a
layout: the patch gather, the patch weight and each block's spatial
gather).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.ops import attention as attention_ops
from vqwild_tpu_torch.ops import linear as linear_ops

# vit_base_patch16_224 with divided space-time attention, 8 frames
DIM, DEPTH, HEADS, MLP, PATCH, FRAMES, CROP = 768, 12, 12, 3072, 16, 8, 224
DROP_PATH, LN_EPS = 0.1, 1e-6


def _affine(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x weightᵀ + bias`` (``bias`` None: none): on K4 (``ops/linear.py``)
    for a CUDA float32 input, ``F.linear`` for any other (the CPU, float64,
    bf16)."""
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    if x.is_cuda and x.dtype == torch.float32:
        return linear_ops.linear(x, weight, bias)
    return F.linear(x, weight, bias)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return _affine(x, layer.weight, layer.bias)


def _norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


def _short(x: torch.Tensor, length: int, head_dim: int) -> bool:
    """Whether attention over ``x`` [rows, length, D] runs on K5
    (``ops/attention.py``): a CUDA float32 input of sequences and heads the
    kernel takes (the temporal branch's few frames); every other (the
    spatial branch's N + 1 tokens, the CPU, float64, bf16) runs
    ``F.scaled_dot_product_attention``."""
    return x.is_cuda and x.dtype == torch.float32 and attention_ops.takes(length, head_dim)


def _sdpa_backends(x: torch.Tensor):
    if not x.is_cuda:
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH])


def _pos_embed(pe: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """``pos_embed`` for a gh x gw patch grid: as it is, or its patch rows
    nearest-interpolated from the square grid (vit.py)."""
    if pe.shape[1] == gh * gw + 1:
        return pe
    side = math.isqrt(pe.shape[1] - 1)
    grid = pe[0, 1:].transpose(0, 1).reshape(1, -1, side, side)
    grid = F.interpolate(grid, size=(gh, gw), mode="nearest").flatten(2).transpose(1, 2)
    return torch.cat([pe[:, :1], grid], dim=1)


def _time_embed(te: torch.Tensor, t: int) -> torch.Tensor:
    """``time_embed`` for t frames: as it is, or nearest-interpolated
    (vit.py)."""
    if te.shape[1] == t:
        return te
    return F.interpolate(te.transpose(1, 2), size=t, mode="nearest").transpose(1, 2)


def drop_path_mask(rows: int, p: float, train: bool, generator: Optional[torch.Generator],
                   device, mesh=None) -> Optional[torch.Tensor]:
    """The published ``drop_path``'s mask over ``rows`` leading rows, in
    float32: ``floor(keep + u)`` with u uniform, keep = 1 − p; None where
    nothing is dropped (eval, or p = 0). Under a ``mesh`` of more than one
    rank the mask is drawn for the global batch and this rank keeps its
    block of rows, as ``heads.dropout`` does."""
    if not train or p == 0.0:
        return None
    if mesh is not None and mesh.size > 1:
        u = torch.rand(rows * mesh.size, generator=generator, device=device)
        u = u[mesh.rank * rows:(mesh.rank + 1) * rows]
    else:
        u = torch.rand(rows, generator=generator, device=device)
    return torch.floor((1.0 - p) + u)


def _drop(x: torch.Tensor, mask: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """``x`` [rows, ...] scaled by 1/(1 − p) and masked by rows."""
    if mask is None:
        return x
    return x.div(1.0 - p) * mask.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))


class Attention(nn.Module):
    """Multi-head self-attention over [rows, L, D]: ``qkv`` (features in
    (3, heads, head dim) order), softmax(q kᵀ · head_dim^-0.5) v, ``proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, d = x.shape
        hd = d // self.heads
        qkv = _linear(self.qkv, x)
        if _short(x, length, hd):
            return _linear(self.proj, attention_ops.attention(qkv, self.heads, hd ** -0.5))
        qkv = qkv.view(n, length, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        with _sdpa_backends(x):
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=hd ** -0.5)
        return _linear(self.proj, o.transpose(1, 2).reshape(n, length, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class Block(nn.Module):
    """One divided space-time block (vit.py ``Block``), on the class token
    [B, 1, D] and the patch tokens [B, N, T, D] apart."""

    def __init__(self, dim: int, heads: int, mlp: int, drop_path: float, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=eps)
        self.temporal_attn = Attention(dim, heads)
        self.temporal_fc = nn.Linear(dim, dim)
        self.drop_path = drop_path
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp)

    def forward(self, cls: torch.Tensor, tok: torch.Tensor, train: bool,
                generator: Optional[torch.Generator], mesh=None):
        b, n, t, d = tok.shape
        p, dev = self.drop_path, tok.device
        profiling.mark("tsf.temporal")
        with profiling.span("tsf.temporal"):
            r = self.temporal_attn(_norm(self.temporal_norm1, tok).view(b * n, t, d))
            profiling.count("tsf.attn.temporal")
            r = _drop(r, drop_path_mask(b * n, p, train, generator, dev, mesh), p)
            tok = tok + _linear(self.temporal_fc, r.view(b, n, t, d))
        profiling.mark("tsf.spatial")
        with profiling.span("tsf.spatial"):
            # each frame's class-token copy, then its patches: one copy
            xs = torch.cat([cls[:, None].expand(b, t, 1, d), tok.transpose(1, 2)], dim=2)
            profiling.count("tsf.relayout_bytes", xs.numel() * xs.element_size())
            rs = self.attn(_norm(self.norm1, xs.view(b * t, n + 1, d)))
            profiling.count("tsf.attn.spatial")
            rs = _drop(rs, drop_path_mask(b * t, p, train, generator, dev, mesh), p)
            rs = rs.view(b, t, n + 1, d)
            cls = cls + rs[:, :, :1].mean(dim=1)
            tok = tok + rs[:, :, 1:].transpose(1, 2)
        profiling.mark("tsf.mlp")
        with profiling.span("tsf.mlp"):
            mask = drop_path_mask(b, p, train, generator, dev, mesh)
            cls = cls + _drop(self.mlp(_norm(self.norm2, cls)), mask, p)
            tok = tok + _drop(self.mlp(_norm(self.norm2, tok)), mask, p)
        return cls, tok


class TimeSformer(nn.Module):
    """The trunk: [B, T, H, W, 3] float → (frame_embed [B, T, D], the class
    token [B, D]), fp32 (float64 for a float64 module). ``frames`` and
    ``crop`` size ``time_embed`` and ``pos_embed``; other inputs read them
    interpolated. ``build`` registers the layers on the module it is given
    and ``embed`` runs them (as ``ResNet18F2F``'s do), so that
    ``models.arv.ARVModel`` holds them at its top level."""

    trunk_name = "timesformer_divst"
    feat_dim = DIM  # the embeddings' width, ModelConfig.feat_dim
    data_sizes = {"frames": "train_frame", "crop": "input_size"}  # from a run's DataConfig
    foldable = False  # no BatchNorm to fold, no int8 version

    def __init__(self, dim: int = DIM, **kwargs):
        super().__init__()
        TimeSformer.build(self, dim, **kwargs)

    def build(self, dim: int = DIM, depth: int = DEPTH, heads: int = HEADS, mlp: int = MLP,
              patch: int = PATCH, frames: int = FRAMES, crop: int = CROP,
              drop_path: float = DROP_PATH, ln_eps: float = LN_EPS,
              dtype: torch.dtype = torch.float32, bn_eps: Optional[float] = None,
              bn_momentum: Optional[float] = None):
        """The layers on ``self`` (``bn_eps``, ``bn_momentum`` unread: no BatchNorm)."""
        if dim % heads or crop % patch:
            raise ValueError(f"width {dim} over {heads} heads, crop {crop} in patches of {patch}")
        self.dtype = dtype
        self.patch = patch
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (crop // patch) ** 2 + 1, dim))
        self.time_embed = nn.Parameter(torch.zeros(1, frames, dim))
        rates = torch.linspace(0, drop_path, depth, device="cpu").tolist()
        self.blocks = nn.ModuleList(Block(dim, heads, mlp, rates[i], ln_eps) for i in range(depth))
        self.norm = nn.LayerNorm(dim, eps=ln_eps)
        # the published init (vit.py VisionTransformer.__init__, _init_weights)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        for m in self.blocks.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)
        for i, blk in enumerate(self.blocks):
            if i > 0:
                nn.init.zeros_(blk.temporal_fc.weight)
                nn.init.zeros_(blk.temporal_fc.bias)

    def embed(self, x, train: bool = False, mesh=None, generator=None):
        """``x`` [B, T, H, W, 3] → (frame_embed [B, T, D], clip_embed
        [B, D]). ``train`` draws the drop-path masks from ``generator``."""
        b, t, h, w, c = x.shape
        pt = self.patch
        gh, gw = h // pt, w // pt
        x = x.to(self.dtype)
        with profiling.span("tsf.patch_embed"):
            # the patches in token order [B, N, T], each (row, col, channel)
            patches = x.reshape(b, t, gh, pt, gw, pt, c).permute(0, 2, 4, 1, 3, 5, 6)
            patches = patches.reshape(b, gh * gw * t, pt * pt * c)
            proj = self.patch_embed.proj
            weight = proj.weight.permute(0, 2, 3, 1).reshape(proj.weight.shape[0], -1)
            profiling.count("tsf.relayout_bytes", (patches.numel() + weight.numel())
                            * patches.element_size())
            tok = _affine(patches, weight, proj.bias)
            d = tok.shape[-1]
            tok = tok.view(b, gh * gw, t, d)
            pos = _pos_embed(self.pos_embed, gh, gw).to(x.dtype)
            tok = tok + pos[:, 1:, None]
            tok = tok + _time_embed(self.time_embed, t).to(x.dtype)[:, None]
            cls = (self.cls_token.to(x.dtype) + pos[:, :1]).expand(b, 1, d)
        profiling.count("tsf.tokens", b * (gh * gw * t + 1))
        for blk in self.blocks:
            cls, tok = blk(cls, tok, train, generator, mesh)
        cls = _norm(self.norm, cls)[:, 0]
        frame_embed = _norm(self.norm, tok).mean(dim=1)
        profiling.mark("tsf.end")
        out = torch.promote_types(self.dtype, torch.float32)
        return frame_embed.to(out), cls.to(out)


def param_count(dim: int = DIM, depth: int = DEPTH, mlp: int = MLP, patch: int = PATCH,
                frames: int = FRAMES, crop: int = CROP) -> int:
    """The trunk's parameters, counted from the layer equations."""
    attention = (dim * 3 * dim + 3 * dim) + (dim * dim + dim)
    block = 3 * 2 * dim + 2 * attention + (dim * dim + dim) + (dim * mlp + mlp) + (mlp * dim + dim)
    embed = (3 * patch * patch * dim + dim) + dim + ((crop // patch) ** 2 + 1) * dim + frames * dim
    return embed + depth * block + 2 * dim
