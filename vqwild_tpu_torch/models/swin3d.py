"""Video Swin Transformer (Swin-B, shifted 3D windows) as a trunk of the ARV
model.

Liu et al., "Video Swin Transformer", CVPR 2022 (arXiv:2106.13230); the
published code is SwinTransformer/Video-Swin-Transformer,
``mmaction/models/backbones/swin_transformer.py`` (``SwinTransformer3D``,
``BasicLayer``, ``SwinTransformerBlock3D``, ``WindowAttention3D``,
``PatchMerging``, ``PatchEmbed3D``, ``compute_mask``,
``get_window_size``), sized by
``configs/recognition/swin/swin_base_patch244_window877_kinetics400_1k.py``:
patch 2x4x4, embedding width 128, four stages of [2, 2, 18, 2] blocks at
widths 128-1,024 with [4, 8, 16, 32] heads of 32, window 8x7x7, MLP ratio 4,
qkv bias, LayerNorm eps 1e-5, exact GELU, no dropout, drop path linear over
the 24 blocks to 0.3, 32 frames of 224x224.

Input [B, T, H, W, 3] normalized RGB, zero-padded to whole patches:

- embedding: the 2x4x4x3 patches through the patch conv, then LayerNorm;
  no positional embedding. [B, D, H', W', C] at T/2 x H/4 x W/4.
- stage i (width C·2^i): its blocks, then (but the last) PatchMerging.
- block j: the window and the shift ((0, 0, 0) for even j, half the window
  for odd j) pass through ``get_window_size``: a dimension no larger than
  its window takes its size as the window and shift 0. ``r = norm1(x)``,
  zero-padded to whole windows after the norm (padded tokens take part in
  the attention, as published); where a shift is > 0, rolled by -shift,
  with ``compute_mask``'s -100 between tokens of different regions; the
  windows' attention: softmax(q kᵀ · 32^-0.5 + the relative-position bias
  ``table[index[:N, :N]]`` + the mask) v, then ``proj``; the windows put
  back, rolled by +shift, cropped; ``x = x + drop_path(r)``; then
  ``x = x + drop_path(fc2(GELU(fc1(norm2(x)))))``.
- PatchMerging: H and W padded to even, the 2x2 neighbours concatenated in
  the published order (0,0), (1,0), (0,1), (1,1), LayerNorm(4C), then the
  bias-free ``reduction`` to 2C.
- output: ``norm``; the clip embedding is the mean over every final token
  [B, 1024] (the published I3D head's average pool), and ``frame_embed``
  each tubelet's spatial mean, given to both of its frames [B, T, 1024]:
  an addition of the port's, for the evaluators' per-frame [B, C, T]
  contract.

Drop path is drawn per clip as timm's ``DropPath`` draws it, block by
block: the attention branch's mask, then the MLP's; block k of the 24 has
the rate ``linspace(0, drop_path, 24)[k]``, so block 0 draws nothing. The
masks come from the caller's generator, in float32 whatever the compute
dtype (models/timesformer.drop_path_mask).

The arithmetic is the published code's; the layout is the port's. Tokens
stay [B, D, H, W, C], channels last, from the embedding to the final norm
(the published stages move channels first and back at each stage's ends).
The window partition lays the windows out minor, [B, N, nW, C] for N
tokens a window (published: [B·nW, N, C]), so that q, k and v, each its
own product with its third of ``attn.qkv``, are [B, nW·heads, N, 32] views
and the bias and the mask, one [nW·heads, N, N] table a block, broadcast
over the clips inside ``F.scaled_dot_product_attention``'s float
``attn_mask``; the attention's output comes back [B, N, nW, C] as a view.
Its gradient flows into the bias table through that mask. A CUDA float32
call of head_dim 32 over at most 392 tokens a window (every Swin-B stage)
runs on K6 instead (``ops/window_attention.py``): q, k and v as the qkv
products write them, [B, N, nW·C], the bias formed inside the kernel from
the table, the index and the shift's region ids [nW, N]
(``compute_regions``), the output in the layout ``proj`` reads, and the
table's gradient summed inside the kernel. Every other call (the CPU,
float64, bf16, a shape K6 does not take) runs SDPA; on a card SDPA is held
to the memory-efficient kernel (float32 through error-compensated TF32
products; its backward writes the mask's gradient at full size, which
autograd reduces over the clips and windows) or the math kernel
(models/timesformer._sdpa_backends): never a kernel that computes float32
in TF32 or less. The patch conv runs as one matrix
product over patches gathered in token order (a relayout), each patch in
its weight's (channel, frame, row, col) order, the weight [C, 3, 2, 4, 4]
read as the view [C, 3·2·4·4]. The linears, the patch product and
the merges' reductions run on K4 (``ops/linear.py``) for a CUDA float32
input and in ``F.linear`` for any other (models/timesformer._affine).

The keys are the published ones, at the top level of the module that
holds the trunk: ``patch_embed.{proj, norm}.*``, ``layers.{i}.blocks.{j}.
{norm1, attn.relative_position_bias_table, attn.relative_position_index,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``layers.{i}.downsample.
{norm, reduction}.*``, ``norm.*``; the index is a persistent buffer, as
published, so that a published checkpoint loads strict. The trunk has no
BatchNorm, so it takes a ``mesh`` for its drop-path masks alone.

Under a profiler it records (core/profiling.py) the spans
``swin.patch_embed``, and ``swin.attn`` and ``swin.mlp`` in each block and
``swin.merge`` at each merge; device markers at the start of each of those
parts (``swin.attn``, ``swin.mlp``, ``swin.merge``) and after the final
norm (``swin.end``); and the counters ``swin.tokens`` (tokens a forward
embeds), ``swin.attn.s1`` to ``swin.attn.s4`` (window-attention calls, one
a block over the batch, by stage) and ``swin.relayout_bytes`` (the bytes
the forward copies only to change a layout: the patch gather, each pad to
whole patches, windows or merges, each roll and its inverse, each window
partition and reverse, each merge's gather).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.models import timesformer as tsf
from vqwild_tpu_torch.ops import window_attention as window_ops

# swin_base_patch244_window877_kinetics400_1k, 32 frames of 224x224
EMBED, DEPTHS, HEADS = 128, (2, 2, 18, 2), (4, 8, 16, 32)
WINDOW, PATCH, MLP_RATIO, FRAMES, CROP = (8, 7, 7), (2, 4, 4), 4, 32, 224
DROP_PATH, LN_EPS = 0.3, 1e-5

Dims = Tuple[int, int, int]


def get_window_size(x_size: Sequence[int], window: Sequence[int],
                    shift: Sequence[int]) -> Tuple[Dims, Dims]:
    """The published ``get_window_size``: a dimension no larger than its
    window takes its size as the window and shift 0."""
    w, s = list(window), list(shift)
    for i, n in enumerate(x_size):
        if n <= window[i]:
            w[i], s[i] = n, 0
    return tuple(w), tuple(s)


def relative_position_index(window: Sequence[int]) -> torch.Tensor:
    """[N, N] int64 over a window's N tokens: ``rd·(2wh−1)(2ww−1) +
    rh·(2ww−1) + rw`` of each pair's relative coordinates, each offset by
    its window size − 1 (WindowAttention3D.__init__)."""
    wd, wh, ww = window
    coords = torch.stack(torch.meshgrid(torch.arange(wd), torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([wd - 1, wh - 1, ww - 1])
    return (rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])).sum(-1)


def window_partition(x: torch.Tensor, window: Dims) -> torch.Tensor:
    """[B, D, H, W, C] (whole windows) → [B, N, nW, C]: each window's tokens
    (d, h, w within it) by windows (d, h, w of the window grid), windows
    minor. One copy."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, wd * wh * ww, -1, c)


def window_reverse(x: torch.Tensor, window: Dims, grid: Dims) -> torch.Tensor:
    """``window_partition``'s inverse: [B, N, nW, C] → [B, D, H, W, C]. One
    copy."""
    b, _, _, c = x.shape
    (wd, wh, ww), (d, h, w) = window, grid
    x = x.view(b, wd, wh, ww, d // wd, h // wh, w // ww, c).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, d, h, w, c)


def compute_regions(grid: Dims, window: Dims, shift: Dims, device) -> torch.Tensor:
    """Each token's region of the rolled, padded ``grid`` by window: [nW, N]
    int32 (windows in ``window_partition``'s grid order), the ids that the
    published ``compute_mask`` compares."""
    img = torch.zeros((1,) + tuple(grid) + (1,), dtype=torch.int32, device=device)
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window, shift)]
    for d in cuts[0]:
        for h in cuts[1]:
            for w in cuts[2]:
                img[:, d, h, w, :] = cnt
                cnt += 1
    return window_partition(img, window)[0, :, :, 0].t().contiguous()


def _relayout(t: torch.Tensor) -> torch.Tensor:
    profiling.count("swin.relayout_bytes", t.numel() * t.element_size())
    return t


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
           scale: float) -> torch.Tensor:
    """softmax(q kᵀ · scale + bias) v of q, k, v [B, nW·heads, N, hd] and
    the bias [1, nW·heads, N, N], broadcast over B;
    ``F.scaled_dot_product_attention``, on a card held to the
    memory-efficient kernel or the math kernel."""
    with tsf._sdpa_backends(q):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)


def windowed(x: torch.Tensor, length: int, head_dim: int) -> bool:
    """Whether the window attention over ``x`` runs on K6
    (``ops/window_attention.py``): a CUDA float32 input of windows and heads
    the kernels take (head_dim 32, at most 392 tokens); every other (the
    CPU, float64, bf16, any other shape) runs ``attend``."""
    return x.is_cuda and x.dtype == torch.float32 and window_ops.takes(length, head_dim)


class WindowAttention3D(nn.Module):
    """Multi-head self-attention within windows with the published
    relative-position bias, on [B, N, nW, C]."""

    def __init__(self, dim: int, window: Dims, heads: int):
        super().__init__()
        self.heads = heads
        wd, wh, ww = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def _load_from_state_dict(self, *args, **kwargs):
        # K6 reads the index as row plus column offsets: refuse a loaded
        # index that is not of that form
        super()._load_from_state_dict(*args, **kwargs)
        window_ops.check_index(self.relative_position_index,
                               self.relative_position_bias_table.shape[0])

    def bias(self, n: int, nw: int, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
        """[1, nW·heads, N, N]: ``table[index[:N, :N]]`` by head, plus the
        window's mask, one table for every clip."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        rel = self.relative_position_bias_table.to(dtype)[idx].view(n, n, -1)
        # contiguous, so that the sum with the mask is too: the card's fused
        # kernels take no mask whose last dimension is strided
        rel = rel.permute(2, 0, 1).contiguous()
        out = rel.expand(nw, -1, n, n) if mask is None else rel[None] + mask.to(dtype)[:, None]
        return out.reshape(1, nw * self.heads, n, n)

    def forward(self, x: torch.Tensor, regions: Optional[torch.Tensor]) -> torch.Tensor:
        """``regions`` [nW, N]: the shift's region ids (``compute_regions``),
        None for an unshifted block. K6 compares them inside the kernel;
        SDPA takes them as the mask ``region_mask`` builds."""
        b, n, nw, c = x.shape
        hd = c // self.heads
        w, bias = self.qkv.weight, self.qkv.bias
        # q, k and v each its own product, [B, N, nW·C]: K6 reads them as they lie,
        # SDPA through [B, nW·heads, N, hd] views
        q, k, v = (tsf._affine(x, w[i * c:(i + 1) * c], bias[i * c:(i + 1) * c])
                   .view(b, n, nw * c) for i in range(3))
        if windowed(x, n, hd):
            o = window_ops.window_attention(q, k, v, self.relative_position_bias_table,
                                            self.relative_position_index[:n, :n], regions,
                                            self.heads, hd ** -0.5)
            return tsf._linear(self.proj, o.view(b, n, nw, c))
        q, k, v = (t.view(b, n, nw * self.heads, hd).transpose(1, 2) for t in (q, k, v))
        mask = None if regions is None else window_ops.region_mask(regions, x.dtype)
        o = attend(q, k, v, self.bias(n, nw, mask, x.dtype), hd ** -0.5)
        return tsf._linear(self.proj, o.transpose(1, 2).reshape(b, n, nw, c))


class SwinTransformerBlock3D(nn.Module):
    def __init__(self, dim: int, heads: int, window: Dims, shift: Dims, hidden: int,
                 drop_path: float, eps: float, stage: int):
        super().__init__()
        self.window, self.shift, self.stage = window, shift, stage
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = WindowAttention3D(dim, window, heads)
        self.drop_path = drop_path
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = tsf.Mlp(dim, hidden)

    def forward(self, x: torch.Tensor, regions: Optional[torch.Tensor], train: bool,
                generator: Optional[torch.Generator], mesh=None) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        window, shift = get_window_size((d, h, w), self.window, self.shift)
        p, dev = self.drop_path, x.device
        profiling.mark("swin.attn")
        with profiling.span("swin.attn"):
            r = tsf._norm(self.norm1, x)
            pad = [(-n) % s for n, s in zip((d, h, w), window)]
            if any(pad):
                r = _relayout(F.pad(r, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0])))
            grid = tuple(r.shape[1:4])
            if any(shift):
                r = _relayout(torch.roll(r, tuple(-s for s in shift), (1, 2, 3)))
            r = self.attn(_relayout(window_partition(r, window)), regions if any(shift) else None)
            profiling.count(f"swin.attn.s{self.stage}")
            r = _relayout(window_reverse(r, window, grid))
            if any(shift):
                r = _relayout(torch.roll(r, shift, (1, 2, 3)))
            r = r[:, :d, :h, :w]
            x = x + tsf._drop(r, tsf.drop_path_mask(b, p, train, generator, dev, mesh), p)
        profiling.mark("swin.mlp")
        with profiling.span("swin.mlp"):
            r = self.mlp(tsf._norm(self.norm2, x))
            x = x + tsf._drop(r, tsf.drop_path_mask(b, p, train, generator, dev, mesh), p)
        return x


class PatchMerging(nn.Module):
    """[B, D, H, W, C] → [B, D, ⌈H/2⌉, ⌈W/2⌉, 2C]."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        profiling.mark("swin.merge")
        with profiling.span("swin.merge"):
            h, w = x.shape[2:4]
            if h % 2 or w % 2:
                x = _relayout(F.pad(x, (0, 0, 0, w % 2, 0, h % 2)))
            x = _relayout(torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                                     x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1))
            return tsf._affine(tsf._norm(self.norm, x), self.reduction.weight, None)


class BasicLayer(nn.Module):
    """A stage: its blocks (the odd ones shifted), then its merge."""

    def __init__(self, dim: int, depth: int, heads: int, window: Dims, hidden: int,
                 rates: Sequence[float], eps: float, downsample: bool, stage: int):
        super().__init__()
        self.window = window
        self.shift = tuple(s // 2 for s in window)
        self.blocks = nn.ModuleList(
            SwinTransformerBlock3D(dim, heads, window, (0, 0, 0) if j % 2 == 0 else self.shift,
                                   hidden, rates[j], eps, stage) for j in range(depth))
        self.downsample = PatchMerging(dim, eps) if downsample else None

    def forward(self, x, train, generator, mesh=None):
        window, shift = get_window_size(x.shape[1:4], self.window, self.shift)
        regions = None
        if any(shift):
            grid = tuple(math.ceil(n / s) * s for n, s in zip(x.shape[1:4], window))
            regions = compute_regions(grid, window, shift, x.device)
        for blk in self.blocks:
            x = blk(x, regions, train, generator, mesh)
        return x if self.downsample is None else self.downsample(x)


class SwinTransformer3D(nn.Module):
    """The trunk: [B, T, H, W, 3] float → (frame_embed [B, T, C], the
    clip's mean token [B, C]) at C = ``embed_dim``·2^(stages − 1), fp32
    (float64 for a float64 module). ``build`` registers the layers on the
    module it is given and ``embed`` runs them (as ``ResNet18F2F``'s do),
    so that ``models.arv.ARVModel`` holds them at its top level."""

    trunk_name = "swin3d_b"
    feat_dim = EMBED * 2 ** (len(DEPTHS) - 1)  # the embeddings' width, ModelConfig.feat_dim
    data_sizes = {"frames": "train_frame", "crop": "input_size"}  # from a run's DataConfig
    foldable = False  # no BatchNorm to fold, no int8 version

    def __init__(self, dim: int = feat_dim, **kwargs):
        super().__init__()
        SwinTransformer3D.build(self, dim, **kwargs)

    def build(self, dim: int = feat_dim, embed_dim: int = EMBED,
              depths: Sequence[int] = DEPTHS, heads: Sequence[int] = HEADS,
              window: Sequence[int] = WINDOW, patch: Sequence[int] = PATCH,
              mlp_ratio: int = MLP_RATIO, frames: int = FRAMES, crop: int = CROP,
              drop_path: float = DROP_PATH, ln_eps: float = LN_EPS,
              dtype: torch.dtype = torch.float32, bn_eps: Optional[float] = None,
              bn_momentum: Optional[float] = None):
        """The layers on ``self``. ``frames`` and ``crop`` (the clips the
        trunk is sized for by the command line), ``bn_eps`` and
        ``bn_momentum`` are unread: the trunk has no positional table and
        no BatchNorm; it takes any clip."""
        stages = len(depths)
        if dim != embed_dim * 2 ** (stages - 1) or len(heads) != stages:
            raise ValueError(f"width {dim} from {embed_dim} over {stages} stages, "
                             f"{len(heads)} head counts")
        if any(embed_dim * 2 ** i % h for i, h in enumerate(heads)):
            raise ValueError(f"widths from {embed_dim} over heads {tuple(heads)}")
        self.dtype = dtype
        self.patch = tuple(patch)
        pt, ph, pw = self.patch
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(3, embed_dim, self.patch, self.patch)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=ln_eps)
        rates = torch.linspace(0, drop_path, sum(depths), device="cpu").tolist()
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            c = embed_dim * 2 ** i
            first = sum(depths[:i])
            self.layers.append(BasicLayer(c, depth, heads[i], tuple(window), mlp_ratio * c,
                                          rates[first:first + depth], ln_eps, i < stages - 1,
                                          i + 1))
        self.norm = nn.LayerNorm(dim, eps=ln_eps)
        # the published init (SwinTransformer3D._init_weights, WindowAttention3D.__init__)
        for m in self.layers.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention3D):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02)

    def embed(self, x, train: bool = False, mesh=None, generator=None):
        """``x`` [B, T, H, W, 3] → (frame_embed [B, T, C], clip_embed
        [B, C]). ``train`` draws the drop-path masks from ``generator``."""
        b, t, h, w, c = x.shape
        pt, ph, pw = self.patch
        x = x.to(self.dtype)
        with profiling.span("swin.patch_embed"):
            pad = ((-t) % pt, (-h) % ph, (-w) % pw)
            if any(pad):
                x = _relayout(F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0])))
            gd, gh, gw = (t + pad[0]) // pt, (h + pad[1]) // ph, (w + pad[2]) // pw
            # the patches in token order [B, D, H', W'], each (channel, frame, row,
            # col) as the conv's weight holds them: the weight is read as a view, so
            # its gradient keeps the weight's layout (a permuted gradient sends
            # Adam's foreach updates over every leaf one launch a leaf)
            patches = x.reshape(b, gd, pt, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
            patches = _relayout(patches.reshape(b, gd, gh, gw, c * pt * ph * pw))
            proj = self.patch_embed.proj
            weight = proj.weight.reshape(proj.weight.shape[0], -1)
            x = tsf._norm(self.patch_embed.norm, tsf._affine(patches, weight, proj.bias))
        profiling.count("swin.tokens", b * gd * gh * gw)
        for layer in self.layers:
            x = layer(x, train, generator, mesh)
        x = tsf._norm(self.norm, x)
        clip_embed = x.mean(dim=(1, 2, 3))
        frame_embed = x.mean(dim=(2, 3)).repeat_interleave(pt, dim=1)[:, :t]
        profiling.mark("swin.end")
        out = torch.promote_types(self.dtype, torch.float32)
        return frame_embed.to(out), clip_embed.to(out)


def param_count(embed_dim: int = EMBED, depths: Sequence[int] = DEPTHS,
                heads: Sequence[int] = HEADS, window: Sequence[int] = WINDOW,
                patch: Sequence[int] = PATCH, mlp_ratio: int = MLP_RATIO) -> int:
    """The trunk's parameters, counted from the layer equations."""
    table = math.prod(2 * s - 1 for s in window)
    total = 3 * math.prod(patch) * embed_dim + embed_dim + 2 * embed_dim  # patch conv and norm
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed_dim * 2 ** i
        hidden = mlp_ratio * c
        attention = table * h + (3 * c * c + 3 * c) + (c * c + c)
        total += depth * (2 * c + attention + 2 * c + (c * hidden + hidden) + (hidden * c + c))
        if i < len(depths) - 1:
            total += 2 * 4 * c + 4 * c * 2 * c  # the merge's norm and reduction
    return total + 2 * embed_dim * 2 ** (len(depths) - 1)
