"""The operations and bytes of the Video Swin trunk, counted from its layer
equations (vqwild_tpu_torch/models/swin3d.py; the published
swin_transformer.py): a multiply-add is two operations; LayerNorms,
softmaxes, GELUs, the bias and mask adds, rolls and copies are not counted.

A clip of T frames of crop x crop in patches of pt x ph x pw is a grid of
⌈T/pt⌉ x ⌈crop/ph⌉ x ⌈crop/pw⌉ tokens at the embedding width C. At each
stage the window and the shift shrink where the grid is no larger
(``get_window_size``), and the grid is padded to whole windows: qkv, the
attention and proj run on the padded tokens, the MLP on the grid's. A
token's linears are 3C² (qkv), C² (proj) and 2·r·C² (fc1, fc2 at MLP ratio
r); a window of N tokens does 2·N²·C multiply-adds of attention (q kᵀ and
p v over its heads). Each merge but the last stage's pads H and W to even
and reduces its ⌈H/2⌉·⌈W/2⌉ tokens a frame from 4C to 2C.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence, Tuple

from portbench.harness.peaks import least_seconds
from portbench.harness.tsf_work import attention_work


def stages(frames: int, crop: int, patch: Sequence[int], embed_dim: int,
           depths: Sequence[int], window: Sequence[int]) -> Iterator[dict]:
    """Each stage's width ``c``, tokens a clip ``tokens``, padded tokens
    ``padded``, windows a clip ``windows`` and tokens a window ``n``."""
    grid = [math.ceil(frames / patch[0]), math.ceil(crop / patch[1]), math.ceil(crop / patch[2])]
    for i in range(len(depths)):
        win = [min(g, w) for g, w in zip(grid, window)]
        padded = [math.ceil(g / w) * w for g, w in zip(grid, win)]
        yield {"c": embed_dim * 2 ** i, "tokens": math.prod(grid), "padded": math.prod(padded),
               "windows": math.prod(p // w for p, w in zip(padded, win)), "n": math.prod(win)}
        grid = [grid[0], math.ceil(grid[1] / 2), math.ceil(grid[2] / 2)]


def patch_macs(frames: int, crop: int, patch: Sequence[int], embed_dim: int) -> int:
    """The patch embedding's multiply-adds for one clip."""
    tokens = (math.ceil(frames / patch[0]) * math.ceil(crop / patch[1])
              * math.ceil(crop / patch[2]))
    return tokens * 3 * math.prod(patch) * embed_dim


def forward_macs(frames: int = 32, crop: int = 224, patch: Sequence[int] = (2, 4, 4),
                 embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 window: Sequence[int] = (8, 7, 7), mlp_ratio: int = 4) -> int:
    """The trunk's forward multiply-adds for one clip."""
    total = patch_macs(frames, crop, patch, embed_dim)
    st = list(stages(frames, crop, patch, embed_dim, depths, window))
    for i, s in enumerate(st):
        c = s["c"]
        block = s["padded"] * (4 * c * c + 2 * s["n"] * c) + s["tokens"] * 2 * mlp_ratio * c * c
        total += depths[i] * block
        if i + 1 < len(st):
            total += st[i + 1]["tokens"] * 4 * c * 2 * c
    return total


def train_flops_per_clip(frames: int = 32, crop: int = 224, patch: Sequence[int] = (2, 4, 4),
                         embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                         window: Sequence[int] = (8, 7, 7), mlp_ratio: int = 4) -> float:
    """Forward and backward: every product's forward, its input gradient
    and its weight gradient (an attention product's two input gradients),
    but the patch embedding's input gradient, which the data needs not."""
    fwd = forward_macs(frames, crop, patch, embed_dim, depths, window, mlp_ratio)
    return 2.0 * (3 * fwd - patch_macs(frames, crop, patch, embed_dim))


def attention_calls(clips: int, frames: int, crop: int, patch: Sequence[int], embed_dim: int,
                    depths: Sequence[int], heads: Sequence[int],
                    window: Sequence[int]) -> Dict[str, Tuple[int, int, int, int]]:
    """(sequences, heads, length, head dim) of each stage's window-attention
    call (one a block, over every clip's windows), by ``s1``..``s4``."""
    return {f"s{i + 1}": (clips * s["windows"], heads[i], s["n"], s["c"] // heads[i])
            for i, s in enumerate(stages(frames, crop, patch, embed_dim, depths, window))}


def attention_call_work(seqs: int, heads: int, length: int, head_dim: int,
                        windows: int) -> Tuple[float, float]:
    """One window-attention call's forward and backward: ``tsf_work``'s
    attention work (the products, and q, k, v, o, dO, dq, dk, dv once)
    plus the bias over a clip's ``windows`` windows, once, in float32."""
    flops, nbytes = attention_work(seqs, heads, length, head_dim)
    return flops, nbytes + 4.0 * windows * heads * length * length


def attention_least_seconds(calls: Dict[str, int], clips: int, frames: int, crop: int,
                            patch: Sequence[int], embed_dim: int, depths: Sequence[int],
                            heads: Sequence[int], window: Sequence[int]) -> float:
    """The least time of ``calls[stage]`` window-attention calls of each
    stage, forward and backward, each call at the larger of its operations
    over the float32 peak and its bytes over the memory rate."""
    shapes = attention_calls(clips, frames, crop, patch, embed_dim, depths, heads, window)
    return sum(calls.get(s, 0) * least_seconds(*attention_call_work(*shape, shape[0] // clips))
               for s, shape in shapes.items())
