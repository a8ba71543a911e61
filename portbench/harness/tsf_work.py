"""The operations and bytes of TimeSformer's divided space-time trunk,
counted from its layer equations (vqwild_tpu_torch/models/timesformer.py;
the published vit.py): a multiply-add is two operations, LayerNorms,
softmaxes, GELUs and adds are not counted.

A clip of T frames of crop x crop in patches of p has N = (crop/p)^2 patch
tokens a frame and N·T tokens, plus one class token. A block's temporal
path is its qkv, its attention over T frames at each of the N positions,
its proj and ``temporal_fc`` on the N·T tokens; its spatial path the qkv,
the attention over N + 1 tokens of each frame (the class token's copy
included) and the proj on T·(N + 1) rows; its MLP fc1 and fc2 on the
N·T + 1 tokens.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.harness.peaks import least_seconds


def patch_macs(frames: int, crop: int, patch: int, dim: int) -> int:
    """The patch embedding's multiply-adds for one clip."""
    return (crop // patch) ** 2 * frames * 3 * patch * patch * dim


def forward_macs(frames: int = 8, crop: int = 224, patch: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12, mlp: int = 3072) -> int:
    """The trunk's forward multiply-adds for one clip."""
    n = (crop // patch) ** 2
    tok, hd = n * frames, dim // heads
    temporal = tok * dim * 3 * dim + n * heads * 2 * frames * frames * hd + 2 * tok * dim * dim
    spatial = (frames * (n + 1) * dim * 3 * dim + frames * heads * 2 * (n + 1) ** 2 * hd
               + frames * (n + 1) * dim * dim)
    return patch_macs(frames, crop, patch, dim) + depth * (temporal + spatial
                                                           + (tok + 1) * 2 * dim * mlp)


def train_flops_per_clip(frames: int = 8, crop: int = 224, patch: int = 16, dim: int = 768,
                         depth: int = 12, heads: int = 12, mlp: int = 3072) -> float:
    """Forward and backward: every product's forward, its input gradient
    and its weight gradient (an attention product's two input gradients),
    but the patch embedding's input gradient, which the data needs not."""
    fwd = forward_macs(frames, crop, patch, dim, depth, heads, mlp)
    return 2.0 * (3 * fwd - patch_macs(frames, crop, patch, dim))


def attention_work(seqs: int, heads: int, length: int, head_dim: int,
                   itemsize: int = 4) -> Tuple[float, float]:
    """One attention call's forward and backward over ``seqs`` sequences:
    the forward's q kᵀ and p v, the backward's five products (q kᵀ again,
    dv, dp, dq, dk), 2·L²·d operations each a (sequence, head); the bytes of
    q, k, v, o, do, dq, dk and dv, each once."""
    per = seqs * heads
    return 7 * 2.0 * per * length * length * head_dim, 8.0 * itemsize * per * length * head_dim


def attention_calls(clips: int, frames: int, crop: int, patch: int, dim: int,
                    heads: int) -> Dict[str, Tuple[int, int, int, int]]:
    """(sequences, heads, length, head dim) of a block's temporal and
    spatial attention calls on ``clips`` clips."""
    n, hd = (crop // patch) ** 2, dim // heads
    return {"temporal": (clips * n, heads, frames, hd),
            "spatial": (clips * frames, heads, n + 1, hd)}


def attention_least_seconds(calls: Dict[str, int], clips: int, frames: int, crop: int,
                            patch: int, dim: int, heads: int) -> float:
    """The least time of ``calls[kind]`` attention calls of each kind,
    forward and backward, each call at the larger of its operations over the
    float32 peak and its bytes over the memory rate."""
    shapes = attention_calls(clips, frames, crop, patch, dim, heads)
    return sum(calls[kind] * least_seconds(*attention_work(*shapes[kind])) for kind in shapes)
