"""Exact pairwise L2 scoring — the FAISS IndexFlatL2 replacement.

Scores are −‖q−g‖² (higher is better), computed by the expansion
‖q‖² + ‖g‖² − 2·q·gᵀ in fp32. Kernel K1 (``csrc/sq_l2.cu``) is the
counterpart of vqwild_tpu/ops/pallas_kernels.py ``pairwise_sq_l2_pallas``.
Like the Pallas kernel it takes the cross term on the matrix unit with an
error-compensated multi-pass product: ``mma.sync`` TF32 in three passes
over a hi/lo split of both operands, which keeps fp32 accuracy. The
gallery goes from device memory straight into the ``mma`` operand
registers (no shared memory, no barrier in the K loop); both norms are
taken in fp32 from the unsplit values in the same pass; a small gallery is
split along D over the warps of a block so that the card is filled. The
design note is in the CUDA source.

``sq_l2`` launches the kernel on a CUDA tensor and runs the plain PyTorch
version, ``pairwise_sq_l2``, on a CPU tensor.
``pairwise_sq_l2_tf32_emulated`` repeats the kernel's split arithmetic in
plain PyTorch, for the tests. ``time_kernels.py`` beside this module
checks and times the kernel of a checkout on the card.
"""

from __future__ import annotations

import ctypes

import torch

from vqwild_tpu_torch.ops import _build
from vqwild_tpu_torch.ops.tf32 import split_sum

launches = _build.OpCounters("distance", ("fwd",))  # launches of the kernel


def pairwise_sq_l2(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[Q,D]×[G,D] → squared L2 distances [Q,G] (clamped ≥ 0), the plain
    expansion. Full fp32 needs ``torch.backends.cuda.matmul.allow_tf32``
    off on a GPU (core.device.disable_tf32)."""
    q = q.float()
    g = g.float()
    q2 = (q * q).sum(dim=-1, keepdim=True)
    g2 = (g * g).sum(dim=-1)[None, :]
    return torch.clamp_min(q2 + g2 - 2.0 * (q @ g.T), 0.0)


def pairwise_sq_l2_tf32_emulated(q: torch.Tensor, g: torch.Tensor,
                                 passes: int = 3) -> torch.Tensor:
    """``pairwise_sq_l2`` with the kernel's arithmetic: q and g are split
    into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` and the cross term is
    ``q_lo·g_hi + q_hi·g_lo + q_hi·g_hi``, each product exact and the sums in
    fp32; the norms come from the unsplit values. ``passes=1`` keeps only
    ``q_hi·g_hi``, plain TF32. Nothing on the serving path calls this; the
    tests hold the split's accuracy and its tie behaviour with it."""
    q = q.float()
    g = g.float()
    cross = split_sum(lambda a, b: a @ b.T, q, g, passes)
    q2 = (q * q).sum(dim=-1, keepdim=True)
    g2 = (g * g).sum(dim=-1)[None, :]
    return torch.clamp_min(q2 + g2 - 2.0 * cross, 0.0)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sq_l2_launch": (_I, _P, _P, _P, _I, _I, _I, _P),
               "sq_l2_plan": (_I, _I, _I, _I, ctypes.POINTER(_I))}


def _lib():
    return _build.bind("sq_l2", _SIGNATURES)


def launch_plan(nq: int, ng: int, d: int) -> dict:
    """What the launcher picks for a [nq,d]×[ng,d] call on the current
    card: ``split_k`` (warps of a block that share 32 gallery rows and
    take a slice of D each), ``grid`` and ``block`` (threads), and the
    dynamic shared memory in bytes. Needs the built kernel, so a GPU
    machine."""
    plan = (ctypes.c_int * 5)()
    _build.check(_lib().sq_l2_plan(nq, ng, d, plan), "sq_l2_plan")
    return {"split_k": plan[0], "grid": [plan[1], plan[2]], "block": plan[3],
            "smem_bytes": plan[4]}


def sq_l2(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[Q,D]×[G,D] fp32 → [Q,G] squared L2. A CPU tensor runs
    ``pairwise_sq_l2``; a CUDA tensor launches K1 on the current stream, or
    raises on anything it does not take."""
    if q.device.type == "cpu" and g.device.type == "cpu":
        return pairwise_sq_l2(q, g)
    if q.device.type != "cuda" or q.device != g.device:
        raise ValueError(f"sq_l2: q on {q.device}, g on {g.device}; both must be on one CUDA device")
    if q.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"sq_l2: takes float32, got {q.dtype} and {g.dtype}")
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"sq_l2: shapes {tuple(q.shape)} and {tuple(g.shape)}")
    if not (q.is_contiguous() and g.is_contiguous()):
        raise ValueError("sq_l2: q and g must be contiguous")
    nq, ng, d = q.shape[0], g.shape[0], q.shape[1]
    out = torch.empty((nq, ng), dtype=torch.float32, device=q.device)
    if nq == 0 or ng == 0:
        return out
    fn = _lib().sq_l2_launch
    with _build.on(q.device):
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), nq, ng, d, _build.stream(q.device))
    _build.check(rc, "sq_l2")
    launches.count("fwd")
    return out


def score_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Retrieval scores = −‖q−g‖², the reference's ``score = −D`` with FAISS
    squared distances."""
    return sq_l2(q, g).neg_()
