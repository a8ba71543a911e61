"""Exact pairwise L2 scoring — the FAISS IndexFlatL2 replacement.

Scores are −‖q−g‖² (higher is better), computed by the expansion
‖q‖² + ‖g‖² − 2·q·gᵀ in fp32. Kernel K1 (``csrc/sq_l2.cu``) is the
counterpart of vqwild_tpu/ops/pallas_kernels.py ``pairwise_sq_l2_pallas``:
``sq_l2`` launches it on a CUDA tensor and runs the plain PyTorch version,
``pairwise_sq_l2``, on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vqwild_tpu_torch.ops import _build

launches = _build.LaunchCount()


def pairwise_sq_l2(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[Q,D]×[G,D] → squared L2 distances [Q,G] (clamped ≥ 0), the plain
    expansion. Full fp32 needs ``torch.backends.cuda.matmul.allow_tf32``
    off on a GPU (core.device.disable_tf32)."""
    q = q.float()
    g = g.float()
    q2 = (q * q).sum(dim=-1, keepdim=True)
    g2 = (g * g).sum(dim=-1)[None, :]
    return torch.clamp_min(q2 + g2 - 2.0 * (q @ g.T), 0.0)


def _lib():
    lib = _build.load("sq_l2")
    fn = lib.sq_l2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), g.data_ptr(), out.data_ptr(), nq, ng, d, stream)
    _build.check(rc, "sq_l2")
    launches.add()
    return out


def score_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Retrieval scores = −‖q−g‖², the reference's ``score = −D`` with FAISS
    squared distances."""
    return sq_l2(q, g).neg_()
