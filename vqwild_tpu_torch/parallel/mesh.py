"""The data mesh over the ranks of a process group, and its collectives.

Counterpart of vqwild_tpu/parallel/mesh.py. The JAX package shards a
global batch over the ``data`` axis of a ``jax.sharding.Mesh`` and lets XLA
insert the gradient sums and the gallery gathers. Here each rank is one
process holding one contiguous row block of the global batch, and the
port's modules call the collectives below where XLA would insert them:
``all_sum`` (gradients, loss shares, BatchNorm's gradient sums),
``gather`` (BatchNorm's statistics, the EMA memory's rows, the ranking
loss's triplets, embeddings, score columns and the moment engine's
per-query rows) and ``broadcast`` (rank 0's int8 calibration).

``batch_sharding``, ``replicated_sharding`` and ``scan_batch_sharding``
have no counterpart: a sharding is JAX's description of where an array
lives, and here every tensor lives on one rank's device. A replicated
array is a tensor every rank holds; a batch-sharded one is the rank's row
block (``Mesh.rows``, ``shard_batch_arrays``); a scan-stacked batch is its
rows block along the second axis (train/loop.py).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from vqwild_tpu_torch.parallel.distributed import rank_device


class Mesh:
    """One data axis over the process group's ranks: ``shape["data"]`` (the
    world size), ``rank``, ``device`` (this rank's) and ``group`` (the
    process group; None in a single-process runtime, where every collective
    is the identity)."""

    def __init__(self, world: int, rank: int, device: torch.device, group=None):
        self.shape = {"data": world}
        self.rank = rank
        self.device = device
        self.group = group

    @property
    def size(self) -> int:
        return self.shape["data"]

    def rows(self, n_padded: int) -> slice:
        """This rank's contiguous row block of ``n_padded`` rows (a multiple
        of the world size)."""
        if n_padded % self.size:
            raise ValueError(f"{n_padded} rows do not split evenly over {self.size} ranks")
        per = n_padded // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum of ``t`` over the ranks (returns ``t``)."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: rank ``src``'s ``t`` on every rank (returns ``t``;
        every rank passes a tensor of the same shape and dtype)."""
        if self.group is not None:
            dist.broadcast(t, src=src, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on every rank. Differentiable: the gradient of a rank's
        block is the sum over the ranks of the gradient each saw for it."""
        if self.size == 1:
            return t
        return _Gather.apply(t, self, dim)

    def _gather_exact(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: the ranks' tensors, stacked in rank order. An
        all-reduce of a zeroed buffer holding each rank's tensor at its own
        index: one code path for nccl, and for gloo on CPU and CUDA tensors
        alike. Exact: every sum adds zeros to one value; a -0.0 comes back
        +0.0. Booleans travel as uint8."""
        dtype = t.dtype
        src = t.to(torch.uint8) if dtype == torch.bool else t
        buf = src.new_zeros((self.size,) + tuple(src.shape))
        buf[self.rank].copy_(src)
        self.all_sum(buf)
        return buf.to(torch.bool) if dtype == torch.bool else buf


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, t.shape[dim]
        return torch.cat(mesh._gather_exact(t.contiguous()).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_sum(g.contiguous().clone())
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


def make_mesh(shape: Tuple[int, ...] = (), axes: Tuple[str, ...] = ("data",),
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """shape () → every rank of the process group on one ``data`` axis (one
    rank when no group was started: parallel/distributed.initialize). Only
    the data axis exists: the JAX package's reserved ``model`` axis shards
    nothing of this model. ``device``: see distributed.rank_device."""
    world, rank, group = 1, 0, None
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    if tuple(axes) != ("data",) or shape not in ((), (world,)):
        raise ValueError(f"the port's mesh is one data axis over the {world} ranks; got "
                         f"shape {shape} axes {axes}")
    return Mesh(world, rank, rank_device(device), group)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad (by edge-repeat) so arr.shape[axis] % multiple == 0; returns
    (padded, original_length). Ranks hold equal row blocks. A host copy."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_idx = np.concatenate([np.arange(n), np.full(rem, n - 1)])
    return np.take(arr, pad_idx, axis=axis), n


def rank_rows(n: int, rank: int, world: int) -> np.ndarray:
    """The rows of ``n`` that make up ``rank``'s block of the batch padded
    to a multiple of ``world`` by ``pad_to_multiple``: its positions, the
    padding's mapped to the last row."""
    per = -(-n // world)
    return np.minimum(np.arange(rank * per, (rank + 1) * per), n - 1)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """This rank's contiguous row block of each array (leading dim a
    multiple of the world size), as a tensor on the rank's device."""
    out = []
    for a in arrays:
        block = np.ascontiguousarray(np.asarray(a)[mesh.rows(len(a))])
        out.append(torch.from_numpy(block).to(mesh.device))
    return tuple(out)
