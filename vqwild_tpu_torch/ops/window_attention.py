"""Kernel K6: windowed multi-head self-attention with a relative-position
bias and a shifted window's mask, fp32 on the tensor cores, forward and
backward: the Video Swin trunk's window attention (models/swin3d.py).

``window_attention(q, k, v, table, index, regions, heads, scale)`` takes q,
k and v [B, N, nW·C] as the trunk's three qkv products write them (each
token's row holds the nW windows' heads side by side: windows, then heads,
then head_dim 32) and returns o [B, N, nW·C] in the same layout, as the
output projection reads it. For each (clip, window w, head h) it computes
softmax(q kᵀ · scale + bias) v with ``bias[i, j] = table[index[i, j], h]``
plus ``MASK`` where ``regions[w, i] != regions[w, j]`` (``regions`` [nW, N]
int32, the shift's region ids, or None for an unshifted block): rel and mask
added first, then the scaled score, as ``WindowAttention3D.bias`` does.
``index`` is the window's relative-position index [N, N]; the kernels read
only its first row and column, since ``index[i, j] = index[i, 0] +
index[0, j] - index[0, 0]`` for any relative index of coordinates, with no
two columns at one offset (``check_index``; the trunk checks its index
where it is built or loaded). Its
gradient goes to q, k, v (in their layout) and to the table [T, heads],
summed over the clips, the windows and each offset's (i, j) inside the
kernels. It replaces no TPU kernel (the JAX package has no Swin); the CUDA
source and its design note are ``csrc/window_attention.cu``.

A CUDA fp32 input launches the kernels (a ``torch.autograd.Function``: the
forward keeps q, k, v, o and each row's log-sum-exp, the backward
recomputes the softmax) or raises on a shape they do not take (``takes``:
head_dim 32 and 1 <= N <= 392; a table of at most 2,560 rows). A CPU tensor
runs the plain PyTorch version, ``window_attention_plain``. An input or
gradient that is not contiguous, or not 16-byte aligned, is copied first.

Launches are counted per pass in ``launches`` (always) and, from the same
call while the recorder is on, as the counters ``window_attention.fwd``,
``window_attention.bwd``, ``window_attention.flop`` (the products at 2·N²·32
for each (clip, window, head): two forward, five backward; ``work``) and
``window_attention.bytes`` (q, k, v and o forward; q, k, v, dO, dq, dk and dv
backward; the table once a pass) (``_build.OpCounters``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from vqwild_tpu_torch.ops import _build

PASSES = ("fwd", "bwd")
launches = _build.OpCounters("window_attention", PASSES)

HEAD_DIM = 32
MAX_LENGTH = 392  # an 8x7x7 window
MAX_TABLE = 2560  # rows of the bias table the kernels hold in shared memory
MASK = -100.0  # the logit added between tokens of two regions of a shifted window


def takes(length: int, head_dim: int) -> bool:
    """Whether the kernels take windows of ``length`` tokens and heads of
    ``head_dim`` features."""
    return head_dim == HEAD_DIM and 1 <= length <= MAX_LENGTH


def check_index(index: torch.Tensor, rows: int) -> None:
    """Raises ValueError unless the kernels read ``index`` [N, N] as it is:
    every entry a row of a table of ``rows``, ``index[i, j] = index[i, 0] +
    index[0, j] - index[0, 0]``, and the column offsets ``index[0, j] -
    index[0, 0]`` distinct (the table's gradient inverts them). A relative
    index of distinct coordinates is of this form, as is any [:n, :n] of
    it."""
    idx = index.detach().to("cpu", torch.int64)
    if idx.dim() != 2 or idx.shape[0] != idx.shape[1] or idx.numel() == 0:
        raise ValueError(f"window_attention: index {tuple(idx.shape)} is not [N, N]")
    col = idx[0] - idx[0, 0]
    if int(idx.min()) < 0 or int(idx.max()) >= rows:
        raise ValueError(f"window_attention: index entries {int(idx.min())} to "
                         f"{int(idx.max())} outside a table of {rows} rows")
    if not torch.equal(idx, idx[:, :1] + col[None, :]):
        raise ValueError("window_attention: index is not its first column plus its first "
                         "row's offsets")
    if col.unique().numel() != col.numel():
        raise ValueError("window_attention: two columns of the index share an offset")


def region_mask(regions: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[nW, N, N]: ``MASK`` between tokens of two regions of a window, 0
    within one."""
    diff = regions[:, None, :] != regions[:, :, None]
    return torch.where(diff, torch.tensor(MASK, dtype=dtype, device=regions.device),
                       torch.tensor(0.0, dtype=dtype, device=regions.device))


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           table: torch.Tensor, index: torch.Tensor,
                           regions: Optional[torch.Tensor], heads: int,
                           scale: float) -> torch.Tensor:
    """The same function in plain PyTorch on the same layout: the bias from
    ``table[index]`` plus the mask, an explicit softmax(q kᵀ · scale + bias)
    v for each (clip, window, head); its gradient is autograd's."""
    b, n, f = q.shape
    p = f // HEAD_DIM
    nw = p // heads
    qh, kh, vh = (t.view(b, n, p, HEAD_DIM).transpose(1, 2) for t in (q, k, v))  # [B, P, N, 32]
    rel = table[index.reshape(-1)].view(n, n, heads).permute(2, 0, 1)  # [heads, N, N]
    bias = (rel.expand(nw, heads, n, n) if regions is None
            else rel[None] + region_mask(regions, table.dtype)[:, None])
    s = qh @ kh.transpose(-2, -1) * scale + bias.reshape(p, n, n)
    return (s.softmax(dim=-1) @ vh).transpose(1, 2).reshape(b, n, f)


def work(b: int, n: int, p: int, table_rows: int, heads: int,
         itemsize: int = 4) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((forward FLOP, bytes), (backward FLOP, bytes)) of a call over ``b``
    clips of ``p`` (window, head) pairs of ``n`` tokens: the products at
    2·N²·32 each (two forward; q kᵀ again, dP, dV, dQ and dK backward) and the
    bytes each launch must move at least, each read or written once."""
    product = 2 * b * p * n * n * HEAD_DIM
    slab = b * n * p * HEAD_DIM * itemsize
    tab = table_rows * heads * itemsize
    return (2 * product, 4 * slab + tab), (5 * product, 7 * slab + tab)


def geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
             index: torch.Tensor, regions: Optional[torch.Tensor],
             heads: int) -> Tuple[int, int, int, int]:
    """(B, N, P, T) of a call the kernels take: P = nW·heads pairs a clip,
    T table rows. Raises ValueError on any other."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not one [B, N, nW·C]")
    b, n, f = (int(s) for s in q.shape)
    if heads < 1 or f % (heads * HEAD_DIM) or not takes(n, HEAD_DIM):
        raise ValueError(f"window_attention: {n} tokens of {f} features over {heads} heads "
                         f"(the kernels take head_dim {HEAD_DIM} and 1 to {MAX_LENGTH} tokens)")
    p = f // HEAD_DIM
    if table.dim() != 2 or table.shape[1] != heads or not 1 <= table.shape[0] <= MAX_TABLE:
        raise ValueError(f"window_attention: table {tuple(table.shape)} is not [T <= "
                         f"{MAX_TABLE}, {heads}]")
    if (index.dim() != 2 or tuple(index.shape) != (n, n) or index.dtype != torch.int64
            or index.stride(1) != 1):
        raise ValueError(f"window_attention: index {tuple(index.shape)} {index.dtype} is not "
                         f"[{n}, {n}] int64 with unit column stride")
    if regions is not None and (tuple(regions.shape) != (p // heads, n)
                                or regions.dtype != torch.int32):
        raise ValueError(f"window_attention: regions {tuple(regions.shape)} {regions.dtype} is "
                         f"not [{p // heads}, {n}] int32")
    return b, n, p, int(table.shape[0])


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "window_attention_fwd_launch": (_I, _P, _P, _P, _P, _P, _L, _P, _P, _P) + (_I,) * 5
    + (_F, _P),
    "window_attention_bwd_scratch": (_L, _I, _I, _I),
    "window_attention_bwd_launch": (_I,) + (_P,) * 8 + (_L,) + (_P,) * 6 + (_I,) * 5 + (_F, _P),
}


def _lib():
    return _build.bind("window_attention", _SIGNATURES)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """t, copied first if it is not contiguous or not 16-byte aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def forward_rows(q, k, v, tab_t, index, regions, heads: int, scale: float, geo):
    """The forward kernel on packed q, k, v and the transposed table [heads,
    T] → (o [B, N, P·32], lse [B, P, N]). On the current device and
    stream."""
    b, n, p, rows = geo
    out = torch.empty_like(q)
    lse = torch.empty((b, p, n), dtype=torch.float32, device=q.device)
    _build.check(_lib().window_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tab_t.data_ptr(), index.data_ptr(),
        index.stride(0), _ptr(regions), out.data_ptr(), lse.data_ptr(), b, n, p, heads, rows,
        scale, _build.stream(q.device)), "window attention forward")
    flop, nbytes = work(b, n, p, rows, heads)[0]
    launches.count("fwd", flop=flop, nbytes=nbytes)
    return out, lse


def backward_rows(q, k, v, out, dout, lse, tab_t, index, regions, heads: int, scale: float,
                  geo):
    """The backward kernels → (dq, dk, dv [B, N, P·32], dtable [T, heads])."""
    b, n, p, rows = geo
    lib = _lib()
    scratch = torch.empty(int(lib.window_attention_bwd_scratch(b, n, p)), dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dtable = torch.empty((rows, heads), dtype=torch.float32, device=q.device)
    _build.check(lib.window_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), tab_t.data_ptr(), index.data_ptr(), index.stride(0), _ptr(regions),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dtable.data_ptr(),
        b, n, p, heads, rows, scale, _build.stream(q.device)), "window attention backward")
    flop, nbytes = work(b, n, p, rows, heads)[1]
    launches.count("bwd", flop=flop, nbytes=nbytes)
    return dq, dk, dv, dtable


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, table, index, regions, heads, scale, geo):
        q, k, v = (_packed(t) for t in (q, k, v))
        tab_t = table.detach().t().contiguous()
        regions = None if regions is None else regions.contiguous()
        with _build.on(q.device):
            out, lse = forward_rows(q, k, v, tab_t, index, regions, heads, scale, geo)
        ctx.save_for_backward(q, k, v, out, lse, tab_t, index, regions)
        ctx.heads, ctx.scale, ctx.geo = heads, scale, geo
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, tab_t, index, regions = ctx.saved_tensors
        with _build.on(q.device):
            dq, dk, dv, dtable = backward_rows(q, k, v, out, _packed(dout), lse, tab_t, index,
                                               regions, ctx.heads, ctx.scale, ctx.geo)
        return dq, dk, dv, dtable, None, None, None, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, regions: Optional[torch.Tensor], heads: int,
                     scale: float) -> torch.Tensor:
    """softmax(q kᵀ · scale + table[index] + mask) v of q, k, v [B, N, nW·C]
    over each (window, head) → o [B, N, nW·C], differentiable in q, k, v
    and the table.

    A CPU tensor (float32 or float64) runs ``window_attention_plain``. A
    CUDA fp32 tensor launches the kernels on the current stream or raises on
    anything they do not take."""
    if q.device.type == "cpu":
        if q.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"window_attention: dtype {q.dtype} on the CPU (takes float32, "
                            f"float64)")
        return window_attention_plain(q, k, v, table, index, regions, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v, table)):
        raise TypeError(f"window_attention: dtype {q.dtype} on the card (takes float32)")
    geo = geometry(q, k, v, table, index, regions, heads)
    return _WindowAttention.apply(q, k, v, table, index, regions, heads, float(scale), geo)
