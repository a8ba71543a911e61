"""Host memory allocation for large eval-time arenas.

On some hosts the first-touch faults of anonymous memory are very slow on
glibc-malloc'd numpy buffers, and naive per-block allocation then dominates
gallery builds at production scale (~10^6 moments → multi-GB arenas).
``alloc_array`` allocates via anonymous mmap with MADV_NOHUGEPAGE and
zero-fills sequentially so downstream writes never fault. A copy of
vqwild_tpu/ops/hostmem.py.
"""

from __future__ import annotations

import mmap

import numpy as np


def alloc_array(shape, dtype=np.float32) -> np.ndarray:
    """Pre-faulted writable array backed by anonymous mmap."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if nbytes == 0:
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, nbytes)
    try:
        buf.madvise(mmap.MADV_NOHUGEPAGE)
    except (AttributeError, OSError):
        pass
    arr = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape))).reshape(shape)
    arr[...] = 0  # sequential pre-touch
    return arr
