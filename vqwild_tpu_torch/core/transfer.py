"""Host → device uploads in bounded messages.

Counterpart of vqwild_tpu/core/transfer.py. ``chunked_device_put`` uploads
a large array as row slices of at most ``chunk_bytes``, each complete before
the next, so that no single transfer is larger than that. On the card the
slices go through one reused pinned staging buffer into one preallocated
device tensor: nothing is concatenated, so a 3 GB gallery takes 3 GB of
device memory, not twice that.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device

_DEFAULT_CHUNK_BYTES = 32 * 1024 * 1024


def chunked_device_put(
    x: np.ndarray,
    device: Union[str, torch.device] = "cuda",
    chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
    block: bool = True,
    mesh=None,
) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (``mesh.device`` under a ``mesh``),
    uploaded in row slices of at most ``chunk_bytes``.

    A placement under a mesh, a 1-D array and one no larger than
    ``chunk_bytes`` go in one copy, as in the JAX package. ``block`` waits
    until the whole array is on the device.
    """
    x = np.ascontiguousarray(x)
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = torch.empty(x.shape, dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype, device=dev)
    if mesh is not None or x.ndim < 2 or x.nbytes <= chunk_bytes:
        out.copy_(torch.from_numpy(x))
    else:
        rows_per = max(1, int(chunk_bytes // max(1, x.nbytes // x.shape[0])))
        if dev.type == "cuda":
            stage = torch.empty((rows_per,) + x.shape[1:], dtype=out.dtype, pin_memory=True)
            stage_np = stage.numpy()
            stream = torch.cuda.current_stream(dev)
        for lo in range(0, x.shape[0], rows_per):
            part = x[lo : lo + rows_per]
            if dev.type == "cuda":
                stage_np[: len(part)] = part
                out[lo : lo + len(part)].copy_(stage[: len(part)], non_blocking=True)
                stream.synchronize()  # this slice is on the card; the buffer is free again
            else:
                out[lo : lo + len(part)].copy_(torch.from_numpy(part))
    if block and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out
