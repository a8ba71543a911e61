"""Multi-process runtime: one process per GPU on ``torch.distributed``.

Counterpart of vqwild_tpu/parallel/distributed.py. The JAX package runs one
process per host, each driving all of its devices through one global mesh.
PyTorch's idiom is one process per GPU: ``torchrun --nproc_per_node N``
starts N copies of the program, each joins the process group, and the
collectives of parallel/mesh.py keep the ranks on one global batch.

Call ``initialize()`` once at process start. A run with one process needs
nothing and ``initialize`` returns False. Rank ``r`` computes on
``cuda:LOCAL_RANK`` (``rank_device``).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Union

import torch
import torch.distributed as dist

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("parallel.distributed")

DEFAULT_TIMEOUT_S = 600.0
_barrier_calls: dict = {}  # name -> calls so far in this process (the barrier's generation)


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device this process computes on: ``cuda`` without an index is
    ``cuda:LOCAL_RANK`` (0 outside torchrun); an explicit index is kept (two
    ranks may share one card); ``cpu`` is the CPU. Raises if a CUDA device
    is asked for and none is present."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return dev


def initialize(device: Union[str, torch.device] = "cuda", backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group described by the environment; returns True
    if a multi-process runtime is running (started here or before).

    The cluster comes from torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, or from the JAX package's names:
    ``PROCESS_ID``, ``NUM_PROCESSES`` and ``COORDINATOR_ADDRESS``
    (``host:port``). Neither set, or a world size of 1, is a single-process
    run: nothing is started and False is returned.

    ``backend`` defaults to ``nccl`` for a CUDA device and ``gloo`` for the
    CPU (gloo also runs collectives on CUDA tensors: two ranks that share
    one card cannot use NCCL). A collective that waits longer than
    ``timeout_s`` raises on every rank that is still alive."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    rank = _env_int("RANK", "PROCESS_ID")
    if world is None or world <= 1:
        log.info("single-process runtime")
        return False
    if rank is None:
        raise RuntimeError(f"world size {world} but no RANK or PROCESS_ID in the environment")
    if "MASTER_ADDR" not in os.environ:
        coord = os.environ.get("COORDINATOR_ADDRESS")
        if not coord:
            raise RuntimeError("no MASTER_ADDR/MASTER_PORT or COORDINATOR_ADDRESS in the "
                               "environment")
        host, port = coord.rsplit(":", 1)
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    log.info("distributed runtime: rank %d/%d on %s (%s)", rank, world, dev, backend)
    return True


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Block until every rank reaches this barrier; raise TimeoutError after
    ``timeout_ms``. It goes through the process group's key-value store, not
    a device collective, so it also holds ranks whose devices are busy. Each
    rank must call the barriers of one ``name`` in the same order. No-op in
    a single-process runtime."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    gen = _barrier_calls.get(name, 0)
    _barrier_calls[name] = gen + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"vqwild_barrier/{name}/{gen}"
    world = dist.get_world_size()
    store.add(key, 1)
    deadline = time.monotonic() + timeout_ms / 1e3
    while store.add(key, 0) < world:
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {name!r}: {store.add(key, 0)} of {world} ranks "
                               f"arrived in {timeout_ms} ms")
        time.sleep(0.005)


def shutdown() -> None:
    """Leave the process group (if one was started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
