"""Checkpoint save/restore with ``torch.save``.

Counterpart of vqwild_tpu/train/checkpoint.py, whose Orbax format the port
does not read. The reference saves only ``best.pth.tar`` {epoch, state_dict,
score, optimizer} on validation improvement (main.py:591-604); both packages
keep that contract (``best``) and also write ``last`` each epoch for
mid-training resume (upstream has none, SURVEY §5).

Each name is a directory (as an Orbax checkpoint is) holding one
``torch.save`` file, so a caller tells the port's checkpoint (a directory)
from a reference ``.pth.tar`` (a file). A save writes a temporary sibling
and moves it into place with ``os.replace``: a save killed midway leaves the
previous checkpoint whole, and its leftover is never read.

Under a ``mesh`` (parallel/mesh.py) every rank holds the same training
state: rank 0 writes, and every rank waits at a barrier until the file is
in place, so that any rank may read it next (``--resume`` restores on every
rank).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Union

import torch

from vqwild_tpu_torch.core.logging import get_logger
from vqwild_tpu_torch.parallel.distributed import barrier
from vqwild_tpu_torch.train.step import TrainState

log = get_logger("train.checkpoint")

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, payload: Any):
        if self.writer:
            self._write(name, payload)
        if self.mesh is not None:
            barrier(f"checkpoint/{name}")

    def _write(self, name: str, payload: Any):
        path = self._path(name)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            os.replace(os.path.join(tmp, STATE_FILE), os.path.join(path, STATE_FILE))
            os.rmdir(tmp)
        else:
            os.replace(tmp, path)
        log.info("saved checkpoint %s", path)

    def restore(self, name: str,
                map_location: Optional[Union[str, torch.device]] = None) -> Any:
        return torch.load(os.path.join(self._path(name), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.isdir(self._path(name))


def last_payload(state: TrainState, epoch: int) -> dict:
    """The full training state after ``epoch`` (the JAX loop's ``last``:
    params, BN statistics, memory, optimizer state, step, dropout key)."""
    return dict(
        model=state.model.state_dict(),  # parameters, BN statistics, the memory
        optimizer=state.optimizer.state_dict(),
        step=state.step,
        grad_acc=state.grad_acc,  # the pending accum_grad mean, or None
        generator=state.generator.get_state(),  # the dropout generator
        generator_device=state.generator.device.type,
        epoch=epoch,
    )


def restore_train_state(state: TrainState, payload: dict) -> int:
    """Put a ``last`` payload back into ``state`` (in place, on the state's
    device) and return the epoch to resume from. Restore the payload with
    ``map_location="cpu"``: the optimizer's ``step`` counts stay host
    tensors, as torch's Adam keeps them. A generator's state only
    restores into a generator of its own device type: resuming the dropout
    stream of one device on another is refused, not reseeded."""
    have = state.generator.device.type
    if payload["generator_device"] != have:
        raise ValueError(
            f"the checkpoint's dropout generator is a {payload['generator_device']} "
            f"generator and this state's a {have} one: its stream cannot be resumed "
            f"across devices")
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    acc = payload["grad_acc"]
    state.grad_acc = None if acc is None else [g.to(dev) for g in acc]
    state.generator.set_state(payload["generator"].cpu())
    return int(payload["epoch"]) + 1
