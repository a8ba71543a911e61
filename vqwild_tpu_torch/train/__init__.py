from vqwild_tpu_torch.train.checkpoint import CheckpointManager, restore_train_state
from vqwild_tpu_torch.train.loop import LoopResult, NonFiniteLossError, TrainLoop
from vqwild_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
)

__all__ = ["CheckpointManager", "LoopResult", "NonFiniteLossError", "TrainLoop", "TrainState",
           "create_train_state", "make_optimizer", "make_scanned_train_step", "make_train_step",
           "restore_train_state"]
