from vqwild_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
)

__all__ = ["TrainState", "create_train_state", "make_optimizer", "make_scanned_train_step",
           "make_train_step"]
