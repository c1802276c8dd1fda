"""The train step of the port, as ``repro.train``."""
from repro_torch.train.step import (
    TrainConfig,
    TrainState,
    abstract_train_state,
    compress_grads,
    init_train_state,
    make_grad_fn,
    make_train_state,
    make_train_step,
)

__all__ = ["TrainConfig", "TrainState", "abstract_train_state", "compress_grads", "init_train_state",
           "make_grad_fn", "make_train_state", "make_train_step"]
