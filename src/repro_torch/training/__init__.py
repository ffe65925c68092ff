"""Training substrate (port of `repro/training`): loss, train step,
microbatched accumulation."""
from repro_torch.training.step import (TrainConfig, loss_fn, make_serve_fns,
                                       make_train_step)

__all__ = ["TrainConfig", "loss_fn", "make_serve_fns", "make_train_step"]
