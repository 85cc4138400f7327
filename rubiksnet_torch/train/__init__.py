"""Training of the PyTorch port: SGD groups, steps and checkpoints."""

from .checkpoint import load_train_state, save_train_state
from .optim import (
    lr_schedule,
    param_groups,
    resume_schedule,
    sgd_with_shift_mult,
)
from .steps import TrainStep, cross_entropy, make_eval_step, make_train_step

__all__ = [
    "TrainStep",
    "cross_entropy",
    "load_train_state",
    "lr_schedule",
    "make_eval_step",
    "make_train_step",
    "param_groups",
    "resume_schedule",
    "save_train_state",
    "sgd_with_shift_mult",
]
