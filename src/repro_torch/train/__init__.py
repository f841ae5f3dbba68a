"""Training: counterpart of `repro.train`."""

from .loss import softmax_cross_entropy
from .step import make_loss_fn, make_train_step
from .trainer import StragglerEvent, Trainer, TrainerConfig
__all__ = ["softmax_cross_entropy", "make_loss_fn", "make_train_step",
           "StragglerEvent", "Trainer", "TrainerConfig"]
