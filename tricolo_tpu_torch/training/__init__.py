"""Training: optimizer and schedule, the train step, the Trainer."""

from .optim import lr_for_epoch, make_optimizer
from .steps import make_train_step
from .trainer import Trainer

__all__ = ["Trainer", "lr_for_epoch", "make_optimizer", "make_train_step"]
