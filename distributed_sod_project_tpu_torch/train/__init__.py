"""Training on one card: ``fit`` and its pieces (JAX ``train/``)."""

from .loop import fit
from .optim import build_optimizer
from .schedules import build_schedule
from .state import TrainState, create_train_state
from .step import train_step

__all__ = ["TrainState", "build_optimizer", "build_schedule",
           "create_train_state", "fit", "train_step"]
