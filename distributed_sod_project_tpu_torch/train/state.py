"""Train state (JAX ``train/state.py``): the step count, the model (its
parameters and BatchNorm running statistics) and the optimizer with its
schedule.  PyTorch updates all of them in place."""

from __future__ import annotations

import dataclasses

import torch

from .optim import build_optimizer
from .schedules import Schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    schedule: Schedule


def create_train_state(model: torch.nn.Module, optim_cfg,
                       total_steps: int) -> TrainState:
    opt, sched, schedule = build_optimizer(model.parameters(), optim_cfg,
                                           total_steps)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      schedule=schedule)
