"""Optimizer (JAX ``train/optim.py`` ``build_optimizer``, SGD arm).

The JAX chain is ``add_decayed_weights(wd, mask=rank >= 2)`` ->
``trace(momentum, nesterov)`` -> ``scale_by_learning_rate(schedule)``:

    g' = g + wd * p        (kernels only; biases and BN affines undecayed)
    t  = g' + mu * t_prev
    u  = g' + mu * t       (nesterov; u = t without it)
    p  = p - lr(step) * u  (lr read at the step count before the update)

``torch.optim.SGD`` computes the same with its coupled weight decay,
``dampening=0`` and its momentum buffer started at the first ``g'``
(``t_prev = 0``), one param group decayed and one not, and a
``LambdaLR`` that reads the schedule at the step count.  The other
optimizers and the chain's optional links are not ported and raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .schedules import Schedule, build_schedule


def build_optimizer(params, optim_cfg, total_steps: int
                    ) -> Tuple[torch.optim.SGD,
                               torch.optim.lr_scheduler.LambdaLR, Schedule]:
    """``(optimizer, scheduler, schedule)`` over the parameters
    ``params``."""
    if optim_cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optim.optimizer={optim_cfg.optimizer!r}: only sgd is ported; "
            "see ROADMAP.md Queue 1")
    schedule = build_schedule(optim_cfg, total_steps)
    params = list(params)
    decay = [p for p in params if p.ndim >= 2]
    rest = [p for p in params if p.ndim < 2]
    wd = float(optim_cfg.weight_decay)
    groups = [{"params": decay, "weight_decay": wd},
              {"params": rest, "weight_decay": 0.0}]
    mu = float(optim_cfg.momentum)
    # lr=1.0: LambdaLR multiplies it by the schedule's value.
    opt = torch.optim.SGD([g for g in groups if g["params"]], lr=1.0,
                          momentum=mu, dampening=0.0,
                          nesterov=bool(optim_cfg.nesterov and mu),
                          weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    return opt, sched, schedule
