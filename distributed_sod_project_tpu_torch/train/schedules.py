"""LR schedules (JAX ``train/schedules.py``): poly, cosine or constant,
with an optional linear warmup, as ``step -> lr`` functions with optax's
formulas, evaluated in f32 as optax evaluates them."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def _poly(init: float, end: float, power: float, steps: int) -> Schedule:
    """``optax.polynomial_schedule(init, end, power, steps)``."""
    def fn(count: int) -> float:
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return float(_f32(init - end) * frac ** _f32(power) + _f32(end))
    return fn


def _cosine(init: float, steps: int) -> Schedule:
    """``optax.cosine_decay_schedule(init, steps)``."""
    def fn(count: int) -> float:
        c = _f32(min(count, steps))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(steps)))
        return float(_f32(init) * cos)
    return fn


def build_schedule(optim_cfg, total_steps: int) -> Schedule:
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    warmup = int(optim_cfg.warmup_steps)
    decay_steps = max(total_steps - warmup, 1)
    kind = optim_cfg.schedule
    if kind == "poly":
        main = _poly(optim_cfg.lr, 0.0, optim_cfg.poly_power, decay_steps)
    elif kind == "cosine":
        main = _cosine(optim_cfg.lr, decay_steps)
    elif kind == "constant":
        main = lambda count: float(_f32(optim_cfg.lr))  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    if warmup <= 0:
        return main
    ramp = _poly(0.0, optim_cfg.lr, 1.0, warmup)  # optax.linear_schedule
    # optax.join_schedules([ramp, main], [warmup])
    return lambda count: ramp(count) if count < warmup else main(
        count - warmup)
