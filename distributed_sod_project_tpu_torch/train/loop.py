"""The training loop (JAX ``train/loop.py`` ``fit``, the subset one card
needs): synthetic batches in a seeded order, ``train_step`` per batch,
metrics every ``cfg.log_every_steps``.

Knobs the port does not implement raise, naming ROADMAP.md, rather than
being ignored: host augmentation (``data.hflip``, ``data.rotate_degrees``),
RGB-D input and more than one process (DDP with cross-process BatchNorm
is the next slice).  The data is ``SyntheticSOD``, as the JAX loop's is
without a data root; ``data.root`` is not copied, so setting it raises.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..data import SyntheticSOD
from ..models import build_model
from ..utils.device import resolve_device
from .state import create_train_state
from .step import loss_kwargs, train_step

_ROADMAP = "see ROADMAP.md Queue 1"
log = logging.getLogger(__name__)


def check_supported(cfg) -> None:
    """Raise on every setting the port's trainer does not implement."""
    d = cfg.data
    for name, off in (("hflip", "false"), ("rotate_degrees", "0"),
                      ("use_depth", "false")):
        if getattr(d, name):
            raise NotImplementedError(
                f"data.{name}={getattr(d, name)!r} is not ported yet (host "
                f"augmentation and RGB-D, {_ROADMAP} item 7); pass "
                f"--set data.{name}={off}")
    loss_kwargs(cfg.loss)  # raises on loss.fused_kernel=False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process data parallelism (DDP with "
            f"cross-process BatchNorm) is the next slice; {_ROADMAP}")


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The JAX ``HostDataLoader`` shuffle: a permutation that is a pure
    function of ``(seed, epoch)``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n)


def batches(dataset, batch_size: int, seed: int, device: torch.device,
            steps_per_epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless ``{"image", "mask"}`` batches on ``device``, whole batches
    only (the JAX loader's ``drop_last``)."""
    epoch = 0
    while True:
        order = epoch_order(len(dataset), seed, epoch)
        for i in range(steps_per_epoch):
            idx = order[i * batch_size:(i + 1) * batch_size]
            samples = [dataset[int(j)] for j in idx]
            yield {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                   .to(device, non_blocking=True) for k in ("image", "mask")}
        epoch += 1


def fit(cfg, device=None, max_steps: Optional[int] = None,
        seed: Optional[int] = None,
        on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None
        ) -> Dict[str, float]:
    """Train ``cfg`` from a random init drawn with ``seed`` (default
    ``cfg.seed``) for ``min(epochs * steps_per_epoch, max_steps)``
    steps on ``device`` (the card unless ``"cpu"`` is asked for); returns
    the last step's metrics as floats.  ``on_metrics(step, metrics)`` is
    called at every logged step."""
    check_supported(cfg)
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else int(seed)
    d = cfg.data
    dataset = SyntheticSOD(size=d.synthetic_size, image_size=d.image_size,
                           normalize_mean=d.normalize_mean,
                           normalize_std=d.normalize_std)
    bs = int(cfg.global_batch_size)
    loader_steps = len(dataset) // bs  # whole batches an epoch
    if loader_steps <= 0:
        raise ValueError(f"dataset of {len(dataset)} samples yields zero "
                         f"steps at global_batch_size={bs}")
    # cfg.steps_per_epoch only re-sizes the schedule, as in the JAX loop.
    steps_per_epoch = cfg.steps_per_epoch or loader_steps
    total = steps_per_epoch * cfg.num_epochs
    if max_steps is not None:
        total = min(total, int(max_steps))
    model = build_model(cfg.model, torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(dev), cfg.optim, total)
    log.info("fit %s on %s: batch %d, %d steps/epoch, %d steps", cfg.name,
             dev, bs, steps_per_epoch, total)
    it = batches(dataset, bs, seed, dev, loader_steps)
    out: Dict[str, float] = {}
    while state.step < total:
        metrics = train_step(state, next(it), cfg.loss)
        if state.step % cfg.log_every_steps == 0 or state.step == total:
            out = {k: float(v) for k, v in metrics.items()}
            log.info("step %d %s", state.step,
                     " ".join(f"{k}={v:.5g}" for k, v in out.items()))
            if on_metrics is not None:
                on_metrics(state.step, out)
    return out
