"""One training step (JAX ``parallel/engine.py`` DP step at one replica,
``train/step.py`` ``apply_update``): train-mode forward -> deep
supervision loss -> backward -> SGD update.

Metrics carry the JAX names: the loss components (``bce_iou_cel`` and
``ssim`` on the fused path), ``total``, ``grad_norm`` (global L2 norm of
the gradients) and ``lr`` (the schedule at the step count before the
update).  They are returned as 0-d tensors on the model's device, so a
step does not wait for the card; ``float()`` them to read.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..losses import deep_supervision_loss
from .state import TrainState


def loss_kwargs(loss_cfg) -> Dict[str, object]:
    """``deep_supervision_loss``'s weights from a LossConfig; raises on
    ``fused_kernel=False``, the port's losses being the kernels alone."""
    if not loss_cfg.fused_kernel:
        raise NotImplementedError(
            "loss.fused_kernel=False: the port's only loss route is the "
            "fused kernels (the JAX gates still send other shapes to the "
            "plain losses); see ROADMAP.md Queue 1")
    return dict(bce_w=loss_cfg.bce, iou_w=loss_cfg.iou, ssim_w=loss_cfg.ssim,
                cel_w=loss_cfg.cel, ssim_window=loss_cfg.ssim_window)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               loss_cfg) -> Dict[str, torch.Tensor]:
    """Advance ``state`` by one update on ``batch`` (``image``
    ``[B,H,W,3]``, ``mask`` ``[B,H,W,1]``, on the model's device)."""
    outs = state.model(batch["image"], train=True)
    if not loss_cfg.deep_supervision:
        outs = outs[:1]
    total, comps = deep_supervision_loss(outs, batch["mask"],
                                         **loss_kwargs(loss_cfg))
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    metrics = {k: v.detach() for k, v in comps.items()}
    metrics["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    metrics["lr"] = torch.tensor(state.schedule(state.step))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics
