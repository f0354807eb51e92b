"""Deep-supervision loss (JAX ``losses/deep_supervision.py``): the hybrid
loss summed over every side output.

A level goes through the kernels wherever the JAX gates admit it
(``fused_loss_available``: a pixel count that is a multiple of 128;
``fused_ssim_available`` and an odd window: one channel and at most
448 x 448 pixels), and through the plain losses otherwise, exactly as
the JAX function routes it with ``fused=True``.  There is no unfused
switch: on the CPU the kernels' wrappers run their plain versions
themselves.  The fused BCE/IoU/CEL terms are logged as one
``bce_iou_cel`` component, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels.fused_loss import fused_bce_iou_cel, fused_loss_available
from ..kernels.fused_ssim import fused_ssim_available, fused_ssim_loss
from .elementwise import bce_with_logits
from .region import cel_loss, iou_loss
from .ssim import ssim_loss


def deep_supervision_loss(
    logits_list: Sequence[torch.Tensor],
    target: torch.Tensor,
    *,
    bce_w: float = 1.0,
    iou_w: float = 1.0,
    ssim_w: float = 1.0,
    cel_w: float = 0.0,
    ssim_window: int = 11,
    level_weights: Optional[Sequence[float]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``sum_l w_l (bce_w BCE + iou_w IoU + ssim_w SSIM + cel_w CEL)``;
    returns ``(total, components)`` with the per-term sums over levels
    and ``"total"``."""
    if level_weights is None:
        level_weights = [1.0] * len(logits_list)
    total = torch.zeros((), dtype=torch.float32, device=target.device)
    comps: Dict[str, torch.Tensor] = {}

    def add(name, value, weight):
        nonlocal total
        comps[name] = comps[name] + value if name in comps else value
        total = total + weight * value

    for logit, lw in zip(logits_list, level_weights):
        if (bce_w or iou_w or cel_w) and fused_loss_available(logit.shape):
            add("bce_iou_cel",
                lw * fused_bce_iou_cel(logit, target, bce_w, iou_w, cel_w),
                1.0)
        else:
            if bce_w:
                add("bce", lw * bce_with_logits(logit, target), bce_w)
            if iou_w:
                add("iou", lw * iou_loss(logit, target), iou_w)
            if cel_w:
                add("cel", lw * cel_loss(logit, target), cel_w)
        if ssim_w:
            if ssim_window % 2 == 1 and fused_ssim_available(logit.shape):
                add("ssim", lw * fused_ssim_loss(
                    logit, target, window_size=ssim_window), ssim_w)
            else:
                add("ssim", lw * ssim_loss(
                    logit, target, window_size=ssim_window), ssim_w)
    comps["total"] = total
    return total, comps
