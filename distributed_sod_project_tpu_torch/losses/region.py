"""Region-level losses (JAX ``losses/region.py``): soft IoU and MINet's
consistency-enhanced loss, per image then averaged, in f32."""

from __future__ import annotations

import torch


def _probs_targets(logits, targets):
    b = logits.shape[0]
    return (torch.sigmoid(logits.float()).reshape(b, -1),
            targets.float().reshape(b, -1))


def iou_loss(logits: torch.Tensor, targets: torch.Tensor, *,
             eps: float = 1.0) -> torch.Tensor:
    """Soft Jaccard loss ``1 - (inter + eps) / (union + eps)``."""
    p, t = _probs_targets(logits, targets)
    inter = (p * t).sum(-1)
    union = p.sum(-1) + t.sum(-1) - inter
    return (1.0 - (inter + eps) / (union + eps)).mean()


def cel_loss(logits: torch.Tensor, targets: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """``(sum p + sum t - 2 sum p t) / (sum p + sum t)`` (MINet's CEL)."""
    p, t = _probs_targets(logits, targets)
    inter = (p * t).sum(-1)
    total = p.sum(-1) + t.sum(-1)
    return ((total - 2.0 * inter) / (total + eps)).mean()
