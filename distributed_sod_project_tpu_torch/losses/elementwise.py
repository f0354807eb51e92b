"""Pixel-wise losses (JAX ``losses/elementwise.py``): full-resolution
logits ``[B,H,W,1]`` against binary targets of the same shape, reduced
in f32."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, *,
                    reduction: str = "mean") -> torch.Tensor:
    """Stable sigmoid BCE: ``max(x,0) - x*t + log1p(exp(-|x|))``."""
    x, t = logits.float(), targets.float()
    per_pixel = torch.clamp_min(x, 0.0) - x * t + torch.log1p(
        torch.exp(-x.abs()))
    if reduction == "mean":
        return per_pixel.mean()
    if reduction == "sum":
        return per_pixel.sum()
    if reduction == "none":
        return per_pixel
    raise ValueError(f"unknown reduction {reduction!r}")
