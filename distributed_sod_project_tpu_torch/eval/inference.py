"""The canonical eval forward and its host-side helpers (counterpart of
the JAX ``eval/inference.py:51-105``)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def make_forward(model: torch.nn.Module
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``images [B,H,W,3] -> probs [B,H,W]``: sigmoid of the primary
    logit, float32, on the images' device."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(model(images)[0][..., 0].float())

    return forward


def pad_to_batch(batch: Dict[str, np.ndarray], batch_size: int
                 ) -> Dict[str, np.ndarray]:
    """Zero-pad every leaf's leading dim to ``batch_size`` so a warmed
    forward only ever sees its bucket's shape; callers slice the pad
    back off the output."""
    short = batch_size - next(iter(batch.values())).shape[0]
    if short <= 0:
        return batch
    return {k: np.concatenate(
        [v, np.zeros((short,) + v.shape[1:], v.dtype)])
        for k, v in batch.items()}


def _resize_pred(pred: np.ndarray, hw) -> np.ndarray:
    """A bucket-resolution saliency map back to the request's original
    ``(H, W)``, through 8-bit PIL bilinear as the eval path does."""
    from PIL import Image

    if pred.shape == tuple(hw):
        return pred
    im = Image.fromarray((np.clip(pred, 0, 1) * 255).astype(np.uint8))
    im = im.resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0
