"""Fused BCE + IoU + CEL loss statistics, and the loss built on them.

Replaces ``distributed_sod_project_tpu/pallas/fused_loss.py``:
``pixel_region_sums`` with ``_sums_kernel`` -> ``csrc/fused_loss.cu``, one
pass over the logits and targets that gives, per image, the stable-BCE
sum, sum sigmoid(x)*t, sum sigmoid(x) and sum t in f32, bound by bytes
(the note at the top of the source says how).  ``fused_bce_iou_cel``
combines them into the loss and, as the JAX package does in XLA
(fused_loss.py:141-167), computes its gradient in closed form with plain
tensor code: the backward is elementwise given the forward's per-image
sums, so it needs no kernel of its own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches; the plain CPU version never counts

_LANES = 128  # the JAX gate's pixel-count multiple (fused_loss.py:53-64)
_THREADS = 256  # csrc/fused_loss.cu block size
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p])

Sums = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_loss_available(shape) -> bool:
    """True when a logit map of this shape takes the kernel: a pixel
    count that is a multiple of 128, the JAX package's gate
    (``fused_loss_available``; its backend half is about Pallas, which
    the kernel replaces).  Off-lane sizes take the plain losses."""
    return math.prod(int(d) for d in shape[1:]) % _LANES == 0


def pixel_region_sums_plain(x: torch.Tensor, t: torch.Tensor) -> Sums:
    """The plain version: per-image ``(bce_sum, sum p*t, sum p, sum t)``
    of ``[B, N]`` f32 logits and targets."""
    bce = (torch.clamp_min(x, 0) - x * t
           + torch.log1p(torch.exp(-x.abs()))).sum(-1)
    p = torch.sigmoid(x)
    return bce, (p * t).sum(-1), p.sum(-1), t.sum(-1)


def pixel_region_sums(logits: torch.Tensor, targets: torch.Tensor) -> Sums:
    """Per-image ``(bce_sum, sum sigmoid(x) t, sum sigmoid(x), sum t)``,
    each ``[B]`` f32, of logits and targets shaped ``[B,H,W,1]``,
    ``[B,H,W]`` or ``[B,N]``; the pixel count must be a multiple of 128
    (padding would bias sum sigmoid(x))."""
    b = logits.shape[0]
    n = logits.numel() // max(b, 1)
    if n % _LANES or targets.numel() != logits.numel():
        raise ValueError(f"pixel_region_sums: {tuple(logits.shape)} / "
                         f"{tuple(targets.shape)}: pixel counts must match "
                         f"and be a multiple of {_LANES}")
    x = logits.reshape(b, n).float()
    t = targets.reshape(b, n).float()
    if x.device.type == "cpu":
        return pixel_region_sums_plain(x, t)
    if x.device.type != "cuda" or t.device != x.device:
        raise ValueError(f"pixel_region_sums: unsupported devices "
                         f"{x.device} / {t.device}")
    x, t = x.contiguous(), t.contiguous()
    blocks = max(1, min(64, n // (_THREADS * 8)))
    partial = torch.empty(b * blocks * 4, device=x.device,
                          dtype=torch.float32)
    out = torch.empty((4, b), device=x.device, dtype=torch.float32)
    fn = _build.entry("fused_loss", "dsod_pixel_region_sums", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), t.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), b, n, blocks,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_build.load("fused_loss"), status, "pixel_region_sums")
    global launches
    launches += 1
    return out[0], out[1], out[2], out[3]


def _terms(bce, inter, psum, tsum, n_pix, bce_w, iou_w, cel_w, iou_eps,
           cel_eps) -> torch.Tensor:
    """fused_loss.py ``_terms``: the weighted loss from the sums."""
    b = bce.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=bce.device)
    if bce_w:
        total = total + bce_w * bce.sum() / (b * n_pix)
    if iou_w:
        union = psum + tsum - inter
        total = total + iou_w * torch.mean(
            1.0 - (inter + iou_eps) / (union + iou_eps))
    if cel_w:
        tot = psum + tsum
        total = total + cel_w * torch.mean((tot - 2.0 * inter)
                                           / (tot + cel_eps))
    return total


class _BceIouCelFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets, weights):
        bce, inter, psum, tsum = pixel_region_sums(logits, targets)
        n_pix = logits.numel() // logits.shape[0]
        ctx.weights = weights
        ctx.save_for_backward(logits, targets, inter, psum, tsum)
        return _terms(bce, inter, psum, tsum, n_pix, *weights)

    @staticmethod
    def backward(ctx, g):
        """fused_loss.py ``_bwd``, term for term."""
        logits, targets, inter, psum, tsum = ctx.saved_tensors
        bce_w, iou_w, cel_w, iou_eps, cel_eps = ctx.weights
        b = logits.shape[0]
        n_pix = logits.numel() // b
        x = logits.reshape(b, -1).float()
        t = targets.reshape(b, -1).float()
        p = torch.sigmoid(x)
        grad = torch.zeros_like(x)
        if bce_w:
            grad = grad + bce_w * (p - t) / (b * n_pix)
        if iou_w:
            union = (psum + tsum - inter)[:, None]
            i_e = (inter + iou_eps)[:, None]
            u_e = union + iou_eps
            d_dp = -(t * u_e - i_e * (1.0 - t)) / (u_e * u_e)
            grad = grad + iou_w / b * d_dp * p * (1.0 - p)
        if cel_w:
            tot = (psum + tsum)[:, None]
            i2 = (2.0 * inter)[:, None]
            d_dp = ((1.0 - 2.0 * t) * (tot + cel_eps) - (tot - i2)) / (
                (tot + cel_eps) ** 2)
            grad = grad + cel_w / b * d_dp * p * (1.0 - p)
        grad = (g * grad).reshape(logits.shape).to(logits.dtype)
        return grad, None, None


def fused_bce_iou_cel(logits: torch.Tensor, targets: torch.Tensor,
                      bce_w: float = 1.0, iou_w: float = 1.0,
                      cel_w: float = 0.0, iou_eps: float = 1.0,
                      cel_eps: float = 1e-6) -> torch.Tensor:
    """``bce_w*mean(BCE) + iou_w*mean_i(IoU_i) + cel_w*mean_i(CEL_i)``,
    exactly the plain ``losses`` terms combined, through one kernel
    pass."""
    return _BceIouCelFn.apply(logits, targets,
                              (bce_w, iou_w, cel_w, iou_eps, cel_eps))
