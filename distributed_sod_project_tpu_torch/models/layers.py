"""NHWC building blocks of the port's model zoo.

Counterpart of ``distributed_sod_project_tpu/models/layers.py``.  Maps
stay NHWC (``[B, H, W, C]`` contiguous tensors) end to end, because both
kernels take NHWC and the JAX package's public layout is NHWC.  Every
conv goes through ``kernels.fused_conv`` and every exact 2x upsample
through ``kernels.fused_resample``; what stays plain PyTorch here is
what the JAX package also computes outside Pallas (max pooling, the
antialiased 2x downsample, resizes at other ratios).

Parameters keep the JAX layout and names: a conv kernel is HWIO
``(kh, kw, cin, cout)`` (``Conv.kernel``), BatchNorm holds
``scale``/``bias`` parameters and ``mean``/``var`` buffers.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import fused_conv as fc
from ..kernels import fused_resample as fr

BN_EPS = 1e-5  # flax BatchNorm's default epsilon

Maps = Union[torch.Tensor, Sequence[torch.Tensor]]


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at +-2 std, rescaled so
    the variance is ``1 / fan_in`` (the numbers differ from JAX's: the
    generators differ)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Conv(nn.Module):
    """A conv's parameters: HWIO ``kernel`` and optional ``bias`` (flax
    ``nn.Conv``'s names and layout).  Called on its own it is the head's
    bare ``nn.Conv`` (``+ bias``, no activation), through the kernel."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3), use_bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.kernel = nn.Parameter(
            torch.empty(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * cin, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        vecs = {"bias": self.bias.to(dtype).float()}
        return fc.fused_conv([x.to(dtype)], self.kernel.to(dtype), vecs,
                             kernel=self.kernel_size, mode="bias")


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` state (``scale``/``bias`` parameters,
    ``mean``/``var`` running statistics) and its train-mode forward;
    ``momentum`` is flax's (``ModelConfig.bn_momentum``)."""

    def __init__(self, features: int, momentum: float):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(mean, mul, beta)`` as f32 vectors for the kernel, with
        ``mul = rsqrt(var + eps) * scale`` in flax ``_normalize``'s op
        order, computed at the state's own dtype."""
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return self.mean.float(), mul.float(), self.bias.float()

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise NHWC ``x`` with its batch statistics and move the
        running ones, as flax ``BatchNorm(use_running_average=False)``
        does (normalization.py ``_compute_stats`` / ``_normalize``):
        statistics in f32 with the fast biased variance
        ``max(0, E[x^2] - E[x]^2)``, ``ra = m * ra + (1 - m) * batch``
        storing that biased variance, and the result cast back to
        ``x``'s dtype.  ``nn.BatchNorm2d`` keeps the unbiased variance
        instead, so it is not used."""
        x32 = x.float()
        axes = tuple(range(x.ndim - 1))
        mean = x32.mean(axes)
        var = torch.clamp_min((x32 * x32).mean(axes) - mean * mean, 0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return ((x32 - mean) * mul + self.bias).to(x.dtype)


def _as_parts(x: Maps) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class ConvBNAct(nn.Module):
    """3x3 conv -> BatchNorm (or the conv bias) -> ReLU, NHWC.  A
    list/tuple input is convolved as its channel concat without building
    it (the decoder-head idiom).

    Inference is ONE launch of the fused conv kernel (BN folded into its
    epilogue).  Training needs whole-batch statistics, so, as the JAX
    package's fused arm does (models/layers.py:224-255), the kernel runs
    the conv alone (mode ``none``) and the train-mode BatchNorm and the
    ReLU follow it as tensor code."""

    def __init__(self, in_features: int, features: int, *,
                 bn_momentum: float, use_bn: bool = True, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv(in_features, features, use_bias=not use_bn)
        self.bn = BatchNorm(features, bn_momentum) if use_bn else None

    def forward(self, x: Maps, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        parts = [p.to(dtype) for p in _as_parts(x)]
        w = self.conv.kernel.to(dtype)
        kernel = self.conv.kernel_size
        if self.bn is not None and train:
            y = self.bn.train_forward(
                fc.fused_conv(parts, w, kernel=kernel, mode="none"))
            return torch.relu(y) if self.act else y
        if self.bn is not None:
            mean, mul, beta = self.bn.fold()
            vecs, mode = {"mean": mean, "mul": mul, "bias": beta}, "bn"
        else:
            vecs = {"bias": self.conv.bias.to(dtype).float()}
            mode = "bias"
        return fc.fused_conv(parts, w, vecs, kernel=kernel, mode=mode,
                             relu=self.act)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """flax ``max_pool(padding="SAME")``: at an odd size the last window
    holds one element, which is torch's ``ceil_mode=True``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, ceil_mode=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _downsample2_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Antialiased factor-2 bilinear downsample along one axis: the
    ``[1,3,3,1]/8`` triangle at half-pixel phase with the edge outputs
    renormalised over their in-range taps (``/0.875``), as
    ``jax.image.resize``'s default computes it."""
    n = x.shape[axis]
    m = n // 2
    xe = x.narrow(axis, 0, 2 * m).unflatten(axis, (m, 2)).select(axis + 1, 0)
    xo = x.narrow(axis, 0, 2 * m).unflatten(axis, (m, 2)).select(axis + 1, 1)
    if m == 1:  # both outer taps cut: renorm [_,3,3,_]/6 = plain mean
        return (xe + xo) * 0.5
    zero = torch.zeros_like(xo.narrow(axis, 0, 1))
    xo_m1 = torch.cat([zero, xo.narrow(axis, 0, m - 1)], axis)  # x[2i-1]
    xe_p1 = torch.cat([xe.narrow(axis, 1, m - 1), zero], axis)  # x[2i+2]
    y = 0.125 * xo_m1 + 0.375 * xe + 0.375 * xo + 0.125 * xe_p1
    # Rounded to x's dtype first, as jnp.asarray(1/0.875, x.dtype): a
    # Python scalar would multiply a bf16 map at f32 precision instead.
    renorm = torch.tensor(1.0 / 0.875, dtype=x.dtype, device=x.device)
    return torch.cat([y.narrow(axis, 0, 1) * renorm,
                      y.narrow(axis, 1, m - 2),
                      y.narrow(axis, m - 1, 1) * renorm], axis)


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` weights of ``jax.image.resize(method="bilinear",
    antialias=True)`` along one axis (triangle kernel, half-pixel
    centres, widened by the scale when downsampling, each output column
    renormalised over its in-range taps)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    wts = np.maximum(np.float32(0), np.float32(1) - dist / kscale)
    tot = wts.sum(axis=0, keepdims=True)
    wts = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                   wts / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, 0).astype(np.float32)


def _resize_axis_generic(x: torch.Tensor, axis: int,
                         n_out: int) -> torch.Tensor:
    wts = torch.from_numpy(_bilinear_weights(x.shape[axis], n_out))
    y = torch.tensordot(x.float().movedim(axis, -1), wts.to(x.device),
                        dims=1)
    return y.movedim(-1, axis)


def resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC map to ``hw`` (half-pixel centres, as
    ``jax.image.resize``), split as the JAX package's ``resize_to``
    splits it: an exact 2x upsample runs the fused resample kernel; axes
    that keep their size or halve take the antialiased ``[1,3,3,1]/8``
    downsample; any other ratio applies ``jax.image.resize``'s own
    per-axis weights to both axes in f32, rounded once."""
    h, w = int(x.shape[1]), int(x.shape[2])
    hw = (int(hw[0]), int(hw[1]))
    if hw == (h, w):
        return x
    if hw == (2 * h, 2 * w):
        return fr.fused_upsample2(x)
    if all(o in (n, n // 2) and (o == n or n % 2 == 0)
           for n, o in ((h, hw[0]), (w, hw[1]))):
        if hw[0] != h:
            x = _downsample2_axis(x, 1)
        if hw[1] != w:
            x = _downsample2_axis(x, 2)
        return x.contiguous()
    y = _resize_axis_generic(_resize_axis_generic(x, 1, hw[0]), 2, hw[1])
    return y.to(x.dtype).contiguous()


def upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Resize ``x`` to the spatial size of ``ref``."""
    return resize_to(x, (ref.shape[1], ref.shape[2]))


def resample_merge(x: torch.Tensor, lateral: torch.Tensor, mode: str = "add",
                   x_first: bool = True) -> torch.Tensor:
    """Upsample ``x`` to ``lateral``'s spatial size and merge:
    ``mode='add'`` (``up + lateral``) or ``mode='concat'``
    (``[up, lateral]`` when ``x_first``, else ``[lateral, up]``).  An
    exact 2x merge is one launch of the fused resample kernel; other
    ratios (odd map sizes) resize, then merge."""
    if mode not in ("add", "concat"):
        raise ValueError(f"mode must be 'add' or 'concat', got {mode!r}")
    if tuple(lateral.shape[1:3]) == (2 * x.shape[1], 2 * x.shape[2]):
        return fr.fused_upsample2_merge(x, lateral, mode=mode,
                                        x_first=x_first)
    up = resize_to(x, (lateral.shape[1], lateral.shape[2]))
    if mode == "add":
        return up + lateral
    return torch.cat([up, lateral] if x_first else [lateral, up], dim=-1)
