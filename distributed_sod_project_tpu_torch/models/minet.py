"""MINet (CVPR 2020) over the VGG16 pyramid: the counterpart of the JAX
``models/minet.py``.

backbone -> AIM per level (the level fused with its resampled
neighbours) -> top-down decoder of SIM blocks (a high/low-resolution
branch pair that exchange information) -> head -> one full-resolution
logit map.  Every conv is one fused-conv launch and every exact 2x
upsample(+merge) one fused-resample launch.  That includes the head's
bare ``nn.Conv(1, (3, 3))`` (minet.py:140 of the JAX package, computed
there outside Pallas): here it is ``fused_conv`` in mode ``bias``
without ReLU, the same ``conv -> round -> + bias`` order as ``nn.Conv``.

Submodule lists keep flax's creation order, so ``weights.py`` maps
``AIM_i/ConvBNAct_j`` onto ``aims[i].cbas[j]`` one to one.  In SIM that
order is outer-before-inner: flax evaluates the constructor of
``ConvBNAct(...)(ConvBNAct(...)(x))`` before its argument.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .backbones import VGG16
from .backbones.vgg import WIDTHS
from .layers import (Conv, ConvBNAct, max_pool, resample_merge, resize_to,
                     upsample_like)


class AIM(nn.Module):
    """Aggregate interaction: a level fused with its resampled
    neighbours by one conv over their channel concat."""

    def __init__(self, width: int, c_cur: int, c_below: Optional[int],
                 c_above: Optional[int], bn_momentum: float):
        super().__init__()
        ins = [c for c in (c_cur, c_below, c_above) if c is not None]
        self.cbas = nn.ModuleList(
            [ConvBNAct(c, width, bn_momentum=bn_momentum) for c in ins]
            + [ConvBNAct(width * len(ins), width, bn_momentum=bn_momentum)])
        self.has_below = c_below is not None
        self.has_above = c_above is not None

    def forward(self, below, cur, above, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        it = iter(self.cbas)
        parts = [next(it)(cur, dtype, train)]
        if self.has_below:  # finer level -> downsample to cur's size
            parts.append(resize_to(next(it)(below, dtype, train),
                                   cur.shape[1:3]))
        if self.has_above:  # coarser level -> upsample to cur's size
            parts.append(upsample_like(next(it)(above, dtype, train), cur))
        return next(it)(parts, dtype, train)


class SIM(nn.Module):
    """Self-interaction: high-res / low-res branch exchange."""

    def __init__(self, width: int, cin: int, bn_momentum: float):
        super().__init__()
        w, w2 = width, width // 2
        self.cbas = nn.ModuleList([
            ConvBNAct(i, o, bn_momentum=bn_momentum) for i, o in (
                (cin, w),      # 0: h
                (cin, w2),     # 1: l (before the pool)
                (w, w),        # 2: h2 (outer)
                (w2, w),       # 3: l -> h exchange (inner)
                (w2, w2),      # 4: l2 (outer)
                (w, w2),       # 5: h -> l exchange (inner)
                (w + w2, w),   # 6: merge
            )])

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        c, t = self.cbas, train
        h = c[0](x, dtype, t)
        low = max_pool(c[1](x, dtype, t))
        h2 = c[2](resample_merge(c[3](low, dtype, t), h, mode="add"), dtype, t)
        l2 = c[4](low + max_pool(c[5](h, dtype, t)), dtype, t)
        merged = resample_merge(l2, h2, mode="concat", x_first=False)
        return c[6](merged, dtype, t)


class MINet(nn.Module):
    """MINet-VGG16.  ``dtype`` is the compute dtype (the JAX package's
    ``model.compute_dtype``); parameters keep whatever dtype they hold
    and are cast to it at use, as flax's ``promote_dtype`` does.
    ``bn_momentum`` is every BatchNorm's (``ModelConfig.bn_momentum``)."""

    def __init__(self, *, bn_momentum: float, backbone_bn: bool = True,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.backbone = VGG16(bn_momentum=bn_momentum, use_bn=backbone_bn)
        n = len(WIDTHS)
        self.aims = nn.ModuleList([
            AIM(width, WIDTHS[i], WIDTHS[i - 1] if i > 0 else None,
                WIDTHS[i + 1] if i < n - 1 else None, bn_momentum)
            for i in range(n)])
        self.sims = nn.ModuleList([SIM(width, width, bn_momentum)
                                   for _ in range(n)])
        self.head_cba = ConvBNAct(width, 32, bn_momentum=bn_momentum)
        self.head_conv = Conv(32, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's conv initialisers (lecun-normal kernels, zero biases),
        drawn from ``generator`` in module order; BatchNorm keeps its
        construction-time unit state, as flax's init gives it."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)

    def forward(self, image: torch.Tensor, train: bool = False
                ) -> List[torch.Tensor]:
        """``image`` ``[B,H,W,3]`` (normalised) -> ``[logit]`` with the
        logit ``[B,H,W,1]`` float32 at the input resolution.  ``train``
        normalises with batch statistics and moves the running ones (the
        JAX package's ``train=True``)."""
        cd, t = self.dtype, train
        feats = self.backbone(image.to(cd), cd, t)
        agg = []
        for i, f in enumerate(feats):
            below = feats[i - 1] if i > 0 else None
            above = feats[i + 1] if i < len(feats) - 1 else None
            agg.append(self.aims[i](below, f, above, cd, t))
        d = self.sims[0](agg[-1], cd, t)
        for n, i in enumerate(range(len(agg) - 2, -1, -1)):
            d = resample_merge(d, agg[i], mode="add")
            d = self.sims[n + 1](d, cd, t)
        logit = self.head_conv(self.head_cba(d, cd, t), cd)
        return [resize_to(logit, tuple(image.shape[1:3])).float()]
