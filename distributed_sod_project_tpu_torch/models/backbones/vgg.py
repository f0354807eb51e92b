"""VGG16 feature-pyramid backbone (counterpart of the JAX
``models/backbones/vgg.py``).

Returns the last conv of each stage at strides 1/2/4/8/16 (for a 320 px
input: 320, 160, 80, 40, 20 px), with 64/128/256/512/512 channels.
``use_bn=False`` is the torchvision ``vgg16`` layout (biased convs, no
BatchNorm); ``use_bn=True`` the ``vgg16_bn`` layout.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..layers import ConvBNAct, max_pool

STAGES = (2, 2, 3, 3, 3)  # convs per stage
WIDTHS = (64, 128, 256, 512, 512)


class VGG16(nn.Module):
    def __init__(self, *, bn_momentum: float, use_bn: bool = True):
        super().__init__()
        convs = []
        cin = 3  # RGB
        for n_convs, width in zip(STAGES, WIDTHS):
            for _ in range(n_convs):
                convs.append(ConvBNAct(cin, width, bn_momentum=bn_momentum,
                                       use_bn=use_bn))
                cin = width
        self.convs = nn.ModuleList(convs)  # flax ConvBNAct_0..12 order

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> List[torch.Tensor]:
        feats = []
        it = iter(self.convs)
        for stage, n_convs in enumerate(STAGES):
            if stage > 0:
                x = max_pool(x)
            for _ in range(n_convs):
                x = next(it)(x, dtype, train)
            feats.append(x)
        return feats
