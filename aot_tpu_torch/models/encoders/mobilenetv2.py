"""MobileNet-V2 encoder, output stride 16 with dilated last stages
(port of aot_tpu/models/encoders/mobilenetv2.py; reference:
networks/encoders/mobilenetv2.py:116-247).

Emits [x4 (24ch), x8 (32ch), x16 (96ch), x16-dilated (1280ch)] NCHW, the
reference's stage split features[0:4] / [4:7] / [7:14] / [14:]. Module
names are torchvision's (`features.<i>.conv.<j>`), as the reference
checkpoint has them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from aot_tpu_torch.models.encoders.common import FrozenBatchNorm2d, conv_kaiming

# (in, out, stride, dilation, expand_ratio) for each InvertedResidual at
# output stride 16 (reference mobilenetv2.py:150-159 walked by :178-197)
_BLOCKS: List[Tuple[int, int, int, int, int]] = [
    (32, 16, 1, 1, 1),     # 1
    (16, 24, 2, 1, 6),     # 2
    (24, 24, 1, 1, 6),     # 3
    (24, 32, 2, 1, 6),     # 4
    (32, 32, 1, 1, 6),     # 5
    (32, 32, 1, 1, 6),     # 6
    (32, 64, 2, 1, 6),     # 7
    (64, 64, 1, 1, 6),     # 8
    (64, 64, 1, 1, 6),     # 9
    (64, 64, 1, 1, 6),     # 10
    (64, 96, 1, 1, 6),     # 11  (stride-16 reached; stays 1)
    (96, 96, 1, 1, 6),     # 12
    (96, 96, 1, 1, 6),     # 13
    (96, 160, 1, 1, 6),    # 14  (would-be stride 2 -> 1; first block dil 1)
    (160, 160, 1, 2, 6),   # 15
    (160, 160, 1, 2, 6),   # 16
    (160, 320, 1, 2, 6),   # 17
]

_STAGE_ENDS = (3, 6, 13)  # features[i] ending the 4x / 8x / 16x stages


class ConvBNReLU6(nn.Sequential):
    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__(
            conv_kaiming(in_dim, out_dim, kernel_size, stride, dilation,
                         groups),
            FrozenBatchNorm2d(out_dim),
            nn.ReLU6())


class InvertedResidual(nn.Module):
    """reference: mobilenetv2.py:63-113."""

    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers: List[nn.Module] = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(inp, hidden, 1))
        layers += [
            ConvBNReLU6(hidden, hidden, 3, stride, dilation, groups=hidden),
            conv_kaiming(hidden, oup, 1),
            FrozenBatchNorm2d(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        feats: List[nn.Module] = [ConvBNReLU6(3, 32, 3, 2)]
        feats += [InvertedResidual(*blk) for blk in _BLOCKS]
        feats.append(ConvBNReLU6(320, 1280, 1))
        self.features = nn.Sequential(*feats)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _STAGE_ENDS:
                outs.append(x)
        outs.append(x)
        return outs  # [x4, x8, x16, x16]
