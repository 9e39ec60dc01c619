"""ResNet-50/101 encoder, output stride 16 with stage 5 dropped (port of
aot_tpu/models/encoders/resnet.py; reference: networks/encoders/
resnet.py:57-199, where layer4 is commented out).

Emits [x4 (256ch), x8 (512ch), x16 (1024ch), x16 (1024ch, the same map)]
NCHW. Module names are torchvision's (`layer<i>.<j>.conv1`,
`.downsample.0`), as the reference checkpoint has them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from aot_tpu_torch.models.encoders.common import (FrozenBatchNorm2d,
                                                  conv_kaiming, stem_max_pool)

# (planes, stride) of layer1..3
_PLAN = ((64, 1), (128, 2), (256, 2))


class Bottleneck(nn.Module):
    """reference: resnet.py:6-55 (stride on the 3x3 conv)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv_kaiming(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = conv_kaiming(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = conv_kaiming(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = nn.Sequential(
            conv_kaiming(inplanes, planes * 4, 1, stride),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class ResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6)):
        super().__init__()
        self.conv1 = conv_kaiming(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = stem_max_pool()
        inplanes = 64
        for i, ((planes, stride), n_blocks) in enumerate(zip(_PLAN, layers),
                                                         start=1):
            blocks = [Bottleneck(inplanes, planes, stride, downsample=True)]
            blocks += [Bottleneck(planes * 4, planes)
                       for _ in range(n_blocks - 1)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.n_stages = len(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        outs.append(outs[-1])   # stage 5 dropped; 16x duplicated
        return outs


def ResNet50() -> ResNet:
    return ResNet((3, 4, 6))


def ResNet101() -> ResNet:
    return ResNet((3, 4, 23))
