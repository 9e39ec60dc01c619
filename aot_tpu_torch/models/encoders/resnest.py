"""ResNeSt-50/101/200/269 encoder: split-attention bottlenecks, deep stem,
avd and avg-down, output stride 16 with layer4 dropped (port of
aot_tpu/models/encoders/resnest.py; reference: networks/encoders/resnest/
{resnet,splat,resnest}.py). Emits [256, 512, 1024, 1024] NCHW.

Module names are the reference's: the deep stem `conv1.{0,1,3,4,6}`, the
split-attention conv `conv2.{conv,bn0,fc1,bn1,fc2}` (fc1 and fc2 are 1x1
convs) and the avg-down shortcut `downsample.{1,2}` after its pool.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from aot_tpu_torch.models.layers import Conv2d
from aot_tpu_torch.models.encoders.common import (FrozenBatchNorm2d,
                                                  avd_pool, avg_down_pool,
                                                  conv_kaiming, stem_max_pool)

# (planes, stride) of layer1..3
_PLAN = ((64, 1), (128, 2), (256, 2))

# name -> (blocks of layer1..3, stem width) (aot_tpu resnest.py:113-130)
_NAMED = {"resnest50": ((3, 4, 6), 32), "resnest101": ((3, 4, 23), 64),
          "resnest200": ((3, 24, 36), 64), "resnest269": ((3, 30, 48), 64)}


class SplAtConv2d(nn.Module):
    """Split-attention conv, radix 2, cardinality 1 (reference:
    resnest/splat.py:15-131): a grouped 3x3 conv into `radix` splits, a
    gate from their summed global mean (fc1, BN, ReLU, fc2, softmax over
    the radix axis) and the gated sum of the splits."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dilation: int = 1, radix: int = 2):
        super().__init__()
        self.radix = radix
        inter = max(in_channels * radix // 4, 32)
        self.conv = conv_kaiming(in_channels, channels * radix, 3, stride,
                                 dilation, groups=radix)
        self.bn0 = FrozenBatchNorm2d(channels * radix)
        self.relu = nn.ReLU()
        self.fc1 = Conv2d(channels, inter, 1)
        self.bn1 = FrozenBatchNorm2d(inter)
        self.fc2 = Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        split = y.view(b, self.radix, -1, h, w)
        gap = split.sum(1).mean((2, 3), keepdim=True)        # (B, C, 1, 1)
        gap = self.relu(self.bn1(self.fc1(gap)))
        # the radix softmax in fp32 (aot_tpu resnest.py:49-51)
        atten = self.fc2(gap).view(b, self.radix, -1).float().softmax(1)
        atten = atten.to(y.dtype)
        return (split * atten[..., None, None]).sum(1)


class SplAtBottleneck(nn.Module):
    """reference: resnest/resnet.py:37-177, avd after conv2 (avd_first
    False) where the block strides."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 avd: bool = True, is_first: bool = False):
        super().__init__()
        use_avd = avd and (stride > 1 or is_first)
        self.conv1 = conv_kaiming(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = SplAtConv2d(planes, planes, 1 if use_avd else stride,
                                 dilation)
        self.avd_layer = avd_pool(stride) if use_avd else None
        self.conv3 = conv_kaiming(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = nn.Sequential(
            avg_down_pool(stride), conv_kaiming(inplanes, planes * 4, 1),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.conv2(y)
        if self.avd_layer is not None:
            y = self.avd_layer(y)
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class ResNeSt(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 23),
                 stem_width: int = 64):
        super().__init__()
        sw = stem_width
        self.conv1 = nn.Sequential(   # deep stem (resnet.py:232-263)
            conv_kaiming(3, sw, 3, 2), FrozenBatchNorm2d(sw), nn.ReLU(),
            conv_kaiming(sw, sw, 3), FrozenBatchNorm2d(sw), nn.ReLU(),
            conv_kaiming(sw, sw * 2, 3))
        self.bn1 = FrozenBatchNorm2d(sw * 2)
        self.relu = nn.ReLU()
        self.maxpool = stem_max_pool()
        inplanes = sw * 2
        for i, ((planes, stride), n_blocks) in enumerate(zip(_PLAN, layers),
                                                         start=1):
            blocks = [SplAtBottleneck(inplanes, planes, stride,
                                      downsample=True)]
            blocks += [SplAtBottleneck(planes * 4, planes)
                       for _ in range(n_blocks - 1)]
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.n_stages = len(layers)

    @classmethod
    def named(cls, name: str) -> "ResNeSt":
        if name not in _NAMED:
            raise NotImplementedError(name)
        layers, stem_width = _NAMED[name]
        return cls(layers, stem_width)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        outs.append(outs[-1])
        return outs
