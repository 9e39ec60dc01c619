"""MobileNet-V3-Large encoder, output stride 16 (port of
aot_tpu/models/encoders/mobilenetv3.py; reference: networks/encoders/
mobilenetv3.py:142-239).

Emits [x4 (24ch), x8 (40ch), x16 (112ch), x16 (960ch)] NCHW: the stage
split features[0:4] / [4:7] / [7:13] / [13:], the last through the final
1x1 conv. Module names are the reference's (`features.<i>.conv.<j>`, the
squeeze-excite `fc.0` / `fc.2`, the final `conv.0`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.models.encoders.common import FrozenBatchNorm2d, conv_kaiming
from aot_tpu_torch.models.layers import Linear

# (k, t, c, SE, HS, s) walked at output stride 16
# (reference: mobilenetv3.py:155-172,178-193)
_CFGS = [
    (3, 1, 16, 0, 0, 1),
    (3, 4, 24, 0, 0, 2),
    (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2),
    (5, 3, 40, 1, 0, 1),
    (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2),
    (3, 2.5, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2),
    (5, 6, 160, 1, 1, 1),
    (5, 6, 160, 1, 1, 1),
]

_STAGE_ENDS = (3, 6, 12)  # features[i] ending the 4x / 8x / 16x stages


def _make_divisible(v, divisor=8, min_value=None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _walk_cfgs(output_stride: int = 16):
    """Per block (k, exp, out, se, hs, stride, dilation, inp), and the last
    expansion width (the final conv's)."""
    blocks = []
    inp = _make_divisible(16)
    now_stride, rate = 2, 1
    for (k, t, c, se, hs, s) in _CFGS:
        if now_stride == output_stride:
            dilation = rate
            rate *= s
            s = 1
        else:
            dilation = 1
            now_stride *= s
        out = _make_divisible(c)
        exp = _make_divisible(inp * t)
        blocks.append((k, exp, out, se, hs, s, dilation, inp))
        inp = out
    return blocks, exp


class HSigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(x + 3.0) / 6.0


class HSwish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.relu6(x + 3.0) / 6.0


class SELayer(nn.Module):
    """Squeeze-excite with a hard sigmoid (reference: mobilenetv3.py:51-66)."""

    def __init__(self, channel: int):
        super().__init__()
        inter = _make_divisible(channel // 4)
        self.fc = nn.Sequential(Linear(channel, inter), nn.ReLU(),
                                Linear(inter, channel), HSigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean((2, 3)))[:, :, None, None]


def _conv_bn_act(inp: int, oup: int, k: int, stride: int = 1,
                 act: type = HSwish) -> nn.Sequential:
    return nn.Sequential(conv_kaiming(inp, oup, k, stride),
                         FrozenBatchNorm2d(oup), act())


class InvertedResidualV3(nn.Module):
    """reference: mobilenetv3.py:69-113. Without an expansion: depthwise,
    act, SE, project; with one: expand, act, depthwise, SE, act, project."""

    def __init__(self, inp: int, exp: int, out: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool, dilation: int = 1):
        super().__init__()
        act = HSwish if use_hs else nn.ReLU
        se = SELayer(exp) if use_se else nn.Identity()
        dw = [conv_kaiming(exp, exp, kernel, stride, dilation, groups=exp),
              FrozenBatchNorm2d(exp)]
        project = [conv_kaiming(exp, out, 1), FrozenBatchNorm2d(out)]
        if inp == exp:
            layers = dw + [act(), se] + project
        else:
            layers = ([conv_kaiming(inp, exp, 1), FrozenBatchNorm2d(exp),
                       act()] + dw + [se, act()] + project)
        self.conv = nn.Sequential(*layers)
        self.identity = stride == 1 and inp == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.identity else y


class MobileNetV3Large(nn.Module):
    def __init__(self):
        super().__init__()
        blocks, last_exp = _walk_cfgs(16)
        feats: List[nn.Module] = [_conv_bn_act(3, _make_divisible(16), 3, 2)]
        feats += [InvertedResidualV3(inp, exp, out, k, s, bool(se), bool(hs),
                                     d)
                  for (k, exp, out, se, hs, s, d, inp) in blocks]
        self.features = nn.Sequential(*feats)
        self.conv = _conv_bn_act(blocks[-1][2], last_exp, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _STAGE_ENDS:
                outs.append(x)
        outs.append(self.conv(x))
        return outs  # [x4, x8, x16, x16]
