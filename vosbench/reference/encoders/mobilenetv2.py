"""MobileNetV2 at output stride 16 (networks/encoders/mobilenetv2.py),
under FrozenBN."""

from __future__ import annotations

from typing import List

import torch

from ..model import Params, conv, frozen_bn

# (in, out, stride, dilation, expand) of each inverted residual,
# features[1..17] (mobilenetv2.py:150-197)
MBV2_BLOCKS = ((32, 16, 1, 1, 1), (16, 24, 2, 1, 6), (24, 24, 1, 1, 6),
               (24, 32, 2, 1, 6), (32, 32, 1, 1, 6), (32, 32, 1, 1, 6),
               (32, 64, 2, 1, 6), (64, 64, 1, 1, 6), (64, 64, 1, 1, 6),
               (64, 64, 1, 1, 6), (64, 96, 1, 1, 6), (96, 96, 1, 1, 6),
               (96, 96, 1, 1, 6), (96, 160, 1, 1, 6), (160, 160, 1, 2, 6),
               (160, 160, 1, 2, 6), (160, 320, 1, 2, 6))
MBV2_STAGE_ENDS = (3, 6, 13)


def encode(P: Params, x, ops) -> List[torch.Tensor]:
    def cbr(name, x, stride=1, dilation=1, groups=1):
        k = P[name + ".0.weight"].shape[-1]
        x = conv(P, name + ".0", x, stride, (k - 1) // 2 * dilation, dilation,
                 groups)
        return torch.clamp(frozen_bn(P, name + ".1", x), 0.0, 6.0)

    outs = []
    x = cbr("encoder.features.0", x, stride=2)
    for i, (inp, oup, stride, dil, expand) in enumerate(MBV2_BLOCKS, start=1):
        pre = f"encoder.features.{i}.conv"
        hidden = inp * expand
        y, j = x, 0
        if expand != 1:
            y = cbr(f"{pre}.0", y)
            j = 1
        y = cbr(f"{pre}.{j}", y, stride, dil, groups=hidden)
        y = frozen_bn(P, f"{pre}.{j + 2}", conv(P, f"{pre}.{j + 1}", y))
        x = x + y if stride == 1 and inp == oup else y
        if i in MBV2_STAGE_ENDS:
            outs.append(x)
    x = cbr("encoder.features.18", x)
    return outs + [x]
