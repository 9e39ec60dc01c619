"""ResNet-50 at output stride 16 (networks/encoders/resnet.py: its first
three stages), under FrozenBN. `resnet` serves any depth of bottleneck
stages."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..model import Params, conv, frozen_bn

# (width, blocks, stride) of layer1..layer3
RESNET50_LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2))


def resnet(P: Params, x, layers: Sequence[Tuple[int, int, int]]
           ) -> List[torch.Tensor]:
    x = torch.relu(frozen_bn(P, "encoder.bn1",
                             conv(P, "encoder.conv1", x, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for li, (_, blocks, stride) in enumerate(layers, start=1):
        for bi in range(blocks):
            pre = f"encoder.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            y = torch.relu(frozen_bn(P, pre + ".bn1",
                                     conv(P, pre + ".conv1", x)))
            y = torch.relu(frozen_bn(P, pre + ".bn2",
                                     conv(P, pre + ".conv2", y, s, 1)))
            y = frozen_bn(P, pre + ".bn3", conv(P, pre + ".conv3", y))
            if bi == 0:
                x = frozen_bn(P, pre + ".downsample.1",
                              conv(P, pre + ".downsample.0", x, s))
            x = torch.relu(x + y)
        outs.append(x)
    return outs + [outs[-1]]


def encode(P: Params, x, ops) -> List[torch.Tensor]:
    return resnet(P, x, RESNET50_LAYERS)
