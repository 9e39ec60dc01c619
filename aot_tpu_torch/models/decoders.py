"""FPN segmentation head (port of aot_tpu/models/decoders.py; reference:
networks/decoders/fpn.py:7-63). NCHW."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.models.layers import Conv2d, ConvGN


class FPNSegmentationHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 decode_intermediate_input: bool = True,
                 hidden_dim: int = 256,
                 shortcut_dims: Sequence[int] = (24, 32, 96, 1280),
                 align_corners: bool = True):
        super().__init__()
        hd = hidden_dim
        self.align_corners = align_corners
        self.decode_intermediate_input = decode_intermediate_input
        self.conv_in = ConvGN(in_dim, hd, 1)
        self.conv_16x = ConvGN(hd, hd, 3)
        self.conv_8x = ConvGN(hd, hd // 2, 3)
        self.conv_4x = ConvGN(hd // 2, hd // 2, 3)
        self.adapter_16x = Conv2d(shortcut_dims[-2], hd, 1)
        self.adapter_8x = Conv2d(shortcut_dims[-3], hd, 1)
        self.adapter_4x = Conv2d(shortcut_dims[-4], hd // 2, 1)
        self.conv_out = Conv2d(hd // 2, out_dim, 1)

    def _up(self, x, like):
        return F.interpolate(x, size=like.shape[-2:], mode="bilinear",
                             align_corners=self.align_corners)

    def forward(self, inputs: Sequence[torch.Tensor],
                shortcuts: Sequence[torch.Tensor]) -> torch.Tensor:
        """inputs: [projected 16x shortcut, lstt_emb_1, ...] NCHW;
        shortcuts: the 4 encoder maps NCHW. Returns (B, out_dim, H4, W4)."""
        if self.decode_intermediate_input:
            x = torch.cat(list(inputs), dim=1)
        else:
            x = inputs[-1]
        x = F.relu(self.conv_in(x))
        x = F.relu(self.conv_16x(self.adapter_16x(shortcuts[-2]) + x))
        x = self._up(x, shortcuts[-3])
        x = F.relu(self.conv_8x(self.adapter_8x(shortcuts[-3]) + x))
        x = self._up(x, shortcuts[-4])
        x = F.relu(self.conv_4x(self.adapter_4x(shortcuts[-4]) + x))
        return self.conv_out(x).float()
