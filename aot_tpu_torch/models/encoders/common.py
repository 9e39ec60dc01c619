"""Shared encoder building blocks (port of aot_tpu/models/encoders/common.py)."""

from __future__ import annotations

import torch
from torch import nn

from aot_tpu_torch.models.layers import Conv2d


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, frozen mode
    only (reference: networks/layers/normalization.py:6-43). Four buffers —
    weight, bias, running_mean, running_var — and no num_batches_tracked,
    so the reference state dict loads strictly. Starts as the identity
    (running_var = 1 - eps), as the reference does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.full((features,), 1 - eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Scale and shift from the fp32 buffers, cast to x's dtype
        (aot_tpu/models/encoders/common.py:52-58)."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def conv_kaiming(in_dim: int, out_dim: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False) -> Conv2d:
    """Encoder conv with 'same' padding (k-1)//2*dilation; its kaiming
    (fan_out) init is applied by the model's init_weights."""
    return Conv2d(in_dim, out_dim, kernel_size, stride=stride,
                     padding=(kernel_size - 1) // 2 * dilation,
                     dilation=dilation, groups=groups, bias=bias)


def stem_max_pool() -> nn.MaxPool2d:
    """The ResNet stem's MaxPool2d(3, 2, padding=1); torch pads with -inf,
    so the padding never wins (aot_tpu resnet.py:59)."""
    return nn.MaxPool2d(3, 2, 1)


def avd_pool(stride: int) -> nn.AvgPool2d:
    """ResNeSt's avd pool after the split-attention conv: AvgPool2d(3,
    stride, 1), the padding counted (aot_tpu resnest.py:55)."""
    return nn.AvgPool2d(3, stride, 1, count_include_pad=True)


def avg_down_pool(stride: int) -> nn.Module:
    """ResNeSt's avg-down shortcut pool: a stride x stride mean over the
    cells inside the image, the last window partial on an odd size
    (ceil mode; aot_tpu resnest.py:91-97). The identity at stride 1."""
    if stride == 1:
        return nn.Identity()
    return nn.AvgPool2d(stride, stride, ceil_mode=True,
                        count_include_pad=False)
