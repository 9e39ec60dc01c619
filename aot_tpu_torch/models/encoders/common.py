"""Shared encoder building blocks (port of aot_tpu/models/encoders/common.py)."""

from __future__ import annotations

import torch
from torch import nn

from aot_tpu_torch.models.layers import Conv2d


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (reference:
    networks/layers/normalization.py:6-43; aot_tpu's
    FrozenBatchNorm(frozen=True)). Four buffers — weight, bias,
    running_mean, running_var — and no num_batches_tracked, so the
    reference state dict loads strictly. Starts as the identity
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


class _ChannelMoments(torch.autograd.Function):
    """Per-channel sum and sum of squares of an NCHW tensor, accumulated
    in fp64 whatever its dtype and kept in fp64 through the sum across
    ranks, so the moments, rounded to fp32 last, do not depend on how the
    batch is split over ranks or on the reduction's order: a
    data-parallel step then computes the one-process step on the same
    global batch (loss and grad norm within 1e-5). With trainable BN at
    seeded weights the step moves its deep encoder gradients by 4-6% of
    their scale at input changes of 1e-7 relative (ReLU6's kinks, coupled
    across the batch by the moments; PERF.md section 7), so fp32 sums,
    whose order moves the moments that much, break that equality. The
    backward, in fp32, reads the input autograd already keeps for the
    normalisation's product, so no copy of it is saved."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        x64 = x.double()
        return x64.sum(dim=(0, 2, 3)), x64.square().sum(dim=(0, 2, 3))

    @staticmethod
    def backward(ctx, g_sum, g_sq):
        (x,) = ctx.saved_tensors
        grad = (2.0 * x.float() * g_sq.float()[:, None, None]
                + g_sum.float()[:, None, None])
        return grad.to(x.dtype)


class _SumAcrossRanks(torch.autograd.Function):
    """all_reduce(SUM) with its gradient: each rank's gradient of the sum
    is the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def _global_sums(sums: torch.Tensor) -> torch.Tensor:
    """Sum a (k,) vector across the ranks of a live process group of more
    than one rank, with autograd through the reduction; the vector itself
    on one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return sums
    return _SumAcrossRanks.apply(sums)


class TrainableBatchNorm2d(nn.Module):
    """Trainable BatchNorm with global-batch moments (MODEL_FREEZE_BN=False;
    aot_tpu's FrozenBatchNorm(frozen=False), encoders/common.py:60-83, and
    the reference's SyncBatchNorm, trainer.py:66-67).

    weight and bias are parameters, running_mean and running_var buffers:
    the same four keys as FrozenBatchNorm2d, so the serving model, always
    frozen, loads a trainable-BN checkpoint strictly. In training mode it
    normalises by the batch's biased moments, var = E[x^2] - mean^2 over
    N*H*W (the JAX formula) from sums accumulated in fp64 and rounded to
    fp32 (aot_tpu takes them in fp32; see _ChannelMoments), and moves the
    running stats by momentum 0.1 with the unbiased variance. When a
    process group of more than one rank is live, the channel sums, sums of
    squares and counts are summed across the ranks first, so the moments
    and their gradients are those of the global batch. In eval mode it
    uses the running stats. Scale and shift are cast to x's dtype."""

    MOMENTUM = 0.1      # torch's BatchNorm2d default, as aot_tpu fixes it

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            s1, s2 = _ChannelMoments.apply(x)
            c = s1.shape[0]
            count = s1.new_full((1,), float(x.numel() // c))
            sums = _global_sums(torch.cat([s1, s2, count]))
            n = sums[2 * c:]             # a tensor: no sync with the host
            mean = sums[:c] / n
            var = (sums[c:2 * c] / n - mean.square()).float()
            mean = mean.float()
            with torch.no_grad():
                m = self.MOMENTUM
                unbiased = var * (n / (n - 1).clamp(min=1)).float()
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def unfreeze_bn(module: nn.Module) -> nn.Module:
    """Replace every FrozenBatchNorm2d under `module` by a
    TrainableBatchNorm2d of its width (affine identity, running stats 0
    and 1, as aot_tpu's frozen=False init); returns `module`."""
    for name, child in module.named_children():
        if isinstance(child, FrozenBatchNorm2d):
            bn = TrainableBatchNorm2d(child.weight.shape[0], child.eps)
            setattr(module, name, bn.to(child.weight.device))
        else:
            unfreeze_bn(child)
    return module


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
