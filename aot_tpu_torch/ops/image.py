"""Image-space ops (port of aot_tpu/ops/image.py).

Public layout is NHWC, as in the JAX package; the resizes run on an NCHW
view through PyTorch's own interpolation, whose coordinates the JAX
version was written to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int],
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) images to `size` = (H', W')."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def interpolate_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (B, H, W, C) images: source index floor(i * in/out),
    computed as the JAX version does so both pick the same pixels."""
    h, w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    dev = x.device
    iy = (torch.arange(h, device=dev) * (in_h / h)).long().clamp(max=in_h - 1)
    ix = (torch.arange(w, device=dev) * (in_w / w)).long().clamp(max=in_w - 1)
    return x.index_select(-3, iy).index_select(-2, ix)


def one_hot_mask(mask: torch.Tensor, cls_num: int) -> torch.Tensor:
    """(B, H, W) int mask -> (B, H, W, cls_num+1) float32 one-hot."""
    if mask.ndim == 4 and mask.shape[-1] == 1:
        mask = mask[..., 0]
    return F.one_hot(mask.long(), cls_num + 1).float()


def upsample_argmax(logits: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """argmax over channels of the bilinear-upsampled (B, h, w, C) logits.
    Returns (B, H, W) int64 labels (ties go to the lower id, as in JAX)."""
    up = F.interpolate(logits.permute(0, 3, 1, 2), size=tuple(size),
                       mode="bilinear", align_corners=align_corners)
    return up.argmax(dim=1)
