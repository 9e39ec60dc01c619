"""Image-space ops (port of aot_tpu/ops/image.py).

Public layout is NHWC, as in the JAX package; the resizes run on an NCHW
view through PyTorch's own interpolation, whose coordinates the JAX
version was written to match. The training loss upsamples channel-first
logits with two dense matmuls (`interpolate_bilinear_matmul_cf`), as the
JAX package does, and shuffles object ids with permutation matrices drawn
from an explicit torch.Generator.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def flip_horizontal(x: torch.Tensor) -> torch.Tensor:
    """Mirror (B, H, W) label maps or (B, H, W, C) images left to right
    (the evaluator's flip TTA; jnp.flip(x, axis=2) in the JAX package)."""
    return x.flip(2)


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


def _resize_matrix(in_size: int, out_size: int, align_corners: bool,
                   device=None) -> torch.Tensor:
    """Dense (out, in) bilinear interpolation matrix for one axis: each row
    holds the two lerp weights at torch's source coordinates (clamped at
    the edges), so `A @ x` is F.interpolate's bilinear resize of x."""
    out = np.arange(out_size, dtype=np.float32)
    if align_corners:
        src = (np.zeros((1,), np.float32) if out_size == 1
               else out * ((in_size - 1) / (out_size - 1)))
    else:
        src = np.maximum((out + 0.5) * (in_size / out_size) - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0.astype(np.float32)).astype(np.float32)
    a = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, i0), 1.0 - w)
    np.add.at(a, (rows, i1), w)
    return torch.from_numpy(a).to(device)


def interpolate_bilinear_matmul_cf(x: torch.Tensor, size: Tuple[int, int],
                                   align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of channel-first (..., H, W) tensors to `size` by two
    dense matmuls, Y = A_h X A_w^T (aot_tpu/ops/image.py:106): the resize
    the training loss differentiates."""
    h, w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if in_h != h:
        a_h = _resize_matrix(in_h, h, align_corners, x.device).to(x.dtype)
        x = torch.matmul(a_h, x)
    if in_w != w:
        a_w = _resize_matrix(in_w, w, align_corners, x.device).to(x.dtype)
        x = torch.matmul(x, a_w.T)
    return x


def generate_permute_matrix(dim: int, num: int, generator: torch.Generator,
                            keep_first: bool = True,
                            device=None) -> torch.Tensor:
    """(num, dim, dim) permutation matrices, row 0 (the background) pinned
    when keep_first: the identity shuffle of training
    (aot_tpu/ops/image.py:209). Drawn from `generator`, on its device."""
    eye = torch.eye(dim, device=device)
    mats = []
    for _ in range(num):
        if keep_first:
            perm = torch.randperm(dim - 1, generator=generator,
                                  device=generator.device) + 1
            perm = torch.cat([perm.new_zeros(1), perm])
        else:
            perm = torch.randperm(dim, generator=generator,
                                  device=generator.device)
        mats.append(eye[perm.to(eye.device)])
    return torch.stack(mats)
