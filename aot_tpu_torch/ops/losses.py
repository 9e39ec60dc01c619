"""Segmentation losses of training (port of aot_tpu/ops/losses.py;
reference: networks/layers/loss.py).

Same semantics as the JAX package: top-k hard-pixel-mining cross entropy
whose k ramps with the step, soft Jaccard over the classes present in the
ground truth, ignore index 255, per-sample (B,) results. Logits are NHWC
for `cross_entropy_loss` and `soft_jaccard_loss`, channel-first for
`combined_vos_loss_cf`, which the training engine calls.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

IGNORE = 255

Scalar = Union[float, torch.Tensor]


def topk_sum(values: torch.Tensor, k) -> torch.Tensor:
    """Per-row sum of the k largest entries of a non-negative (B, N) tensor,
    as aot_tpu/ops/losses.py:25 defines it: with t the k-th largest value
    (found on detached values),

        sum_topk = sum(v * (v > t)) + (k - count(v > t)) * t

    equal to the sorted top-k sum, ties included. The threshold is detached,
    so the gradient flows only through the entries strictly above t; it is
    not torch.topk's subgradient, which also reaches the tied entries that
    make up the count (on a clip whose pixels tie, every tied pixel)."""
    b, n = values.shape
    k = torch.as_tensor(k, device=values.device).long().expand(b)
    v = values.detach().clamp_min(0.0)            # -0.0 counts as +0.0
    top = v.sort(dim=1, descending=True).values
    t = top.gather(1, (k - 1).clamp(0, n - 1)[:, None])[:, 0]
    # where JAX's bisection ends for k outside 1..N: k = 0 at the largest
    # finite float (nothing above it, and (k - 0) t = 0), k > N at 0
    t = torch.where(k <= 0, torch.finfo(values.dtype).max,
                    torch.where(k > n, 0.0, t))
    above = v > t[:, None]
    above_sum = torch.where(above, values, 0.0).sum(dim=1)
    return above_sum + (k - above.sum(dim=1)) * t


def _valid_classes(c: int, obj_nums: torch.Tensor) -> torch.Tensor:
    """(B, C) bool: classes 0..obj_num."""
    return torch.arange(c, device=obj_nums.device)[None, :] <= obj_nums[:, None]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       obj_nums: torch.Tensor, *,
                       top_k_percent: Optional[float] = None,
                       top_k_ratio: Scalar = 1.0) -> torch.Tensor:
    """Per-sample CE over NHWC logits with optional top-k hard mining;
    top_k_ratio in [0, 1] ramps the kept fraction from 1 to top_k_percent."""
    b, h, w, c = logits.shape
    valid_cls = _valid_classes(c, obj_nums)[:, None, None, :]
    logits = logits.float().masked_fill(~valid_cls, -1e30)
    valid_px = labels != IGNORE
    lab = torch.where(valid_px, labels, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    nll = torch.where(valid_px, nll, 0.0)
    if top_k_percent is None:
        denom = valid_px.sum(dim=(1, 2)).clamp_min(1)
        return nll.sum(dim=(1, 2)) / denom
    k = _keep_count(top_k_percent, top_k_ratio, h * w, logits.device)
    return topk_sum(nll.reshape(b, h * w), k) / k.clamp_min(1)


def _keep_count(top_k_percent: float, top_k_ratio: Scalar, num_px: int,
                device) -> torch.Tensor:
    ratio = torch.as_tensor(top_k_ratio, dtype=torch.float32, device=device)
    keep = ratio * top_k_percent + (1.0 - ratio)
    return torch.floor(keep * num_px).long()


def soft_jaccard_loss(logits: torch.Tensor, labels: torch.Tensor,
                      obj_nums: torch.Tensor) -> torch.Tensor:
    """Per-sample soft Jaccard (Tversky alpha = beta = 1) over NHWC logits,
    averaged over the classes present in the ground truth."""
    c = logits.shape[-1]
    valid_cls = _valid_classes(c, obj_nums)
    logits = logits.float().masked_fill(~valid_cls[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    valid_px = (labels != IGNORE)[..., None]
    fg = F.one_hot(torch.where(valid_px[..., 0], labels, 0).long(), c).float()
    fg = fg * valid_px
    p = torch.where(valid_px, probs, 0.0)
    inter = (p * fg).sum(dim=(1, 2))
    p_sum = p.sum(dim=(1, 2))
    g_sum = fg.sum(dim=(1, 2))
    loss_c = 1.0 - inter / (p_sum + g_sum - inter + 1e-6)
    present = (g_sum > 0) & valid_cls
    return (loss_c * present).sum(dim=1) / present.sum(dim=1).clamp_min(1)


def combined_vos_loss_cf(logits: torch.Tensor, labels: torch.Tensor,
                         obj_nums: torch.Tensor, *,
                         top_k_percent: float = 0.15,
                         top_k_ratio: Scalar = 1.0, bce_weight: float = 0.5,
                         iou_weight: float = 0.5) -> torch.Tensor:
    """0.5 top-k CE + 0.5 soft Jaccard over channel-first (B, C, H, W)
    logits, sharing one softmax (aot_tpu/ops/losses.py:151). Returns (B,)."""
    b, c, h, w = logits.shape
    valid_cls = _valid_classes(c, obj_nums)
    x = logits.float().masked_fill(~valid_cls[:, :, None, None], -1e30)
    lse = torch.logsumexp(x, dim=1)                       # (B, H, W)

    valid_px = labels != IGNORE
    lab = torch.where(valid_px, labels, 0).long()
    x_lab = x.gather(1, lab[:, None])[:, 0]
    nll = torch.where(valid_px, lse - x_lab, 0.0)
    k = _keep_count(top_k_percent, top_k_ratio, h * w, logits.device)
    ce = topk_sum(nll.reshape(b, h * w), k) / k.clamp_min(1)

    p = torch.exp(x - lse[:, None])
    p = torch.where(valid_px[:, None], p, 0.0)
    ids = torch.arange(c, device=logits.device)[None, :, None, None]
    fg = (lab[:, None] == ids) & valid_px[:, None]
    inter = torch.where(fg, p, 0.0).sum(dim=(2, 3))       # (B, C)
    p_sum = p.sum(dim=(2, 3))
    g_sum = fg.sum(dim=(2, 3)).float()
    loss_c = 1.0 - inter / (p_sum + g_sum - inter + 1e-6)
    present = (g_sum > 0) & valid_cls
    jac = (loss_c * present).sum(dim=1) / present.sum(dim=1).clamp_min(1)
    return bce_weight * ce + iou_weight * jac


def mean_iou(pred: torch.Tensor, target: torch.Tensor, obj_nums: torch.Tensor,
             max_obj_num: int = 10, epsilon: float = 1e-6) -> torch.Tensor:
    """Training-time monitoring IoU (aot_tpu/ops/losses.py:205): mean over
    the foreground objects, then over the samples that have objects; 1.0
    when no sample has one."""
    ids = torch.arange(1, max_obj_num + 1, device=pred.device)[None, :, None, None]
    p = pred[:, None] == ids
    t = target[:, None] == ids
    inter = (p & t).sum(dim=(2, 3)).float()
    union = (p | t).sum(dim=(2, 3)).float()
    iou = (inter + epsilon) / (union + epsilon)
    valid = ids[:, :, 0, 0] <= obj_nums[:, None]
    per_sample = (iou * valid).sum(1) / valid.sum(1).clamp_min(1)
    has_obj = obj_nums > 0
    mean = (per_sample * has_obj).sum() / has_obj.sum().clamp_min(1)
    return torch.where(has_obj.any(), mean, 1.0)
