"""Attention primitives (port of aot_tpu/ops/attention.py).

Semantics are the JAX package's: global memory attention with per-sample
live lengths, top-k filtering and the eval-time memory-length rescale;
dilated local-window attention with relative key/value biases.

Dispatch is by the tensor's device, not by a global backend flag: the local
attention of a CUDA tensor runs the hand-written kernel
(ops/kernels/local_window_attn.py), a CPU tensor its plain PyTorch version.
Global attention over a long live memory (`use_flash`) goes to the flash
kernel (ops/kernels/flash_attn.py) on a CUDA tensor and to its plain
version on a CPU tensor; below that it is plain PyTorch on both, as the JAX
package leaves it to XLA.

Layouts: sequences are (B, L, C).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import local_window_attn as lwa

NEG_INF = -1e30

# Keys handed to global_attention from which a live-length masked read goes
# to the flash kernel: the JAX package's fp32 default
# (aot_tpu/ops/attention.py:81).
FLASH_MIN_KEYS = 8192

# max score-tensor elements before queries are chunked (~256 MB fp32)
_SCORE_BUDGET = 64 * 1024 * 1024

ValidLen = Union[None, int, torch.Tensor]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _mem_len_rescale(q: torch.Tensor, valid_len, q_len: int,
                     max_mem_len_ratio: float) -> torch.Tensor:
    """Eval-time query rescale for very long memories. valid_len: int or
    (B,) tensor."""
    if max_mem_len_ratio <= 0:
        return q
    if isinstance(valid_len, int):
        ratio = valid_len / q_len
        if ratio <= max_mem_len_ratio:
            return q
        return q * (math.log(ratio) / math.log(max_mem_len_ratio))
    ratio = valid_len.float() / q_len
    scaling = torch.log(ratio) / math.log(max_mem_len_ratio)
    factor = torch.where(ratio > max_mem_len_ratio, scaling,
                         torch.ones_like(scaling))
    return q * factor.reshape((-1,) + (1,) * (q.ndim - 1)).to(q.dtype)


def _topk_filter(scores: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only the top_k logits per query (others -> NEG_INF)."""
    if top_k <= 0 or top_k >= scores.shape[-1]:
        return scores
    kth = torch.topk(scores, top_k, dim=-1).values[..., -1:]
    return torch.where(scores >= kth, scores, torch.full_like(scores, NEG_INF))


def use_flash(lk: int, valid_len, top_k: int,
              max_mem_len_ratio: float) -> bool:
    """The dispatch rule of aot_tpu/ops/attention.py:128 `_use_flash`: a
    read of a live-length masked memory (`valid_len` given) of at least
    FLASH_MIN_KEYS keys, with neither top-k filtering nor the memory-length
    rescale (those stay on the dense path)."""
    return (valid_len is not None and top_k <= 0 and max_mem_len_ratio <= 0
            and lk >= FLASH_MIN_KEYS)


def global_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    d_att: Optional[int] = None,
    *,
    valid_len: ValidLen = None,
    top_k: int = -1,
    max_mem_len_ratio: float = -1.0,
) -> torch.Tensor:
    """Multi-head softmax attention over a (ring-buffered) memory.

    q: (B, Lq, h*d)   k: (B, Lk, h*d)   v: (B, Lk, Cv)
    valid_len: None (all keys live), an int, or a (B,) int tensor — keys
      at or beyond it are masked out.
    Returns (B, Lq, Cv) in v.dtype.
    """
    b, lq, cq = q.shape
    lk = k.shape[1]
    if use_flash(lk, valid_len, top_k, max_mem_len_ratio):
        return fa.flash_attention(q, k, v, valid_len, num_heads,
                                  d_att)[0].to(v.dtype)
    h = num_heads
    d = d_att if d_att is not None else cq // h

    q = q / math.sqrt(d)
    if valid_len is not None:
        q = _mem_len_rescale(q, valid_len, lq, max_mem_len_ratio)

    qh, kh, vh = _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)
    if isinstance(valid_len, torch.Tensor):
        key_ok = (torch.arange(lk, device=k.device)[None, :]
                  < valid_len.reshape(-1, 1))[:, None, None, :]
    elif valid_len is not None and valid_len < lk:
        key_ok = torch.arange(lk, device=k.device) < valid_len
    else:
        key_ok = None

    def attend(qc):
        scores = qc @ kh.transpose(-1, -2)
        if key_ok is not None:
            scores = scores.masked_fill(~key_ok, NEG_INF)
        scores = _topk_filter(scores, top_k)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return attn @ vh

    # bound the score tensor to ~_SCORE_BUDGET elements by chunking queries
    if b * h * lq * lk > _SCORE_BUDGET and lq > 256:
        chunk = min(max(256, _SCORE_BUDGET // max(b * h * lk, 1)), lq)
        out = torch.cat([attend(qc) for qc in qh.split(chunk, dim=2)], dim=2)
    else:
        out = attend(qh)
    return _merge_heads(out).to(v.dtype)


def relative_emb_from_q(q: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-query relative key bias: the grouped 1x1 conv `relative_emb_k`
    as a batched matmul, applied to the unscaled q.

    q: (B, HW, h*d); weight: (h, win2, d); bias: (h, win2)
    -> (B, h, HW, win2), contiguous (the layout the CUDA kernel reads)
    """
    qh = _split_heads(q, num_heads)                 # (B, h, HW, d)
    return qh @ weight.transpose(1, 2) + bias[:, None, :]


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    rel_v: Optional[torch.Tensor],
    *,
    num_heads: int,
    size_2d: Tuple[int, int],
    max_dis: int = 7,
    dilation: int = 1,
    d_att: Optional[int] = None,
) -> torch.Tensor:
    """Dilated local-window attention (the short-term path).

    q, k: (B, HW, h*d)    v: (B, HW, h*dv)
    rel_bias: (B, h, HW, win2) from relative_emb_from_q
    rel_v: (h, dv, win2) relative value bias, or None
    Returns (B, HW, h*dv).

    At dilation 1 a CPU tensor takes the plain version and a CUDA tensor
    the CUDA kernel (local_window_attention); at other dilations only the
    plain version exists, for CPU tensors. Anything else raises.
    """
    kw = dict(num_heads=num_heads, size_2d=tuple(size_2d), max_dis=max_dis,
              d_att=d_att)
    if dilation == 1:
        return lwa.local_window_attention(q, k, v, rel_bias, rel_v, **kw)
    if q.device.type == "cpu":
        return lwa.local_window_attention_plain(
            q, k, v, rel_bias, rel_v, dilation=dilation, **kw)
    raise NotImplementedError(
        f"local attention on {q.device} at dilation {dilation}: the CUDA "
        "kernel serves dilation 1 only (see ROADMAP.md)")


# --- gated propagation (DeAOT) ---------------------------------------------


def gated_global_attention(q, k, v, num_heads: int, d_att: int, *,
                           valid_len: ValidLen = None, top_k: int = -1,
                           max_mem_len_ratio: float = -1.0) -> torch.Tensor:
    """DeAOT's global gated propagation core: softmax attention over the 2x
    value stream (aot_tpu/ops/attention.py:829). The U-gate, depthwise conv
    and projection belong to the calling module."""
    return global_attention(q, k, v, num_heads, d_att, valid_len=valid_len,
                            top_k=top_k, max_mem_len_ratio=max_mem_len_ratio)


def gated_local_attention(q, k, v, rel_bias, *, num_heads: int,
                          size_2d: Tuple[int, int], max_dis: int = 7,
                          dilation: int = 1,
                          d_att: Optional[int] = None) -> torch.Tensor:
    """DeAOT's local gated propagation core, with no relative value bias
    (aot_tpu/ops/attention.py:850)."""
    return local_attention(q, k, v, rel_bias, None, num_heads=num_heads,
                           size_2d=size_2d, max_dis=max_dis,
                           dilation=dilation, d_att=d_att)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (aot_tpu/ops/attention.py:871)."""
    return x * torch.sigmoid(x)
