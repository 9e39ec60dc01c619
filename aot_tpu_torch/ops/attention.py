"""Attention primitives (port of aot_tpu/ops/attention.py).

Semantics are the JAX package's: global memory attention with per-sample
live lengths, top-k filtering and the eval-time memory-length rescale;
dilated local-window attention with relative key/value biases.

Dispatch is by the tensor's device, not by a global backend flag: the local
attention of a CUDA tensor runs a hand-written kernel
(ops/kernels/local_window_attn.py: the flat one up to
DENSE_LOCAL_MAX_TOKENS query tokens, the wide one above, as the JAX package
switches; `local_route`), a CPU tensor its plain PyTorch version.
Global attention over a long live memory (`use_flash`) goes to the flash
kernel (ops/kernels/flash_attn.py) on a CUDA tensor and to its plain
version on a CPU tensor; below that it is plain PyTorch on both, as the JAX
package leaves it to XLA. Inside `attn_training_context` (the training
step) every global attention takes the differentiable flash path
(`flash_attention_train`: the forward kernel and the backward kernels on
CUDA, both plain versions on the CPU) and local attention the plain window
form, which autograd differentiates.

Layouts: sequences are (B, L, C).
"""

from __future__ import annotations

import contextlib
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

# Query tokens above which a dilation-1 local read takes the wide kernel:
# the JAX package's crossover, aot_tpu/ops/attention.py:305
# _DENSE_LOCAL_MAX_TOKENS = 2500, a TPU v5e measurement. On the H100 the
# wide kernel is the faster one at 30x30 too (chip_smoke.py phase 3;
# PERF.md), so this switch is kept only until the flat kernel is retired.
# 2,442 tokens (YouTube-VOS 720p at the default resolution) stay on the
# flat kernel; 3,268 (720p at --max_resolution 720) and 7,232 (DAVIS
# 1080p) take the wide one.
DENSE_LOCAL_MAX_TOKENS = 2500

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


# Set by attn_training_context. A process-wide flag, as the JAX package's
# `_TRAINING_TRACE`, and not a thread-local or a context variable: the
# per-frame recompute of a checkpointed forward runs in autograd's device
# threads during backward(), and must take the same routes as the forward.
_TRAINING = False


@contextlib.contextmanager
def attn_training_context():
    """Inside it (forward and backward of a training step), every global
    attention takes the differentiable flash path whatever its size, and
    local attention the plain window form (the JAX package's training trace
    flag, aot_tpu/ops/attention.py:107-155)."""
    global _TRAINING
    prev, _TRAINING = _TRAINING, True
    try:
        yield
    finally:
        _TRAINING = prev


def in_training() -> bool:
    return _TRAINING


def use_flash(lk: int, valid_len, top_k: int,
              max_mem_len_ratio: float) -> bool:
    """The dispatch rule of aot_tpu/ops/attention.py:128 `_use_flash`:
    neither top-k filtering nor the memory-length rescale (those stay on the
    dense path), and then, in training, every read; at serving, a read of a
    live-length masked memory (`valid_len` given) of at least FLASH_MIN_KEYS
    keys."""
    if top_k > 0 or max_mem_len_ratio > 0:
        return False
    if in_training():
        return True
    return valid_len is not None and lk >= FLASH_MIN_KEYS


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
        if in_training():
            return fa.flash_attention_train(q, k, v, valid_len, num_heads,
                                            d_att).to(v.dtype)
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


def local_route(tokens: int, device_type: str, dilation: int,
                training: bool) -> str:
    """Which implementation serves a local read of `tokens` query tokens:
    'plain' (the window form: training on any device, and every CPU
    tensor), 'flat' or 'wide' (the CUDA kernels, at dilation 1, split at
    DENSE_LOCAL_MAX_TOKENS as aot_tpu/ops/attention.py:376-383 splits the
    TPU kernels), or 'none' (a card tensor at another dilation: no kernel
    serves it)."""
    if training or device_type == "cpu":
        return "plain"
    if dilation != 1:
        return "none"
    return "wide" if tokens > DENSE_LOCAL_MAX_TOKENS else "flat"


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

    The route is `local_route`'s. In training (attn_training_context) every
    device takes the window form, differentiable by autograd, as the JAX
    package leaves it to XLA there (aot_tpu/ops/attention.py:351-368): the
    CUDA kernels have no backward. A CPU tensor takes the plain version; a
    CUDA tensor at dilation 1 the flat kernel up to DENSE_LOCAL_MAX_TOKENS
    query tokens and the wide kernel above. Anything else raises.
    """
    kw = dict(num_heads=num_heads, size_2d=tuple(size_2d), max_dis=max_dis,
              d_att=d_att)
    route = local_route(size_2d[0] * size_2d[1], q.device.type, dilation,
                        in_training())
    if route == "plain":
        return lwa.local_window_attention_plain(
            q, k, v, rel_bias, rel_v, dilation=dilation, **kw)
    if route == "wide":
        return lwa.local_window_attention_wide_cuda(q, k, v, rel_bias, rel_v,
                                                    **kw)
    if route == "flat":
        return lwa.local_window_attention_cuda(q, k, v, rel_bias, rel_v, **kw)
    raise NotImplementedError(
        f"local attention on {q.device} at dilation {dilation}: the CUDA "
        "kernels serve dilation 1 only (see ROADMAP.md)")


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
