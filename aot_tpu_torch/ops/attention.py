"""Attention primitives (port of aot_tpu/ops/attention.py).

Semantics are the JAX package's: global memory attention with per-sample
live lengths, top-k filtering and the eval-time memory-length rescale;
dilated local-window attention with relative key/value biases.

Dispatch is by the tensor's device, not by a global backend flag: the local
attention of a CUDA tensor at dilation 1 runs the hand-written local-window
kernel (ops/kernels/local_window_attn.py) at every grid size, where the JAX
package switches between two TPU kernels at 2,500 query tokens
(`local_route`); a CPU tensor its plain PyTorch version.
Global attention over a long live memory (`use_flash`) goes to the flash
kernel (ops/kernels/flash_attn.py) on a CUDA tensor and to its plain
version on a CPU tensor; below that it is plain PyTorch on both, as the JAX
package leaves it to XLA. Inside `attn_training_context` (the training
step) every global attention takes the differentiable flash path
(`flash_attention_train`: the forward kernel and the backward kernels on
CUDA, both plain versions on the CPU) and local attention the window form
(`local_attention_window`, the JAX package's training formulation), which
autograd differentiates.

The knobs are the JAX package's (aot_tpu/ops/attention.py:72-104,
:305-306), with "the TPU" read as "a CUDA tensor": `set_attn_impl`
('auto', 'xla', 'reference', 'window', 'pallas'; build_infer_engine applies
the config's ATTN_IMPL) and `set_attn_thresholds` (the ATTN_FLASH_MIN_KEYS_*
config keys), whose defaults the AOT_TPU_FLASH_MIN_KEYS_BF16 and
AOT_TPU_FLASH_MIN_KEYS_FP32 environment variables set at import. The JAX
package's third threshold, its crossover between two local kernels, has no
counterpart: only the JAX package reads that config key.
'auto' is the routing above. 'xla' and 'reference' never take the flash
path, in training too, and serve local reads with the plain version (no
kernel launch on any device); 'window' serves local reads with
`local_attention_window`; 'pallas' takes the flash path for every global
read and the local kernel for every dilation-1 local read of a CUDA
tensor at any size.

Each read counts its route (utils/tracing.py): `attn.global.flash` or
`attn.global.dense`, with the keys it covered under `<route>.keys` (the
live length where it is a host int, else every key handed over: the
engine hands over the LT ring's live prefix), `attn.local.<route>`, and a
Swin block's window attention `attn.window.kernel` or `attn.window.plain`
with its windows times heads (padded windows included) under
`<route>.windows` (`window_read`).

Swin's window attention (`window_route`): an fp32 CUDA tensor outside
attn_training_context with no gradient asked for, under 'auto' or
'pallas', takes the window kernel (ops/kernels/swin_window_attn.py,
through `window_attention`); everything else the encoder's own plain path
(models/encoders/swin.py).

Layouts: sequences are (B, L, C).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from aot_tpu_torch.ops.kernels import _build
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import local_window_attn as lwa
from aot_tpu_torch.ops.kernels import swin_window_attn as swa
from aot_tpu_torch.utils import tracing

NEG_INF = -1e30

# Keys handed to global_attention from which a live-length masked read goes
# to the flash kernel: the JAX package's defaults for fp32 and bf16
# operands (aot_tpu/ops/attention.py:79-81), TPU v5e measurements, not yet
# measured on this card (ROADMAP). At bf16, AOTT's capped 8-frame ring
# (7,200 keys) takes flash on every step; at fp32 it never does. Read at
# every call: `set_attn_thresholds` (the ATTN_FLASH_MIN_KEYS_* config keys)
# or the environment variables at import move them.
FLASH_MIN_KEYS = int(os.environ.get("AOT_TPU_FLASH_MIN_KEYS_FP32", 8192))
FLASH_MIN_KEYS_BF16 = int(os.environ.get("AOT_TPU_FLASH_MIN_KEYS_BF16", 4096))

# The dispatch mode (set_attn_impl; the config's ATTN_IMPL)
ATTN_IMPLS = ("auto", "xla", "reference", "window", "pallas")
_ATTN_IMPL = "auto"


def set_attn_impl(impl: str) -> str:
    """Set the dispatch mode (one of ATTN_IMPLS); returns the previous one,
    for restore (aot_tpu/ops/attention.py:98)."""
    global _ATTN_IMPL
    if impl not in ATTN_IMPLS:
        raise ValueError(f"ATTN_IMPL {impl!r}: one of {ATTN_IMPLS}")
    prev, _ATTN_IMPL = _ATTN_IMPL, impl
    return prev


def attn_impl() -> str:
    return _ATTN_IMPL


def set_attn_thresholds(flash_min_keys_bf16=None,
                        flash_min_keys_fp32=None) -> None:
    """Override the 'auto' flash crossovers; None keeps one
    (aot_tpu/ops/attention.py:87)."""
    global FLASH_MIN_KEYS_BF16, FLASH_MIN_KEYS
    if flash_min_keys_bf16 is not None:
        FLASH_MIN_KEYS_BF16 = int(flash_min_keys_bf16)
    if flash_min_keys_fp32 is not None:
        FLASH_MIN_KEYS = int(flash_min_keys_fp32)


# The csrc/ libraries that a served read of a CUDA tensor can launch, by
# compute dtype: the local kernel and the flash forward
_SERVING_LIBS = {
    torch.float32: ("local_window_attn_tc", "flash_attn_fwd"),
    torch.bfloat16: ("local_window_attn_bf16", "flash_attn_fwd_bf16"),
}


def load_serving_kernels(dtype: torch.dtype, swin: bool) -> Tuple[str, ...]:
    """Build (nvcc, each source not built yet, all at once) and load the
    libraries that serving a CUDA model computing in `dtype` can launch
    under the dispatch mode, and the window kernel's for an fp32 Swin
    encoder (`swin`); none under 'xla' and 'reference'. Returns their
    names. The engine calls it when it is built on a card
    (engine.infer.build_infer_engine), so that no read pays a build at its
    first use, inside a video: the flash read first runs when a growing
    LT ring passes FLASH_MIN_KEYS."""
    if _ATTN_IMPL in ("xla", "reference"):
        return ()
    names = _SERVING_LIBS[dtype]
    if swin and dtype == torch.float32:
        names += ("swin_window_attn",)
    _build.build(*names)
    for name in names:
        _build.load(name)
    return names


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
        # the factor rounded to q's dtype first, as the JAX package does
        factor = torch.tensor(math.log(ratio) / math.log(max_mem_len_ratio),
                              dtype=q.dtype)
        return q * factor.item()
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


def use_flash(lk: int, valid_len, top_k: int, max_mem_len_ratio: float,
              dtype: torch.dtype = torch.float32) -> bool:
    """The dispatch rule of aot_tpu/ops/attention.py:128 `_use_flash`:
    never under ATTN_IMPL 'xla' or 'reference'; neither top-k filtering nor
    the memory-length rescale (those stay on the dense path); then, in
    training or under 'pallas', every read; otherwise a read of a
    live-length masked memory (`valid_len` given) of at least
    FLASH_MIN_KEYS_BF16 keys for bf16 operands (`dtype`, k's), else
    FLASH_MIN_KEYS. A CPU tensor that takes it runs the flash path's plain
    version (the same function)."""
    if _ATTN_IMPL in ("xla", "reference"):
        return False
    if top_k > 0 or max_mem_len_ratio > 0:
        return False
    if in_training() or _ATTN_IMPL == "pallas":
        return True
    least = FLASH_MIN_KEYS_BF16 if dtype == torch.bfloat16 else FLASH_MIN_KEYS
    return valid_len is not None and lk >= least


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
    Returns (B, Lq, Cv) in v.dtype. At bf16 (aot_tpu/ops/attention.py:
    158-224): fp32 scores and softmax, P cast to v's dtype, P V summed in
    fp32, the output cast to v's dtype (bf16 operands widen to fp32
    exactly).
    """
    b, lq, cq = q.shape
    lk = k.shape[1]
    keys = min(valid_len, lk) if isinstance(valid_len, int) else lk
    if use_flash(lk, valid_len, top_k, max_mem_len_ratio, k.dtype):
        tracing.count("attn.global.flash")
        tracing.count("attn.global.flash.keys", keys)
        if in_training():
            return fa.flash_attention_train(q, k, v, valid_len, num_heads,
                                            d_att).to(v.dtype)
        return fa.flash_attention(q, k, v, valid_len, num_heads,
                                  d_att)[0].to(v.dtype)
    tracing.count("attn.global.dense")
    tracing.count("attn.global.dense.keys", keys)
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

    kf, vf = kh.float(), vh.float()          # no copy at fp32

    def attend(qc):
        scores = qc.float() @ kf.transpose(-1, -2)
        if key_ok is not None:
            scores = scores.masked_fill(~key_ok, NEG_INF)
        scores = _topk_filter(scores, top_k)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return attn.float() @ vf

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
    """Which implementation serves a local read of `tokens` query tokens
    (aot_tpu/ops/attention.py:323-400 `_use_local_kernel`,
    `local_attention`): 'window' (training on any device, or ATTN_IMPL
    'window': `local_attention_window`), 'plain' (a CPU tensor, or ATTN_IMPL
    'xla' or 'reference': the kernel's plain version), 'kernel' (a card
    tensor at dilation 1 under 'auto' or 'pallas', at any `tokens`: the one
    CUDA kernel serves every grid that aot_tpu/ops/attention.py:376-383
    splits between its flat and wide TPU kernels), or 'none' (a card tensor
    at another dilation: no kernel serves it)."""
    if training or _ATTN_IMPL == "window":
        return "window"
    if device_type == "cpu" or _ATTN_IMPL in ("xla", "reference"):
        return "plain"
    return "kernel" if dilation == 1 else "none"


def local_attention_window(
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
    """The training formulation of local attention (port of
    aot_tpu/ops/attention.py:587 local_attention_window): per window row
    offset dy, one (W x Wp) banded product per image row of the padded key
    image, the band of 2*max_dis+1 columns cut out by the flat-view trick
    (flat[x*(Wp+1) + dx] == full[x, x+dx]) and put back by its inverse for
    P V, so no (HW x HW) tensor and no unfolded copy of v is made: at
    DeAOT's dv = 1024 autograd keeps the padded images and the (B, h, H, W,
    Wp) bands, not a (B, h, dv, win², HW) unfold. Casts as the JAX
    package's: q / sqrt(d) in q's dtype, fp32 scores (the products of the
    widened operands summed in fp32) and softmax, P in v's dtype, P V and
    P rel_v (from the fp32 P) summed in fp32, the output in v's dtype.
    Layouts as local_attention's."""
    hgt, wid = size_2d
    hw = hgt * wid
    b = q.shape[0]
    h = num_heads
    d = d_att if d_att is not None else q.shape[-1] // h
    dv = v.shape[-1] // h
    win = 2 * max_dis + 1
    pad = max_dis * dilation
    wp = wid + 2 * pad
    span = (win - 1) * dilation + 1

    def to_img(x, dd):      # (B, HW, h*dd) -> (B, h, H, W, dd), fp32
        return x.reshape(b, hgt, wid, h, dd).permute(0, 3, 1, 2, 4).float()

    q_img = to_img(q / math.sqrt(d), d)
    k_pad = F.pad(to_img(k, d), (0, 0, pad, pad, pad, pad))
    v_pad = F.pad(to_img(v, dv), (0, 0, pad, pad, pad, pad))
    lead = (b, h, hgt)

    def band_extract(full):      # (..., W, Wp) -> (..., W, win)
        flat = F.pad(full.reshape(lead + (wid * wp,)), (0, wid))
        return flat.reshape(lead + (wid, wp + 1))[..., 0:span:dilation]

    def band_embed(band):        # (..., W, win) -> (..., W, Wp)
        grid = band.new_zeros(lead + (wid, wp + 1))
        grid[..., 0:span:dilation] = band
        return grid.reshape(lead + (wid * (wp + 1),))[..., :wid * wp].reshape(
            lead + (wid, wp))

    rows = [band_extract(q_img @ k_pad[:, :, dy * dilation:dy * dilation
                                       + hgt].transpose(-1, -2))
            for dy in range(win)]
    scores = torch.stack(rows, dim=4).reshape(b, h, hw, win * win)
    scores = scores + rel_bias.float()
    valid = lwa._window_valid(hgt, wid, max_dis, dilation, q.device)
    attn = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)
    attn_img = attn.to(v.dtype).float().reshape(b, h, hgt, wid, win, win)
    out = None
    for dy in range(win):
        part = band_embed(attn_img[..., dy, :]) @ v_pad[
            :, :, dy * dilation:dy * dilation + hgt]
        out = part if out is None else out + part
    out = out.reshape(b, h, hw, dv)
    if rel_v is not None:
        out = out + torch.einsum("bhqw,hcw->bhqc", attn, rel_v.float())
    return out.permute(0, 2, 1, 3).reshape(b, hw, h * dv).to(v.dtype)


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
    package takes its window form there (aot_tpu/ops/attention.py:351-368):
    the CUDA kernel has no backward. Otherwise a CPU tensor takes the
    kernel's plain version; a CUDA tensor at dilation 1 the kernel, at any
    grid size (ATTN_IMPL 'window', 'xla' and 'reference' move a read to the
    window form or the plain version). Anything else raises.
    """
    kw = dict(num_heads=num_heads, size_2d=tuple(size_2d), max_dis=max_dis,
              d_att=d_att)
    route = local_route(size_2d[0] * size_2d[1], q.device.type, dilation,
                        in_training())
    if route == "none":
        raise NotImplementedError(
            f"local attention on {q.device} at dilation {dilation}: the CUDA "
            "kernel serves dilation 1 only (see ROADMAP.md)")
    tracing.count("attn.local." + route)
    if route == "window":
        return local_attention_window(q, k, v, rel_bias, rel_v,
                                      dilation=dilation, **kw)
    if route == "plain":
        return lwa.local_window_attention_plain(
            q, k, v, rel_bias, rel_v, dilation=dilation, **kw)
    return lwa.local_window_attention_cuda(q, k, v, rel_bias, rel_v, **kw)


# --- Swin's window attention ----------------------------------------------


def window_route(device_type: str, dtype: torch.dtype,
                 needs_grad: bool) -> str:
    """Which implementation serves a Swin block's (shifted-)window
    attention: 'kernel' (csrc/swin_window_attn.cu through
    `window_attention`) for an fp32 CUDA tensor outside
    attn_training_context with no gradient asked for (the kernel is
    forward-only), under ATTN_IMPL 'auto' or 'pallas'; else 'plain' (the
    encoder's pad/roll/partition path: the CPU, bf16, training, a gradient,
    and 'xla', 'reference' and 'window')."""
    if (_ATTN_IMPL in ("auto", "pallas") and device_type == "cuda"
            and dtype == torch.float32 and not needs_grad
            and not in_training()):
        return "kernel"
    return "plain"


def window_read(x: torch.Tensor, needs_grad: bool, *, num_heads: int,
                size_2d: Tuple[int, int], window: int) -> str:
    """The route of one block's window attention over x (B, H*W, C),
    counted: `attn.window.<route>` and its windows times heads, padded
    windows included, under `attn.window.<route>.windows`."""
    route = window_route(x.device.type, x.dtype, needs_grad)
    hgt, wid = size_2d
    windows = x.shape[0] * -(-hgt // window) * -(-wid // window)
    tracing.count("attn.window." + route)
    tracing.count(f"attn.window.{route}.windows", windows * num_heads)
    return route


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                     table: torch.Tensor, *, num_heads: int,
                     size_2d: Tuple[int, int], window: int,
                     shift: int) -> torch.Tensor:
    """The kernel route's read: from the qkv Linear's output over the
    image's own tokens, qkv (B, H*W, 3C), its bias and the block's relative
    position bias table ((2 window - 1)^2, heads) to the output
    projection's input (B, H*W, C): the window kernel's launch (which
    raises on an input it does not take)."""
    return swa.swin_window_attention_cuda(
        qkv, qkv_bias, table, num_heads=num_heads, size_2d=tuple(size_2d),
        window=window, shift=shift)


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
