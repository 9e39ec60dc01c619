"""Flash-attention forward: the CUDA kernel and its plain PyTorch version.

Port of aot_tpu/ops/pallas/flash_attn_vjp.py:338 flash_attention, forward
(`_flash_fwd_raw` :211, kernel body `_fwd_kernel` :51). The kernel is
csrc/flash_attn_fwd.cu; its header says what bounds it on Hopper. The
global attention over a long LT memory reaches it through
ops/attention.py `use_flash`.

  flash_attention        entry point: a CPU tensor takes the plain version,
                         a CUDA tensor launches the kernel or raises — there
                         is no fallback
  flash_attention_cuda   the kernel wrapper (counts LAUNCHES, or
                         BF16_LAUNCHES for bf16: one per call, which runs
                         the kernel's passes: the scores and P V for
                         dv > 128, and the merge of key splits)
  flash_attention_plain  the same function in plain PyTorch: a masked
                         softmax over the live keys
  flash_attention_train  the differentiable form (the `FlashAttention`
                         autograd Function): this forward, and the backward
                         of ops/kernels/flash_attn_bwd.py

All three return (out, lse): out (B, Lq, h*dv) in v's dtype; lse (B*h,
Lq), fp32, the log-sum-exp of the scaled scores over the live keys. A row
with no live key gives out 0 and lse -1e30, as the TPU kernel does
(:89-96). q, k and v are fp32, or bf16 for bf16 serving and training (the
kernel's bf16 instantiation): fp32 scores, softmax statistics and
accumulation, P rounded to bf16 before P V (`_fwd_kernel` at bf16,
:41-93). `flash_attention_train` takes both, its backward the matching
instantiation of ops/kernels/flash_attn_bwd.py.
valid_len: None (all Lk keys live), an int, or a (B,) int tensor; keys at or
beyond it, or beyond Lk, are dead.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from aot_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
MAX_D = 256       # q/k channels per head (csrc/flash_attn_fwd.cu kMaxD)
_TILE_Q = 64      # queries a block (csrc/flash_attn_fwd.cu kBQ)
# Floats of scores (forward) or of P and of dS each (backward) that the
# two-pass forms keep at once, 256 MB: they run over slabs of query rows
# that fit it. A memory bound, not a route: every width above one value
# tile takes the two passes. A 465x465 DeAOTL read (B*h = 1, Lq = 900,
# Lk <= 19,800) fits one slab; a 1080p read (Lq = 7,232, Lk = 14,464)
# takes two, of 4,608 and 2,624 rows, at the 900-row read's time a
# (query, key) pair (chip_smoke.py phase 3).
SLAB_FLOATS = 1 << 26

ValidLen = Union[None, int, torch.Tensor]

# Kernel launches since the count was last reset, fp32 and bf16 apart; the
# wrapper adds one per launch and nothing else touches them, so a run can
# show it went through the kernel.
LAUNCHES = 0
BF16_LAUNCHES = 0


def _dims(q, v, num_heads: int, d_att: Optional[int]) -> Tuple[int, int]:
    d = d_att if d_att is not None else q.shape[-1] // num_heads
    return d, v.shape[-1] // num_heads


# Elements a 16-byte copy moves: the kernel's widths and strides are
# multiples of it, for each q/k/v type it takes; and its C entry point
_VEC = {torch.float32: 4, torch.bfloat16: 8}
_ENTRY = {torch.float32: "flash_attn_fwd", torch.bfloat16: "flash_attn_fwd_bf16"}


def shape_error(d: int, dv: int,
                dtype: torch.dtype = torch.float32) -> Optional[str]:
    """Why the kernel does not take per-head widths (d, dv) at `dtype`, or
    None."""
    vec = _VEC[dtype]
    if not (0 < d <= MAX_D and d % vec == 0):
        return f"d={d} (a multiple of {vec}, at most {MAX_D})"
    if not (dv > 0 and dv % vec == 0):
        return f"dv={dv} (a positive multiple of {vec})"
    return None


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    # fp32 scores of the widened operands (no copy at fp32)
    qh = (q.float() / math.sqrt(d)).reshape(b, lq, h, d).transpose(1, 2)
    kh = k.float().reshape(b, lk, h, d).transpose(1, 2)
    vh = v.float().reshape(b, lk, h, dv).transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2)
    if valid_len is not None:
        live = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
        key_ok = torch.arange(lk, device=q.device) < live    # (B or 1, Lk)
        scores = scores.masked_fill(~key_ok[:, None, None, :], -math.inf)
    lse = torch.logsumexp(scores, dim=-1)                    # -inf: no key
    empty = torch.isneginf(lse)
    p = torch.exp(scores - lse.masked_fill(empty, 0.0)[..., None])
    # P in v's dtype (no rounding at fp32), P V summed in fp32
    out = (p.to(v.dtype).float() @ vh).transpose(1, 2).reshape(b, lq, h * dv)
    return (out.to(v.dtype),
            lse.masked_fill(empty, NEG_INF).reshape(b * h, lq))


def _entry(dtype: torch.dtype):
    """The kernel's instantiation for q/k/v/out of `dtype`."""
    fn = getattr(_build.load("flash_attn_fwd"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _splits(blocks: int, slots: int, most: int) -> int:
    """Key splits that bring a grid of `blocks` toward `slots` (the blocks
    the card holds at once) without passing it: 1 from `slots` on, at most
    `most` (one key tile a split)."""
    return 1 if blocks >= slots else max(1, min(most, slots // blocks))


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (132 on an H100 SXM)."""
    return _sm_count(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def slab_rows(bh: int, lq: int, lk: int) -> int:
    """Query rows a slab of the two-pass forms: as many 64-row tiles as
    keep B*h*rows*lds floats within SLAB_FLOATS (at least one tile), and
    no more than Lq needs."""
    lds = -(-lk // 32) * 32
    rows = max(_TILE_Q, SLAB_FLOATS // (bh * lds) // _TILE_Q * _TILE_Q)
    return min(rows, -(-lq // _TILE_Q) * _TILE_Q)


def fwd_plan(b: int, lq: int, lk: int, num_heads: int, dv: int,
             sms: int) -> Tuple[int, int, int, int]:
    """(splits, score_splits, slab, scratch floats) of a forward launch
    (csrc/flash_attn_fwd.cu; 64 queries a block) on a card of `sms`
    streaming multiprocessors. Up to dv = 128 one pass: a block per query
    tile takes all of dv, two a multiprocessor, the key loop split across
    blocks where the grid is under those two waves (score_splits and slab
    0; scratch for the splits' out and lse). Above, two passes over slabs
    of query rows (slab_rows): the scores once and then P V over
    128-column value tiles, each pass's key loop split to fill two blocks a
    multiprocessor (score_splits, splits); scratch for a slab's scores, the
    row statistics and the output's splits."""
    h = num_heads
    if dv > 128:
        slab = slab_rows(b * h, lq, lk)
        tiles = -(-min(slab, lq) // _TILE_Q)
        score_splits = _splits(b * h * tiles, 2 * sms, -(-lk // 64))
        splits = _splits(b * h * tiles * -(-dv // 128), 2 * sms,
                         -(-lk // 32))
        scratch = (b * h * slab * (-(-lk // 32) * 32)
                   + 2 * score_splits * b * h * lq
                   + (splits * b * lq * h * dv if splits > 1 else 0))
        return splits, score_splits, slab, scratch
    splits = _splits(b * h * -(-lq // _TILE_Q), 2 * sms, -(-lk // 64))
    return splits, 0, 0, (splits * (b * lq * h * dv + b * h * lq)
                          if splits > 1 else 0)


def _check(name: str, t: torch.Tensor, shape, device,
           dtype: torch.dtype = torch.float32) -> None:
    """`dtype` on `device`, of `shape`, rows contiguous, strides and address
    16-byte aligned (the kernel copies 16 bytes at a time)."""
    vec = _VEC[dtype]
    ok = (t.device == device and t.dtype == dtype
          and tuple(t.shape) == tuple(shape) and t.stride(-1) == 1
          and t.stride(0) % vec == 0 and t.stride(1) % vec == 0
          and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"flash_attention_cuda: {name} must be a {dtype} tensor of shape "
            f"{tuple(shape)} on {device} with unit channel stride and "
            f"16-byte aligned strides; got {t.dtype} {tuple(t.shape)} "
            f"strides {t.stride()} on {t.device}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (fp32 or bf16 q, k, v). q, k, v may be
    strided views (the LT ring's live prefix) as long as each token's
    channels are contiguous. Raises on any input it does not take, and if
    the launch fails."""
    global LAUNCHES, BF16_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: q is on {q.device}")
    dt = q.dtype
    if dt not in _ENTRY:
        raise ValueError(f"flash_attention_cuda: q is {dt}; the kernel takes "
                         f"{sorted(str(t) for t in _ENTRY)}")
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    why = shape_error(d, dv, dt)
    if why is not None or v.shape[-1] != h * dv or lq < 1:
        raise ValueError(f"flash_attention_cuda: unsupported {why or ''} "
                         f"(heads={h}, v width {v.shape[-1]}, Lq={lq})")
    dev = q.device
    _check("q", q, (b, lq, h * d), dev, dt)
    _check("k", k, (b, lk, h * d), dev, dt)
    _check("v", v, (b, lk, h * dv), dev, dt)
    valid_ptr, valid_all = None, lk
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.device != dev or valid_len.dtype != torch.int32
                or tuple(valid_len.shape) != (b,)
                or not valid_len.is_contiguous()):
            raise ValueError(
                "flash_attention_cuda: valid_len must be a contiguous (B,) "
                f"int32 tensor on {dev}; got {valid_len.dtype} "
                f"{tuple(valid_len.shape)} on {valid_len.device}")
        valid_ptr = valid_len.data_ptr()
    elif valid_len is not None:
        valid_all = max(0, min(int(valid_len), lk))

    splits, score_splits, slab, scratch = fwd_plan(b, lq, lk, h, dv,
                                                   sm_count(dev))
    part = (torch.empty(scratch, device=dev, dtype=torch.float32)
            if scratch else None)
    out = torch.empty((b, lq, h * dv), device=dev, dtype=dt)
    lse = torch.empty((b * h, lq), device=dev, dtype=torch.float32)
    err = _entry(dt)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        lse.data_ptr(), None if part is None else part.data_ptr(), splits,
        score_splits, slab, b, h, lq, lk, d, dv, valid_all,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{_ENTRY[dt]} failed to launch: CUDA error {err}")
    if dt == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention over the live keys; returns (out, lse). A CPU
    tensor takes the plain version; any other device goes to the CUDA
    kernel, which raises on what it cannot take."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid_len, num_heads, d_att)
    return flash_attention_cuda(q, k, v, valid_len, num_heads, d_att)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (flash_attn_vjp.py:248-335, the custom
    VJP of `_flash_heads`): the forward saves q, k, v, valid_len, out and
    lse; the backward is ops/kernels/flash_attn_bwd.py. A CUDA tensor runs
    the forward kernel and the backward kernels, a CPU tensor both plain
    versions; there is no third route."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, num_heads, d_att):
        out, lse = flash_attention(q, k, v, valid_len, num_heads, d_att)
        tensors = (q, k, v, out, lse)
        if isinstance(valid_len, torch.Tensor):
            tensors += (valid_len,)
        else:
            ctx.valid_len = valid_len
        ctx.save_for_backward(*tensors)
        ctx.heads = (num_heads, d_att)
        return out

    @staticmethod
    def backward(ctx, dout):
        from aot_tpu_torch.ops.kernels.flash_attn_bwd import flash_attention_bwd

        q, k, v, out, lse, *valid = ctx.saved_tensors
        valid_len = valid[0] if valid else ctx.valid_len
        dq, dk, dv = flash_attention_bwd(q, k, v, valid_len, out, lse, dout,
                                         *ctx.heads)
        return dq, dk, dv, None, None, None


def flash_attention_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    num_heads: int,
    d_att: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention over the live keys with a flash backward; returns
    out (B, Lq, h*dv) in v's dtype. q, k and v are all fp32 or all bf16
    (the dtype of the training step, TRAIN_DTYPE); a CUDA tensor runs the
    forward kernel and the backward kernels of that dtype, a CPU tensor
    their plain versions. valid_len None means all keys live."""
    return FlashAttention.apply(q, k, v, valid_len, num_heads, d_att)
