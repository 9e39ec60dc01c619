"""Flash-attention forward: the CUDA kernel and its plain PyTorch version.

Port of aot_tpu/ops/pallas/flash_attn_vjp.py:338 flash_attention, forward
(`_flash_fwd_raw` :211, kernel body `_fwd_kernel` :51). The kernel is
csrc/flash_attn_fwd.cu; its header says what bounds it on Hopper. The
global attention over a long LT memory reaches it through
ops/attention.py `use_flash`.

  flash_attention        entry point: a CPU tensor takes the plain version,
                         a CUDA tensor launches the kernel or raises — there
                         is no fallback
  flash_attention_cuda   the kernel wrapper (counts LAUNCHES)
  flash_attention_plain  the same function in plain PyTorch: a masked
                         softmax over the live keys
  flash_attention_train  the differentiable form (the `FlashAttention`
                         autograd Function): this forward, and the backward
                         of ops/kernels/flash_attn_bwd.py

All three return (out, lse): out (B, Lq, h*dv) in fp32; lse (B*h, Lq), the
log-sum-exp of the scaled scores over the live keys. A row with no live key
gives out 0 and lse -1e30, as the TPU kernel does (:89-96).
valid_len: None (all Lk keys live), an int, or a (B,) int tensor; keys at or
beyond it, or beyond Lk, are dead.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from aot_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
MAX_D = 256       # q/k channels per head (csrc/flash_attn_fwd.cu kMaxD)

ValidLen = Union[None, int, torch.Tensor]

# Kernel launches since the count was last reset; the wrapper adds one per
# launch and nothing else touches it, so a run can show it went through the
# kernel.
LAUNCHES = 0


def _dims(q, v, num_heads: int, d_att: Optional[int]) -> Tuple[int, int]:
    d = d_att if d_att is not None else q.shape[-1] // num_heads
    return d, v.shape[-1] // num_heads


def shape_error(d: int, dv: int) -> Optional[str]:
    """Why the kernel does not take per-head widths (d, dv), or None."""
    if not (0 < d <= MAX_D and d % 4 == 0):
        return f"d={d} (a multiple of 4, at most {MAX_D})"
    if not (dv > 0 and dv % 4 == 0):
        return f"dv={dv} (a positive multiple of 4)"
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
    qh = (q / math.sqrt(d)).reshape(b, lq, h, d).transpose(1, 2)
    kh = k.reshape(b, lk, h, d).transpose(1, 2)
    vh = v.reshape(b, lk, h, dv).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)).float()
    if valid_len is not None:
        live = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
        key_ok = torch.arange(lk, device=q.device) < live    # (B or 1, Lk)
        scores = scores.masked_fill(~key_ok[:, None, None, :], -math.inf)
    lse = torch.logsumexp(scores, dim=-1)                    # -inf: no key
    empty = torch.isneginf(lse)
    p = torch.exp(scores - lse.masked_fill(empty, 0.0)[..., None])
    out = (p.to(v.dtype) @ vh).transpose(1, 2).reshape(b, lq, h * dv)
    return out.float(), lse.masked_fill(empty, NEG_INF).reshape(b * h, lq)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    """fp32 on `device`, of `shape`, rows contiguous, strides and address
    16-byte aligned (the kernel reads float4s)."""
    ok = (t.device == device and t.dtype == torch.float32
          and tuple(t.shape) == tuple(shape) and t.stride(-1) == 1
          and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
          and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"flash_attention_cuda: {name} must be a float32 tensor of shape "
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
    """Launch the CUDA kernel (fp32). q, k, v may be strided views (the LT
    ring's live prefix) as long as each token's channels are contiguous.
    Raises on any input it does not take, and if the launch fails."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: q is on {q.device}")
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    why = shape_error(d, dv)
    if why is not None or v.shape[-1] != h * dv or lq < 1:
        raise ValueError(f"flash_attention_cuda: unsupported {why or ''} "
                         f"(heads={h}, v width {v.shape[-1]}, Lq={lq})")
    dev = q.device
    _check("q", q, (b, lq, h * d), dev)
    _check("k", k, (b, lk, h * d), dev)
    _check("v", v, (b, lk, h * dv), dev)
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

    out = torch.empty((b, lq, h * dv), device=dev, dtype=torch.float32)
    lse = torch.empty((b * h, lq), device=dev, dtype=torch.float32)
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        lse.data_ptr(), b, h, lq, lk, d, dv, valid_all,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn_fwd failed to launch: CUDA error {err}")
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
    out (B, Lq, h*dv) fp32. valid_len None means all keys live."""
    return FlashAttention.apply(q, k, v, valid_len, num_heads, d_att)
