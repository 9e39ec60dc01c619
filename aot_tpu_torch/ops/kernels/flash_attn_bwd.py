"""Flash-attention backward: the CUDA kernel and its plain PyTorch version.

Port of aot_tpu/ops/pallas/flash_attn_vjp.py:267 _flash_heads_bwd (kernel
bodies `_bwd_dq_kernel` :104 and `_bwd_dkv_kernel` :148). The kernels are
csrc/flash_attn_bwd.cu; its header says what bounds them on Hopper. The
autograd Function in ops/kernels/flash_attn.py calls this module's entry
point with what the forward saved.

  flash_attention_bwd        entry point: a CPU tensor takes the plain
                             version, a CUDA tensor launches the kernels or
                             raises — there is no fallback
  flash_attention_bwd_cuda   the kernel wrapper (counts LAUNCHES: one per
                             call, which runs the dQ, dK and dV kernels)
  flash_attention_bwd_plain  the same function in plain PyTorch

All three take q, k, v (B, L, h*d / h*dv), valid_len (None, an int or a (B,)
int tensor), the forward's out (B, Lq, h*dv) and lse (B*h, Lq), and the
output gradient dout (B, Lq, h*dv); they return (dq, dk, dv) in the layouts
of q, k and v, fp32. Keys at or beyond the live length get zero dk and dv; a
row with no live key (lse -1e30) gives zero gradients.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from aot_tpu_torch.ops.kernels import _build
from aot_tpu_torch.ops.kernels.flash_attn import (NEG_INF, ValidLen, _check,
                                                  _dims, shape_error)

# Wrapper calls that launched the kernels since the count was last reset;
# nothing else touches it, so a run can show it went through the kernels.
LAUNCHES = 0

_TILE = 64            # csrc/flash_attn_bwd.cu kT
_MIN_BLOCKS = 264     # two waves on 132 SMs: below it dQ splits its key loop

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """D = rowsum(dO * O) per head, (B*h, Lq) fp32 (flash_attn_vjp.py:274-276)."""
    b, lq, _ = out.shape
    prod = (dout.float() * out.float()).reshape(b, lq, num_heads, -1)
    return prod.sum(-1).transpose(1, 2).reshape(b * num_heads, lq)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Grads:
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    scale = 1.0 / math.sqrt(d)
    qh = (q.float() * scale).reshape(b, lq, h, d).transpose(1, 2)
    kh = k.float().reshape(b, lk, h, d).transpose(1, 2)
    vh = v.float().reshape(b, lk, h, dv).transpose(1, 2)
    doh = dout.float().reshape(b, lq, h, dv).transpose(1, 2)
    lse4 = lse.reshape(b, h, lq, 1)
    live = lse4 > NEG_INF / 10                          # (B, h, Lq, 1)
    if valid_len is not None:
        n = torch.as_tensor(valid_len, device=q.device).reshape(-1, 1)
        key_ok = torch.arange(lk, device=q.device) < n   # (B or 1, Lk)
        live = live & key_ok[:, None, None, :]
    p = torch.where(live, torch.exp(qh @ kh.transpose(-1, -2) - lse4), 0.0)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - _delta(out, dout, h).reshape(b, h, lq, 1))

    def merge(x, length):
        return x.transpose(1, 2).reshape(b, length, -1)

    return (merge(ds @ kh * scale, lq), merge(ds.transpose(-1, -2) @ qh, lk),
            merge(p.transpose(-1, -2) @ doh, lk))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    fn = lib.flash_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Grads:
    """Launch the CUDA kernels (fp32). q, k, v may be strided views, as the
    forward takes them. Raises on any input they do not take, and if a
    launch fails."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda: q is on {q.device}")
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    why = shape_error(d, dv)
    if why is not None or v.shape[-1] != h * dv or lq < 1 or lk < 1:
        raise ValueError(f"flash_attention_bwd_cuda: unsupported {why or ''} "
                         f"(heads={h}, v width {v.shape[-1]}, Lq={lq}, "
                         f"Lk={lk})")
    dev = q.device
    _check("q", q, (b, lq, h * d), dev)
    _check("k", k, (b, lk, h * d), dev)
    _check("v", v, (b, lk, h * dv), dev)
    dout = dout.contiguous()
    _check("dout", dout, (b, lq, h * dv), dev)
    _check("out", out, (b, lq, h * dv), dev)
    if (lse.device != dev or lse.dtype != torch.float32
            or tuple(lse.shape) != (b * h, lq) or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda: lse must be a contiguous "
                         f"({b * h}, {lq}) float32 tensor on {dev}")
    valid_ptr, valid_all = None, lk
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.device != dev or valid_len.dtype != torch.int32
                or tuple(valid_len.shape) != (b,)
                or not valid_len.is_contiguous()):
            raise ValueError(
                "flash_attention_bwd_cuda: valid_len must be a contiguous "
                f"(B,) int32 tensor on {dev}; got {valid_len.dtype} "
                f"{tuple(valid_len.shape)} on {valid_len.device}")
        valid_ptr = valid_len.data_ptr()
    elif valid_len is not None:
        valid_all = max(0, min(int(valid_len), lk))

    delta = _delta(out, dout, h).contiguous()
    blocks = b * h * -(-lq // _TILE)
    splits = 1 if blocks >= _MIN_BLOCKS else min(
        -(-lk // _TILE), -(-_MIN_BLOCKS // blocks))
    dq_part = (torch.empty((splits, b, lq, h * d), device=dev,
                           dtype=torch.float32) if splits > 1 else None)
    dq = torch.empty((b, lq, h * d), device=dev, dtype=torch.float32)
    dk = torch.empty((b, lk, h * d), device=dev, dtype=torch.float32)
    dv_ = torch.empty((b, lk, h * dv), device=dev, dtype=torch.float32)
    err = _lib().flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv_.data_ptr(), None if dq_part is None else dq_part.data_ptr(),
        splits, b, h, lq, lk, d, dv, valid_all,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn_bwd failed to launch: CUDA error {err}")
    LAUNCHES += 1
    return dq, dk, dv_


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: ValidLen,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    d_att: Optional[int] = None,
) -> Grads:
    """(dq, dk, dv) of the flash forward. A CPU tensor takes the plain
    version; any other device goes to the CUDA kernels, which raise on what
    they cannot take."""
    args = (q, k, v, valid_len, out, lse, dout, num_heads, d_att)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(*args)
    return flash_attention_bwd_cuda(*args)
