"""Flash-attention backward: the CUDA kernel and its plain PyTorch version.

Port of aot_tpu/ops/pallas/flash_attn_vjp.py:267 _flash_heads_bwd (kernel
bodies `_bwd_dq_kernel` :104 and `_bwd_dkv_kernel` :148). The kernels are
csrc/flash_attn_bwd.cu; its header says what bounds them on Hopper. The
autograd Function in ops/kernels/flash_attn.py calls this module's entry
point with what the forward saved.

  flash_attention_bwd        entry point: a CPU tensor takes the plain
                             version, a CUDA tensor launches the kernels or
                             raises — there is no fallback
  flash_attention_bwd_cuda   the kernel wrapper (counter
                             launch.flash_attn_bwd[_bf16]: one per call, which
                             runs D and the packing of the operands, then
                             for d, dv <= 32 the dQ kernel and the dK and
                             dV kernel, or above, slab by slab, the scores
                             kernel (P and dS kept) and the products of dV,
                             dK and dQ from them)
  flash_attention_bwd_plain  the same function in plain PyTorch
  launch_plan                the launch plan and the workspace size, as
                             csrc/flash_attn_bwd_plan.h fills them (the CPU
                             tests build that header alone:
                             tests/test_torch_port_flash_bwd_plan.py)

All three take q, k, v (B, L, h*d / h*dv), valid_len (None, an int or a (B,)
int tensor), the forward's out (B, Lq, h*dv) and lse (B*h, Lq, fp32), and
the output gradient dout (B, Lq, h*dv); they return (dq, dk, dv) in the
layouts and the dtype of q, k and v. Keys at or beyond the live length get
zero dk and dv; a row with no live key (lse -1e30) gives zero gradients.
q, k, v, out and dout are fp32, or bf16 (bf16 training: the kernels' bf16
instantiation), computed as the TPU kernels compute at bf16: fp32 scores,
P, dP, dS, D and sums; P rounded to bf16 before dV = P^T dO, dS before
dQ = dS K and dK = dS^T Q (flash_attn_vjp.py:135, 177, 184); the
gradients rounded to bf16 once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from aot_tpu_torch.ops.kernels import _build, flash_attn
from aot_tpu_torch.ops.kernels.flash_attn import (NEG_INF, ValidLen, _check,
                                                  _dims, shape_error)
from aot_tpu_torch.utils import tracing

_ENTRY = {torch.float32: "flash_attn_bwd", torch.bfloat16: "flash_attn_bwd_bf16"}

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
    # the products read P and dS in the operands' dtype (no rounding at
    # fp32)
    p = p.to(v.dtype).float()
    ds = ds.to(q.dtype).float()

    def merge(x, length, like):
        return x.transpose(1, 2).reshape(b, length, -1).to(like.dtype)

    return (merge(ds @ kh * scale, lq, q),
            merge(ds.transpose(-1, -2) @ qh, lk, k),
            merge(p.transpose(-1, -2) @ doh, lk, v))


# The plan's inputs, in the order of csrc/flash_attn_bwd_plan.h's PlanField
# (q, k, v and out's batch and row strides in elements); the library fills
# the rest of the plan and sizes the workspace: that header alone owns the
# plan
PLAN_FIELDS = ("B", "H", "LQ", "LK", "D", "DV", "VALID_ALL", "Q_SB", "Q_SL",
               "K_SB", "K_SL", "V_SB", "V_SL", "OUT_SB", "OUT_SL")
# ... and what it fills after them (plan_value reads them)
PLAN_OUTPUTS = ("FORM", "SPLITS", "SLAB", "GROUPS", "DQ_PART", "ACC", "DELTA",
                "WORKSPACE")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    if lib.flash_attn_bwd_plan.argtypes is None:
        lib.flash_attn_bwd_plan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_longlong]
        lib.flash_attn_bwd_plan.restype = ctypes.c_longlong
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * 12
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def launch_plan(inputs: Tuple[int, ...], dtype: torch.dtype,
                sms: int) -> Tuple[ctypes.Array, int]:
    """(the C entries' `plan` argument, the workspace bytes) for `inputs`
    (PLAN_FIELDS' values) with q, k, v of `dtype` on a card of `sms`
    multiprocessors, as csrc/flash_attn_bwd_plan.h fills them; made once a
    shape."""
    lib = _lib()
    plan = (ctypes.c_longlong * lib.flash_attn_bwd_plan_len())(*inputs)
    work = lib.flash_attn_bwd_plan(plan, int(dtype == torch.bfloat16), sms,
                                   flash_attn.SLAB_FLOATS)
    if work < 0:
        raise ValueError(f"flash_attn_bwd_plan takes no plan for {inputs}")
    return plan, work


def plan_value(plan: ctypes.Array, name: str) -> int:
    """One field the library filled (PLAN_OUTPUTS), e.g. "SLAB"."""
    return plan[len(PLAN_FIELDS) + PLAN_OUTPUTS.index(name)]


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
    """Launch the CUDA kernels (fp32 or bf16 q, k, v, out and dout). q, k,
    v may be strided views, as the forward takes them. Raises on any input
    they do not take, and if a launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda: q is on {q.device}")
    dt = q.dtype
    if dt not in _ENTRY:
        raise ValueError(f"flash_attention_bwd_cuda: q is {dt}; the kernels "
                         f"take {sorted(str(t) for t in _ENTRY)}")
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = _dims(q, v, h, d_att)
    why = shape_error(d, dv, dt)
    if why is not None or v.shape[-1] != h * dv or lq < 1 or lk < 1:
        raise ValueError(f"flash_attention_bwd_cuda: unsupported {why or ''} "
                         f"(heads={h}, v width {v.shape[-1]}, Lq={lq}, "
                         f"Lk={lk})")
    dev = q.device
    _check("q", q, (b, lq, h * d), dev, dt)
    _check("k", k, (b, lk, h * d), dev, dt)
    _check("v", v, (b, lk, h * dv), dev, dt)
    dout = dout.contiguous()
    _check("dout", dout, (b, lq, h * dv), dev, dt)
    _check("out", out, (b, lq, h * dv), dev, dt)
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

    plan, work_bytes = launch_plan(
        (b, h, lq, lk, d, dv, valid_all, q.stride(0), q.stride(1),
         k.stride(0), k.stride(1), v.stride(0), v.stride(1), out.stride(0),
         out.stride(1)), dt, flash_attn.sm_count(dev))
    work = torch.empty(work_bytes, device=dev, dtype=torch.uint8)
    dq = torch.empty((b, lq, h * d), device=dev, dtype=dt)
    dk = torch.empty((b, lk, h * d), device=dev, dtype=dt)
    dv_ = torch.empty((b, lk, h * dv), device=dev, dtype=dt)
    err = getattr(_lib(), _ENTRY[dt])(
        plan, q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
        dout.data_ptr(), lse.data_ptr(), out.data_ptr(), dq.data_ptr(),
        dk.data_ptr(),
        dv_.data_ptr(), work.data_ptr(), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{_ENTRY[dt]} failed to launch: CUDA error {err}")
    tracing.count("launch.flash_attn_bwd_bf16" if dt == torch.bfloat16
                  else "launch.flash_attn_bwd")
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
