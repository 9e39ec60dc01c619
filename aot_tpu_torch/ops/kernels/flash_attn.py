"""Flash-attention forward: the CUDA kernels and their plain PyTorch version.

Port of aot_tpu/ops/pallas/flash_attn_vjp.py:338 flash_attention, forward
(`_flash_fwd_raw` :211, kernel body `_fwd_kernel` :51). The kernels are
csrc/flash_attn_fwd.cu for fp32 q, k, v (3xTF32: mma.sync, and wgmma for
the P V pass of dv > 128; its launch plan is `fwd_plan`) and
csrc/flash_attn_fwd_bf16.cu for bf16 ones (wgmma; its launch plan is
csrc/flash_attn_fwd_bf16_plan.h's, read through `bf16_launch_plan`); each
source's header says what bounds it on Hopper.
The global attention over a long LT memory reaches them through
ops/attention.py `use_flash`.

  flash_attention        entry point: a CPU tensor takes the plain version,
                         a CUDA tensor launches the kernel or raises — there
                         is no fallback
  flash_attention_cuda   the kernel wrapper (counter
                         launch.flash_attn_fwd[_bf16]: one per call, which runs
                         the kernel's passes and the merge of key splits;
                         flash.fwd.pv and flash.fwd.pv.keys: the fp32 calls
                         that take the two passes, and their live keys)
  flash_attention_plain  the same function in plain PyTorch: a masked
                         softmax over the live keys
  flash_attention_train  the differentiable form (the `FlashAttention`
                         autograd Function): this forward, and the backward
                         of ops/kernels/flash_attn_bwd.py
  bf16_launch_plan       the bf16 kernel's plan and workspace, as its header
                         fills them (the CPU tests build that header alone:
                         tests/test_torch_port_bf16_fwd.py)

All three return (out, lse): out (B, Lq, h*dv) in v's dtype; lse (B*h,
Lq), fp32, the log-sum-exp of the scaled scores over the live keys. A row
with no live key gives out 0 and lse -1e30, as the TPU kernel does
(:89-96). q, k and v are fp32, or bf16 for bf16 serving and training: fp32
scores, softmax statistics and accumulation, P rounded to bf16 before P V
(`_fwd_kernel` at bf16, :41-93). `flash_attention_train` takes both, its
backward the matching instantiation of ops/kernels/flash_attn_bwd.py.
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
from aot_tpu_torch.utils import tracing

NEG_INF = -1e30
MAX_D = 256       # q/k channels per head (csrc/flash_attn_fwd.cu kMaxD)
_TILE_Q = 64      # queries a block (csrc/flash_attn_fwd.cu kBQ)
_PV_COLS = 256    # value columns a P V block (csrc/flash_attn_fwd.cu kPvCols)
# Floats of scores (forward) or of P and of dS each (backward) that the
# two-pass forms keep at once, 256 MB: they run over slabs of query rows
# that fit it. A memory bound, not a route: every width above one value
# tile takes the two passes. A 465x465 DeAOTL read (B*h = 1, Lq = 900,
# Lk <= 19,800) fits one slab; a 1080p read (Lq = 7,232, Lk = 14,464)
# takes two in the forward, of 4,224 and 3,008 rows (fwd_plan fits its
# slabs to whole waves; chip_smoke.py phase 3).
SLAB_FLOATS = 1 << 26

ValidLen = Union[None, int, torch.Tensor]


def _dims(q, v, num_heads: int, d_att: Optional[int]) -> Tuple[int, int]:
    d = d_att if d_att is not None else q.shape[-1] // num_heads
    return d, v.shape[-1] // num_heads


# Elements a 16-byte copy moves: the kernels' widths and strides are
# multiples of it, for each q/k/v type they take
_VEC = {torch.float32: 4, torch.bfloat16: 8}
_ENTRY = {torch.float32: "flash_attn_fwd"}     # the fp32 kernel's C entry


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
    """The fp32 kernel's C entry (`dtype` float32)."""
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
    of query rows (_two_pass_slab): the scores once, their key loop split
    to fill two blocks a multiprocessor (score_splits), and then P V over
    256-column value tiles, one block a multiprocessor, its key loop split
    to fill one wave (splits); scratch for a slab's scores, the row
    statistics and the output's splits (each a slab's rows)."""
    h = num_heads
    if dv > 128:
        tiles, splits = _two_pass_slab(b * h, lq, lk, dv, sms)
        slab = tiles * _TILE_Q
        score_splits = _splits(b * h * tiles, 2 * sms, -(-lk // 64))
        return splits, score_splits, slab, _two_pass_scratch(
            b * h, lq, lk, dv, slab, splits, score_splits)
    splits = _splits(b * h * -(-lq // _TILE_Q), 2 * sms, -(-lk // 64))
    return splits, 0, 0, (splits * (b * lq * h * dv + b * h * lq)
                          if splits > 1 else 0)


# The cost of a slab beyond its P V tiles (three more launches, a pipeline
# to fill and drain), in the time of one 32-key P V tile of a block
_SLAB_COST = 20


def _two_pass_scratch(bh: int, lq: int, lk: int, dv: int, slab: int,
                      splits: int, score_splits: int) -> int:
    """Floats of the two passes' scratch: a slab's scores, the score
    splits' row max and sum, and the P V splits' partials of a slab."""
    return (bh * slab * (-(-lk // 32) * 32) + 2 * score_splits * bh * lq
            + (splits * bh * min(slab, lq) * dv if splits > 1 else 0))


@functools.lru_cache(maxsize=256)
def _two_pass_slab(bh: int, lq: int, lk: int, dv: int,
                   sms: int) -> Tuple[int, int]:
    """(query tiles a slab, P V key splits) of the two passes: of the slabs
    of up to slab_rows' rows, the one whose P V grids (query tiles x value
    tiles x splits, one block a multiprocessor) fill their waves best, by
    the P V tiles a block runs in every slab and wave plus _SLAB_COST a
    slab, and whose scratch is no more than the largest slab's; the larger
    slab where two tie. A DeAOTL read at 480p (Lq = 1,674 over 107,136
    keys) takes slabs of 3 tiles and 11 splits, 132 blocks, not 9 tiles
    and 3 splits, 108. Made once a shape."""
    key_tiles = -(-lk // 32)
    all_tiles = -(-lq // _TILE_Q)

    def plan(tiles: int) -> Tuple[int, int, int]:   # cost, splits, scratch
        pairs = bh * tiles * -(-dv // _PV_COLS)
        splits = _splits(pairs, sms, key_tiles)
        cost = -(-all_tiles // tiles) * (
            -(-pairs * splits // sms) * -(-key_tiles // splits) + _SLAB_COST)
        return cost, splits, _two_pass_scratch(
            bh, lq, lk, dv, tiles * _TILE_Q, splits,
            _splits(bh * tiles, 2 * sms, -(-lk // 64)))

    most = slab_rows(bh, lq, lk) // _TILE_Q
    cap = plan(most)[2]
    _, neg_tiles, splits = min(
        (cost, -tiles, splits)
        for tiles, (cost, splits, scratch) in (
            (t, plan(t)) for t in range(1, most + 1))
        if scratch <= cap)
    return -neg_tiles, splits


# The bf16 kernel's plan: its inputs, in the order of
# csrc/flash_attn_fwd_bf16_plan.h's PlanField; the header fills the rest
# (BF16_PLAN_OUTPUTS) and sizes the workspace, and alone owns the rule
BF16_PLAN_FIELDS = ("B", "H", "LQ", "LK", "D", "DV")
BF16_PLAN_OUTPUTS = ("D_PAD", "VALUE_TILE", "VALUE_TILES", "Q_TILES",
                     "SPLITS", "TILES_PER_SPLIT", "STAGES", "SMEM", "BLOCKS",
                     "PART_OUT", "PART_LSE", "WORKSPACE", "BOX_COLS")


def _bf16_lib() -> ctypes.CDLL:
    """csrc/flash_attn_fwd_bf16.cu's library, its entries bound."""
    lib = _build.load("flash_attn_fwd_bf16")
    if lib.fwd_bf16_plan.argtypes is None:
        lib.fwd_bf16_plan.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fwd_bf16_plan.restype = ctypes.c_longlong
        lib.flash_attn_fwd_bf16.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attn_fwd_bf16.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def bf16_launch_plan(inputs: Tuple[int, ...],
                     sms: int) -> Tuple[ctypes.Array, int]:
    """(the bf16 kernel's `plan`, the workspace bytes) for `inputs`
    (BF16_PLAN_FIELDS' values) on a card of `sms` multiprocessors, as
    csrc/flash_attn_fwd_bf16_plan.h fills them; made once a shape."""
    lib = _bf16_lib()
    plan = (ctypes.c_longlong * lib.fwd_bf16_plan_len())(*inputs)
    work = lib.fwd_bf16_plan(plan, sms)
    if work < 0:
        raise ValueError(f"fwd_bf16_plan takes no plan for {inputs}")
    return plan, work


def bf16_plan_value(plan: ctypes.Array, name: str) -> int:
    """One field the header filled (BF16_PLAN_OUTPUTS), e.g. "SPLITS"."""
    return plan[len(BF16_PLAN_FIELDS) + BF16_PLAN_OUTPUTS.index(name)]


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
    """Launch the CUDA kernel of q's dtype (fp32 or bf16 q, k, v). q, k, v
    may be strided views (the LT ring's live prefix) as long as each
    token's channels are contiguous. Raises on any input it does not take,
    and if the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: q is on {q.device}")
    dt = q.dtype
    if dt not in _VEC:
        raise ValueError(f"flash_attention_cuda: q is {dt}; the kernels take "
                         f"{sorted(str(t) for t in _VEC)}")
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

    if dt == torch.bfloat16:
        out, lse = _launch_bf16(q, k, v, valid_ptr, valid_all, b, lq, lk, h, d,
                                dv)
        tracing.count("launch.flash_attn_fwd_bf16")
        return out, lse
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
            f"flash_attn_fwd failed to launch: CUDA error {err}")
    tracing.count("launch.flash_attn_fwd")
    count_pv_pass(dv, valid_all)
    return out, lse


def count_pv_pass(dv: int, keys: int) -> None:
    """Count an fp32 kernel call that takes the two passes (dv > 128: the
    scores, then P V on wgmma) as `flash.fwd.pv`, and `keys` under
    `flash.fwd.pv.keys` (the live length where it is a host int, else every
    key handed over, as ops/attention.py counts `attn.global.flash.keys`)."""
    if dv > 128:
        tracing.count("flash.fwd.pv")
        tracing.count("flash.fwd.pv.keys", keys)


def _launch_bf16(q, k, v, valid_ptr, valid_all: int, b: int, lq: int,
                 lk: int, h: int, d: int, dv: int):
    """The bf16 kernel's launch, the inputs checked. Raises if it fails."""
    dev = q.device
    plan, work_bytes = bf16_launch_plan((b, h, lq, lk, d, dv), sm_count(dev))
    work = (torch.empty(work_bytes, device=dev, dtype=torch.uint8)
            if work_bytes else None)
    out = torch.empty((b, lq, h * dv), device=dev, dtype=q.dtype)
    lse = torch.empty((b * h, lq), device=dev, dtype=torch.float32)
    err = _bf16_lib().flash_attn_fwd_bf16(
        plan, q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr,
        out.data_ptr(), lse.data_ptr(),
        None if work is None else work.data_ptr(), valid_all, q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn_fwd_bf16 failed to launch: CUDA error {err}")
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
