"""Local-window attention: the CUDA kernels and their plain PyTorch version.

One route ports both TPU kernels of aot_tpu/ops/pallas/local_window_attn.py
that serve dilation 1, local_window_attention_flat (:475, kernel body
`_kernel_flat` :414; the JAX package's grids up to 2,500 query tokens) and
local_window_attention_wide (:294, `_kernel_wide` :236; its grids above):
the kernel of q's dtype serves every grid size. csrc/local_window_attn_tc.cu
takes fp32 q, k, v (3xTF32, the launch plan of `launch_plan`) and
csrc/local_window_attn_bf16.cu bf16 ones (bf16 products; its launch plan is
csrc/local_window_attn_bf16_plan.h's, read through `bf16_launch_plan`).
Each source's header says what bounds it on Hopper.

  local_window_attention             entry point: a CPU tensor takes the
                                     plain version, a CUDA tensor launches
                                     the kernel or raises — there is no
                                     fallback
  local_window_attention_cuda        the card's wrapper (counter
                                     launch.local_window_attn[_bf16])
  local_window_attention_plain       the same function in plain PyTorch:
                                     the win² shifted slices of the
                                     zero-padded image (F.unfold), no
                                     (HW x HW) tensor
  launch_plan                        the fp32 kernel's passes, tile rows and
                                     grid, from the shapes and the card's
                                     multiprocessor count
  bf16_launch_plan                   the bf16 kernel's plan, as its header
                                     fills it (the CPU tests build that
                                     header alone:
                                     tests/test_torch_port_bf16_fwd.py)

Layouts: q, k (B, HW, h*d); v (B, HW, h*dv); rel_bias (B, h, HW, win²);
rel_v (h, dv, win²) or None; out (B, HW, h*dv).
Types: q, k, v and out fp32, or bf16 (bf16 serving); rel_bias and rel_v
fp32. All three compute in fp32 (bf16 inputs widened exactly; the bf16
kernel's products are exact in fp32 and it keeps P to ~2^-16 as a bf16
pair) and write out in q's dtype, as the TPU kernels do
(local_window_attn.py:420-469).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from aot_tpu_torch.ops.kernels import _build
from aot_tpu_torch.ops.kernels.flash_attn import sm_count
from aot_tpu_torch.utils import tracing

NEG_INF = -1e30
MAX_DIS = 7       # window of at most 15 x 15 slots: 16 + 2*7 halo keys fit
                  # the kernel's 32-key band
MAX_D = 512       # q/k channels per head: a 1-row score tile's q rows and
                  # k ring must fit shared memory

# csrc/local_window_attn_tc.cu's geometry (the fp32 kernel)
TILE_X = 16           # queries a tile row (the mma tile's rows)
HALO = 32             # halo keys a row
ONE_PASS_MAX = 128    # d or dv above: two passes (scores once, then P V)
VALUE_TILE = 128      # value columns a block of the two-pass P V
TILE_CHANNELS = 512   # q/k channels x rows of a score tile at most: its q rows
                      # and k ring then fit a block's shared memory


def _window_valid(hgt: int, wid: int, max_dis: int, dilation: int,
                  device) -> torch.Tensor:
    """(HW, win²) bool: the window slot lands inside the image."""
    r = torch.arange(-max_dis, max_dis + 1, device=device) * dilation
    ky = torch.arange(hgt, device=device)[:, None, None, None] + r[:, None]
    kx = torch.arange(wid, device=device)[None, :, None, None] + r
    ok = (ky >= 0) & (ky < hgt) & (kx >= 0) & (kx < wid)  # (H, W, win, win)
    return ok.reshape(hgt * wid, -1)


def local_window_attention_plain(
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
    hgt, wid = size_2d
    hw = hgt * wid
    b = q.shape[0]
    h = num_heads
    d = d_att if d_att is not None else q.shape[-1] // h
    dv = v.shape[-1] // h
    win2 = (2 * max_dis + 1) ** 2

    def windows(x, dd):
        # (B, HW, h*dd) -> (B*h, dd, win², HW): x at every window slot,
        # zeros off the image
        img = x.reshape(b, hgt, wid, h, dd).permute(0, 3, 4, 1, 2)
        cols = F.unfold(img.reshape(b * h, dd, hgt, wid), 2 * max_dis + 1,
                        dilation=dilation, padding=max_dis * dilation)
        return cols.view(b * h, dd, win2, hw)

    qt = (q.float() / math.sqrt(d)).reshape(b, hw, h, d).permute(0, 2, 3, 1)
    scores = torch.einsum("ncq,ncwq->nqw", qt.reshape(b * h, d, hw),
                          windows(k.float(), d))
    scores = scores + rel_bias.reshape(b * h, hw, win2)
    valid = _window_valid(hgt, wid, max_dis, dilation, q.device)
    scores = scores.masked_fill(~valid, NEG_INF)
    attn = torch.softmax(scores.float(), dim=-1)   # masked slots exactly 0
    out = torch.einsum("nqw,ncwq->nqc", attn, windows(v.float(), dv))
    out = out.reshape(b, h, hw, dv)
    if rel_v is not None:
        out = out + torch.einsum("bhqw,hcw->bhqc",
                                 attn.reshape(b, h, hw, win2), rel_v.float())
    return out.permute(0, 2, 1, 3).reshape(b, hw, h * dv).to(v.dtype)


def shape_error(d: int, dv: int, max_dis: int) -> Optional[str]:
    """Why the kernel does not take per-head widths (d, dv) and window
    radius max_dis, or None. It copies 16 bytes at a time, so both widths
    are multiples of 4."""
    if not 0 <= max_dis <= MAX_DIS:
        return f"max_dis={max_dis} (at most {MAX_DIS})"
    if not (0 < d <= MAX_D and d % 4 == 0):
        return f"d={d} (a multiple of 4, at most {MAX_D})"
    if not (dv > 0 and dv % 4 == 0):
        return f"dv={dv} (a positive multiple of 4)"
    return None


class LaunchPlan(NamedTuple):
    """A launch of csrc/local_window_attn_tc.cu. Tuples hold one entry a
    pass: (the one pass) or (the scores, the values)."""
    rows: Tuple[int, ...]     # query rows a tile: what the kernel takes
    blocks: Tuple[int, ...]   # grid size
    scratch_floats: int       # P of the two-pass form, else 0

    @property
    def passes(self) -> int:
        return len(self.rows)

    def args(self) -> Tuple[int, int]:
        """The kernel's plan argument: the rows a tile of the first pass,
        then of the value pass (0 for one pass)."""
        return (self.rows[0], self.rows[1] if self.passes == 2 else 0)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, h: int, hgt: int, wid: int, d: int, dv: int,
                max_dis: int, sms: int) -> LaunchPlan:
    """Passes, tile rows and grid of a launch on a card of `sms`
    multiprocessors. Up to d = dv = 128 one pass: a block per (tile, b,
    head) takes all of dv. Above, two passes: the scores and softmax once, P
    written to a (B*h, HW, win2) scratch, then P V over 128-column value
    tiles. Each pass takes the tallest tile (4, 2 or 1 query rows of 16
    pixels) whose grid still gives every multiprocessor a block (a taller
    tile stages fewer halo rows a query row), or 1-row tiles where none
    does. 4-row tiles only where a block's values are 32 columns wide (the
    one pass at dv <= 32, or the scores), and a score tile holds at most
    TILE_CHANNELS q/k channels x rows; the kernel derives the rest (warps,
    ring stages, shared memory) from the rows."""
    two = d > ONE_PASS_MAX or dv > ONE_PASS_MAX
    tiles_x = -(-wid // TILE_X)
    if two:
        passes = (("scores", (4, 2, 1)), ("values", (2, 1)))
    else:
        passes = (("one", (4, 2, 1) if dv <= 32 else (2, 1)),)
    rows, blocks = [], []
    for mode, heights in passes:
        z = -(-dv // VALUE_TILE) if mode == "values" else 1
        fit = [r for r in heights if mode == "values" or r * d <= TILE_CHANNELS]
        grid = lambda r: tiles_x * -(-hgt // r) * b * h * z
        r = next((r for r in fit if grid(r) >= sms), fit[-1])
        rows.append(r)
        blocks.append(grid(r))
    scratch = b * h * hgt * wid * (2 * max_dis + 1) ** 2 if two else 0
    return LaunchPlan(tuple(rows), tuple(blocks), scratch)


# the fp32 kernel's C entry point
_ENTRY = {torch.float32: "local_window_attn_tc_fwd"}
_DTYPES = (torch.float32, torch.bfloat16)


def _entry(dtype: torch.dtype):
    """The fp32 kernel's C entry (`dtype` float32)."""
    fn = getattr(_build.load("local_window_attn_tc"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# The bf16 kernel's plan: its inputs, in the order of
# csrc/local_window_attn_bf16_plan.h's PlanField; the header fills the rest
# (BF16_PLAN_OUTPUTS) and alone owns the rule
BF16_PLAN_FIELDS = ("B", "H", "HEIGHT", "WIDTH", "D", "DV", "MAX_DIS",
                    "REL_V")
BF16_PLAN_OUTPUTS = ("ROWS", "VALUE_TILE", "WARPS", "TILES_X", "TILES",
                     "VALUE_TILES", "BLOCKS", "D_PAD", "LD_S", "LD_Q",
                     "LD_V", "LD_RV", "Q_OFF", "REGION_OFF", "SMEM",
                     "COPY")


def _bf16_lib() -> ctypes.CDLL:
    """csrc/local_window_attn_bf16.cu's library, its entries bound."""
    lib = _build.load("local_window_attn_bf16")
    if lib.lwa_bf16_plan.argtypes is None:
        lib.lwa_bf16_plan.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lwa_bf16_plan.restype = ctypes.c_longlong
        lib.local_window_attn_bf16.argtypes = ([ctypes.c_void_p] * 7
                                               + [ctypes.c_float,
                                                  ctypes.c_void_p])
        lib.local_window_attn_bf16.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def bf16_launch_plan(inputs: Tuple[int, ...], sms: int) -> ctypes.Array:
    """The bf16 kernel's `plan` for `inputs` (BF16_PLAN_FIELDS' values) on
    a card of `sms` multiprocessors, as csrc/local_window_attn_bf16_plan.h
    fills it; made once a shape."""
    lib = _bf16_lib()
    plan = (ctypes.c_longlong * lib.lwa_bf16_plan_len())(*inputs)
    if lib.lwa_bf16_plan(plan, sms) < 0:
        raise ValueError(f"lwa_bf16_plan takes no plan for {inputs}")
    return plan


def bf16_plan_value(plan: ctypes.Array, name: str) -> int:
    """One field the header filled (BF16_PLAN_OUTPUTS), e.g. "ROWS"."""
    return plan[len(BF16_PLAN_FIELDS) + BF16_PLAN_OUTPUTS.index(name)]


def _check(fn: str, name: str, t: torch.Tensor, shape, device,
           dtype: torch.dtype) -> None:
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16 != 0):
        raise ValueError(
            f"{fn}: {name} must be a contiguous, 16-byte aligned {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def local_window_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    rel_v: Optional[torch.Tensor],
    *,
    num_heads: int,
    size_2d: Tuple[int, int],
    max_dis: int = 7,
    d_att: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel of q's dtype (dilation 1, fp32 or bf16) at
    any grid size, counted `launch.local_window_attn[_bf16]`. Raises on any
    input it does not take, and if the launch fails."""
    fn = "local_window_attention_cuda"
    tensors = (q, k, v, rel_bias, rel_v)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn} is forward-only: an input requires grad, and its gradient "
            "would be lost; training takes the window form "
            "(ops.attention.local_attention inside attn_training_context)")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: q is on {q.device}")
    hgt, wid = size_2d
    hw = hgt * wid
    b = q.shape[0]
    h = num_heads
    d = d_att if d_att is not None else q.shape[-1] // h
    dv = v.shape[-1] // h
    win2 = (2 * max_dis + 1) ** 2
    why = shape_error(d, dv, max_dis)
    if why is not None or v.shape[-1] != h * dv:
        raise ValueError(f"{fn}: unsupported {why or ''} (heads={h}, v width "
                         f"{v.shape[-1]})")
    dev = q.device
    dt = q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"{fn}: q is {dt}; the kernels take "
                         f"{sorted(str(t) for t in _DTYPES)}")
    _check(fn, "q", q, (b, hw, h * d), dev, dt)
    _check(fn, "k", k, (b, hw, h * d), dev, dt)
    _check(fn, "v", v, (b, hw, h * dv), dev, dt)
    _check(fn, "rel_bias", rel_bias, (b, h, hw, win2), dev, torch.float32)
    if rel_v is not None:
        _check(fn, "rel_v", rel_v, (h, dv, win2), dev, torch.float32)
    if dt == torch.bfloat16:
        plan = bf16_launch_plan(
            (b, h, hgt, wid, d, dv, max_dis, int(rel_v is not None)),
            sm_count(dev))
        out = torch.empty((b, hw, h * dv), device=dev, dtype=dt)
        err = _bf16_lib().local_window_attn_bf16(
            plan, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rel_bias.data_ptr(), None if rel_v is None else rel_v.data_ptr(),
            out.data_ptr(), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"local_window_attn_bf16 failed to launch: CUDA error {err}")
        tracing.count("launch.local_window_attn_bf16")
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(b, h, hgt, wid, d, dv, max_dis, sms)
    scratch = (torch.empty(plan.scratch_floats, device=dev,
                           dtype=torch.float32)
               if plan.scratch_floats else None)
    out = torch.empty((b, hw, h * dv), device=dev, dtype=dt)
    err = _entry(dt)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
        None if rel_v is None else rel_v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h, hgt, wid, d,
        dv, max_dis, (ctypes.c_int * 2)(*plan.args()), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{_ENTRY[dt]} failed to launch: CUDA error {err}")
    tracing.count("launch.local_window_attn")
    return out


def local_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    rel_v: Optional[torch.Tensor],
    *,
    num_heads: int,
    size_2d: Tuple[int, int],
    max_dis: int = 7,
    d_att: Optional[int] = None,
) -> torch.Tensor:
    """Dilation-1 local-window attention. A CPU tensor takes the plain
    version; any other device goes to `local_window_attention_cuda`, which
    launches the CUDA kernel or raises on what it cannot take."""
    kw = dict(num_heads=num_heads, size_2d=tuple(size_2d), max_dis=max_dis,
              d_att=d_att)
    if q.device.type == "cpu":
        return local_window_attention_plain(q, k, v, rel_bias, rel_v, **kw)
    return local_window_attention_cuda(q, k, v, rel_bias, rel_v, **kw)
