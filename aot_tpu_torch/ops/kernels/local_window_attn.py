"""Local-window attention: the CUDA kernels and their plain PyTorch version.

Two kernels compute the same function:
  - csrc/local_window_attn.cu, the port of aot_tpu/ops/pallas/
    local_window_attn.py:475 local_window_attention_flat (kernel body
    `_kernel_flat`, :414): one warp per (query, head), for the eval grids
    up to 2,500 query tokens;
  - csrc/local_window_attn_wide.cu, the port of local_window_attn.py:294
    local_window_attention_wide (kernel body `_kernel_wide`, :236): 4 x 32
    query tiles with the key/value halo staged in shared memory, for the
    full-resolution grids above 2,500 tokens.
Each header says what bounds it on Hopper. ops/attention.py picks one
(`local_route`).

  local_window_attention             entry point: a CPU tensor takes the
                                     plain version, a CUDA tensor launches
                                     the flat kernel or raises — there is no
                                     fallback
  local_window_attention_cuda        the flat kernel's wrapper (LAUNCHES)
  local_window_attention_wide_cuda   the wide kernel's wrapper
                                     (WIDE_LAUNCHES)
  local_window_attention_plain       the same function in plain PyTorch:
                                     the win² shifted slices of the
                                     zero-padded image (F.unfold), no
                                     (HW x HW) tensor

Layouts: q, k (B, HW, h*d); v (B, HW, h*dv); rel_bias (B, h, HW, win²);
rel_v (h, dv, win²) or None; out (B, HW, h*dv).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from aot_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
MAX_DIS = 7       # window of at most 15 x 15 slots
MAX_D = 512       # q/k channels per head, held in shared memory (kMaxD)
MAX_DV = 1024     # value channels per head: the kernel loops over them, and
                  # 1024 (DeAOT's 2 x 512 value stream at h=1) is the widest
                  # the card has checked

# Kernel launches since the count was last reset, one count per kernel;
# each wrapper adds one per launch and nothing else touches them, so a run
# can show it went through the kernel.
LAUNCHES = 0         # csrc/local_window_attn.cu
WIDE_LAUNCHES = 0    # csrc/local_window_attn_wide.cu


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

    qt = (q / math.sqrt(d)).reshape(b, hw, h, d).permute(0, 2, 3, 1)
    scores = torch.einsum("ncq,ncwq->nqw", qt.reshape(b * h, d, hw),
                          windows(k, d))
    scores = scores + rel_bias.reshape(b * h, hw, win2)
    valid = _window_valid(hgt, wid, max_dis, dilation, q.device)
    scores = scores.masked_fill(~valid, NEG_INF)
    attn = torch.softmax(scores.float(), dim=-1)   # masked slots exactly 0
    out = torch.einsum("nqw,ncwq->nqc", attn.to(v.dtype), windows(v, dv))
    out = out.reshape(b, h, hw, dv)
    if rel_v is not None:
        out = out + torch.einsum("bhqw,hcw->bhqc",
                                 attn.reshape(b, h, hw, win2), rel_v.float())
    return out.permute(0, 2, 1, 3).reshape(b, hw, h * dv).to(v.dtype)


def shape_error(d: int, dv: int, max_dis: int) -> Optional[str]:
    """Why the flat kernel does not take per-head widths (d, dv) and window
    radius max_dis, or None."""
    if not 0 <= max_dis <= MAX_DIS:
        return f"max_dis={max_dis} (at most {MAX_DIS})"
    if not 0 < d <= MAX_D:
        return f"d={d} (at most {MAX_D})"
    if not 0 < dv <= MAX_DV:
        return f"dv={dv} (at most {MAX_DV})"
    return None


def wide_shape_error(d: int, dv: int, max_dis: int) -> Optional[str]:
    """Why the wide kernel does not take (d, dv, max_dis), or None. It walks
    d and dv in 32-channel chunks, so only the window is bounded (its score
    block must fit shared memory)."""
    if not 0 <= max_dis <= MAX_DIS:
        return f"max_dis={max_dis} (at most {MAX_DIS})"
    if d < 1 or dv < 1:
        return f"d={d}, dv={dv} (at least 1)"
    return None


def _load(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return _load("local_window_attn", "local_window_attn_fwd",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])


def _wide_lib() -> ctypes.CDLL:
    return _load("local_window_attn_wide", "local_window_attn_wide_fwd",
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check(fn: str, name: str, t: torch.Tensor, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"{fn}: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _checked_dims(fn: str, why_not, q, k, v, rel_bias, rel_v, num_heads,
                  size_2d, max_dis, d_att):
    """The checks both kernel wrappers make before a launch. Returns
    (B, h, H, W, d, dv); raises on anything the kernel does not take."""
    tensors = (q, k, v, rel_bias, rel_v)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn} is forward-only: an input requires grad, and its gradient "
            "would be lost; training takes local_window_attention_plain "
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
    why = why_not(d, dv, max_dis)
    if why is not None or v.shape[-1] != h * dv:
        raise ValueError(f"{fn}: unsupported {why or ''} (heads={h}, v width "
                         f"{v.shape[-1]})")
    dev = q.device
    _check(fn, "q", q, (b, hw, h * d), dev)
    _check(fn, "k", k, (b, hw, h * d), dev)
    _check(fn, "v", v, (b, hw, h * dv), dev)
    _check(fn, "rel_bias", rel_bias, (b, h, hw, win2), dev)
    if rel_v is not None:
        _check(fn, "rel_v", rel_v, (h, dv, win2), dev)
    return b, h, hgt, wid, d, dv


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
    """Launch the flat CUDA kernel (dilation 1, fp32). Raises on any input
    it does not take, and if the launch fails."""
    global LAUNCHES
    b, h, hgt, wid, d, dv = _checked_dims(
        "local_window_attention_cuda", shape_error, q, k, v, rel_bias, rel_v,
        num_heads, size_2d, max_dis, d_att)
    dev = q.device
    out = torch.empty((b, hgt * wid, h * dv), device=dev, dtype=torch.float32)
    err = _lib().local_window_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
        None if rel_v is None else rel_v.data_ptr(), out.data_ptr(),
        b, h, hgt, wid, d, dv, max_dis, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"local_window_attn_fwd failed to launch: CUDA error {err}")
    LAUNCHES += 1
    return out


def local_window_attention_wide_cuda(
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
    """Launch the wide (query-tiled) CUDA kernel (dilation 1, fp32). Raises
    on any input it does not take, and if the launch fails."""
    global WIDE_LAUNCHES
    b, h, hgt, wid, d, dv = _checked_dims(
        "local_window_attention_wide_cuda", wide_shape_error, q, k, v,
        rel_bias, rel_v, num_heads, size_2d, max_dis, d_att)
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((b, hgt * wid, h * dv), device=dev, dtype=torch.float32)
    err = _wide_lib().local_window_attn_wide_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
        None if rel_v is None else rel_v.data_ptr(), out.data_ptr(),
        b, h, hgt, wid, d, dv, max_dis, 1.0 / math.sqrt(d), sms,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"local_window_attn_wide_fwd failed to launch: CUDA error {err}")
    WIDE_LAUNCHES += 1
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
    version; any other device goes to the flat CUDA kernel, which raises on
    what it cannot take."""
    kw = dict(num_heads=num_heads, size_2d=tuple(size_2d), max_dis=max_dis,
              d_att=d_att)
    if q.device.type == "cpu":
        return local_window_attention_plain(q, k, v, rel_bias, rel_v, **kw)
    return local_window_attention_cuda(q, k, v, rel_bias, rel_v, **kw)
