"""Swin's (shifted-)window attention: the CUDA kernel and its plain PyTorch
version.

csrc/swin_window_attn.cu computes one Swin block's window attention from
the qkv Linear's output over the image's own tokens to the output
projection's input, at fp32, with the pad, the roll and the window
partition of the published block (and their reverses) as index arithmetic.
It replaces no TPU kernel: the JAX package leaves Swin-B's window
attention to XLA (aot_tpu/models/encoders/swin.py). ops/attention.py routes
a block to it (`window_route`; `window_attention` launches it);
models/encoders/swin.py keeps its own pad/roll/partition path for
everything else.

  swin_window_attention_cuda     the kernel's wrapper (counter
                                 launch.swin_window_attn)
  swin_window_attention_plain    the same function in plain PyTorch, by
                                 the kernel's own addressing (`cells`)
  cells                          each window cell's source token (or
                                 padding) and region, as the kernel works
                                 them out
  heads_per_block                the kernel's launch plan

Layouts: qkv (B, H*W, 3C), token order, column which * C + head * d + c
(which = q, k, v); qkv_bias (3C); table ((2 window - 1)^2, heads); out
(B, H*W, C). fp32 throughout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from aot_tpu_torch.ops.kernels import _build
from aot_tpu_torch.ops.kernels.flash_attn import sm_count
from aot_tpu_torch.utils import tracing

WINDOW = 7        # the kernel's window (Swin-B's)
HEAD_DIM = 32     # the kernel's channels a head (Swin-B's at every stage)
MASK = -100.0     # the published shift mask between regions


class Cells(NamedTuple):
    """A window grid's cells (nW, window^2), windows in row-major order on
    the rolled, padded map: the source token (y * W + x) of each, -1 for
    padding, and its region id (0 everywhere in an unshifted grid)."""
    src: torch.Tensor
    region: torch.Tensor


@functools.lru_cache(maxsize=64)
def cells(hgt: int, wid: int, window: int, shift: int) -> Cells:
    """Cell (i, j) of window (wy, wx) holds token ((window wy + i + shift)
    mod Hp, (window wx + j + shift) mod Wp), padding where that lies outside
    the image; its region is, on each axis of the rolled padded map, 0
    below Hp - window, 1 below Hp - shift, else 2 (the kernel's
    arithmetic, csrc/swin_window_attn.cu)."""
    hp = -(-hgt // window) * window
    wp = -(-wid // window) * window
    r = np.arange(hp)                    # places on the rolled padded map
    c = np.arange(wp)
    y = (r + shift) % hp                 # their tokens on the unrolled map
    x = (c + shift) % wp

    def region(p, size):                 # slice(0, -w), (-w, -s), (-s, None)
        return np.where(p < size - window, 0, np.where(p < size - shift, 1, 2))

    src = np.where((y[:, None] < hgt) & (x[None, :] < wid),
                   y[:, None] * wid + x[None, :], -1)
    reg = (3 * region(r, hp)[:, None] + region(c, wp)[None, :]
           if shift > 0 else np.zeros((hp, wp), np.int64))

    def windows(a):                      # (hp, wp) -> (nW, window^2)
        a = a.reshape(hp // window, window, wp // window, window)
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 2, 1, 3).reshape(-1, window * window)))

    return Cells(windows(src), windows(reg))


@functools.lru_cache(maxsize=64)
def _cells_on(hgt: int, wid: int, window: int, shift: int,
              device: torch.device) -> Cells:
    """`cells` on `device`, made once (outside inference mode, so that a
    gradient may later flow through a gather by them)."""
    grid = cells(hgt, wid, window, shift)
    with torch.inference_mode(False):
        return Cells(grid.src.to(device), grid.region.to(device))


def swin_window_attention_plain(
    qkv: torch.Tensor,
    qkv_bias: torch.Tensor,
    table: torch.Tensor,
    *,
    num_heads: int,
    size_2d: Tuple[int, int],
    window: int = WINDOW,
    shift: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32: the windows gathered by
    `cells` (padding cells take the qkv bias), scores of q scaled by
    d^-0.5 plus the table's bias and the -100 mask between regions,
    softmax, P V, and the outputs scattered back to the in-image tokens."""
    # the encoder's own relative position index (a module-level import
    # would be circular: swin.py imports ops.attention, which imports this)
    from aot_tpu_torch.models.encoders.swin import _relative_index_on

    hgt, wid = size_2d
    b, l, c3 = qkv.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    grid = _cells_on(hgt, wid, window, shift, qkv.device)
    src = grid.src
    nw, n = src.shape
    live = src >= 0
    rows = torch.cat([qkv.float(), qkv_bias.float().expand(b, 1, c3)], 1)
    gathered = rows[:, torch.where(live, src, l)]          # (B, nW, n, 3C)
    qkvw = gathered.view(b, nw, n, 3, h, d).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkvw[0] * d ** -0.5, qkvw[1], qkvw[2]         # (B, nW, h, n, d)
    scores = q @ k.transpose(-1, -2)
    bias = table.float()[_relative_index_on(window, qkv.device)]
    scores = scores + bias.view(n, n, h).permute(2, 0, 1)   # (h, n, n)
    if shift > 0:
        reg = grid.region
        mask = torch.where(reg[:, :, None] != reg[:, None, :], MASK, 0.0)
        scores = scores + mask[None, :, None]
    out = (scores.softmax(-1) @ v).permute(0, 1, 3, 2, 4).reshape(b, nw * n, c)
    flat = src.reshape(-1)
    result = qkv.new_empty((b, l, c), dtype=torch.float32)
    result[:, flat[flat >= 0]] = out[:, flat >= 0]
    return result


def shape_error(num_heads: int, channels: int, window: int,
                shift: int) -> Optional[str]:
    """Why the kernel does not take a block of `channels` over `num_heads`
    heads at this window and shift, or None."""
    if window != WINDOW:
        return f"window {window} (the kernel's is {WINDOW})"
    if not 0 <= shift < window:
        return f"shift {shift} (0 <= shift < {window})"
    if num_heads < 1 or channels != num_heads * HEAD_DIM:
        return (f"{channels} channels over {num_heads} heads (the kernel "
                f"takes {HEAD_DIM} a head)")
    return None


def heads_per_block(b: int, heads: int, windows: int, sms: int) -> int:
    """Heads a block of the kernel takes: the most of 4, 2 and 1 dividing
    `heads` whose grid still gives every multiprocessor two blocks (so a
    late stage's few windows spread over the card), else 1. Swin-B at DAVIS
    480p: 4, 4 and 2 at its three stages."""
    fit = [g for g in (4, 2, 1) if heads % g == 0]
    return next((g for g in fit if b * windows * (heads // g) >= 2 * sms), 1)


def _lib():
    fn = _build.load("swin_window_attn").swin_window_attn
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16 != 0):
        raise ValueError(
            f"swin_window_attention_cuda: {name} must be a contiguous, "
            f"16-byte aligned float32 tensor of shape {tuple(shape)} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def swin_window_attention_cuda(
    qkv: torch.Tensor,
    qkv_bias: torch.Tensor,
    table: torch.Tensor,
    *,
    num_heads: int,
    size_2d: Tuple[int, int],
    window: int = WINDOW,
    shift: int = 0,
) -> torch.Tensor:
    """Launch csrc/swin_window_attn.cu. Raises on any input it does not
    take (a tensor that requires grad among them: the kernel is
    forward-only), and if the launch fails."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, qkv_bias, table)):
        raise RuntimeError(
            "swin_window_attention_cuda is forward-only: an input requires "
            "grad, and its gradient would be lost; training takes the plain "
            "path (ops.attention.window_route)")
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"swin_window_attention_cuda: qkv is on {dev}")
    hgt, wid = size_2d
    b, l, c3 = qkv.shape
    why = shape_error(num_heads, c3 // 3, window, shift)
    if why is not None or l != hgt * wid or c3 % 3:
        raise ValueError(f"swin_window_attention_cuda: unsupported "
                         f"{why or f'qkv {tuple(qkv.shape)} at {size_2d}'}")
    _check("qkv", qkv, (b, l, c3), dev)
    _check("qkv_bias", qkv_bias, (c3,), dev)
    _check("table", table, ((2 * window - 1) ** 2, num_heads), dev)
    windows = -(-hgt // window) * -(-wid // window)
    out = torch.empty((b, l, c3 // 3), device=dev, dtype=torch.float32)
    err = _lib()(qkv.data_ptr(), qkv_bias.data_ptr(), table.data_ptr(),
                 out.data_ptr(), b, hgt, wid, num_heads, window, shift,
                 heads_per_block(b, num_heads, windows, sm_count(dev)),
                 HEAD_DIM ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"swin_window_attn failed to launch: CUDA error {err}")
    tracing.count("launch.swin_window_attn")
    return out
