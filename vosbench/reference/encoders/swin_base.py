"""Swin-B at output stride 16, as aot-benchmark builds it for SwinB_AOTL and
SwinB_DeAOTL (networks/encoders/swin/: the detection variant of the Swin
Transformer, Liu et al., ICCV 2021, arXiv:2103.14030;
swin_base_patch4_window7_224_22k's widths): a 4 x 4 patch embedding with
its LayerNorm, three stages of window blocks (embed 128, depths (2, 2,
18), heads (4, 8, 16): 32 channels a head) with PatchMerging between them,
and a LayerNorm on each stage's output. The fourth stage is not built; the
stride-16 map is returned twice, [x4, x8, x16, x16].

A block, as the published SwinTransformerBlock computes it:
  - norm1, then the map padded at the bottom and right with zeros to
    multiples of the 7 x 7 window (after norm1, so the qkv product of a
    padding cell is the qkv bias);
  - in every second block the map rolled by -3 on both axes, and the
    attention masked at -100 between cells of different regions of the
    rolled padded map (its rows and columns cut by slice(0, -7),
    slice(-7, -3), slice(-3, None)), the mask made once a stage;
  - the windows partitioned, qkv, q scaled by 32^-0.5, the scores plus
    the learned relative position bias (a (13 x 13, heads) table indexed
    by each pair's offset in the window), softmax, times v, the output
    projection; the windows reversed, rolled back, the padding cut off;
  - the residual, then norm2, a 4x MLP with exact GELU and the residual.
PatchMerging pads an odd side by one, concatenates the 2 x 2 neighbours in
the order (0, 0), (1, 0), (0, 1), (1, 1), then LayerNorm and a linear
reduction to twice the channels, with no bias.

The window attention goes through `ops.read(SWIN_WINDOW, ...)`, so that
vosbench/work.py counts it by its own work function. This file computes
its own relative position index, shift mask, padding and merge order from
that description and imports nothing of the program. Departures: none in
the arithmetic; drop path (0.3 over the 24 blocks' schedule in training)
is off at inference, and the patch embedding's padding of a side not
divisible by 4 is kept though the cells' frames never need it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..model import Params, Read, conv, layer_norm, linear

DEPTHS = (2, 2, 18)
HEADS = (4, 8, 16)
WINDOW = 7
PATCH = 4


def relative_position_index(window: int, device) -> torch.Tensor:
    """(window^2 * window^2,) rows of the bias table: for query cell i and
    key cell j, (y_i - y_j + window - 1) * (2 window - 1) + (x_i - x_j +
    window - 1)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window, device=device),
                                        torch.arange(window, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * nW, window^2, C), windows in row-major
    order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B * nW, window^2, C) -> (B, h, w, C)."""
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shift_mask(hp: int, wp: int, window: int, shift: int, device
               ) -> torch.Tensor:
    """(nW, window^2, window^2): -100 between cells of different regions
    of the rolled (hp, wp) map, else 0."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    region = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = region
            region += 1
    ids = window_partition(img, window).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


# --- the window read ---------------------------------------------------------

def window_read(q, k, v, bias, mask: Optional[torch.Tensor], hgt: int,
                wid: int) -> torch.Tensor:
    """softmax(q k^T + bias (+ mask)) v in each window. q (scaled), k, v:
    (B * nW, heads, window^2, d); bias (heads, window^2, window^2); mask
    (nW, window^2, window^2) or None; hgt, wid: the unpadded map (for the
    work count). Returns (B * nW, heads, window^2, d)."""
    attn = q @ k.transpose(-2, -1) + bias[None]
    if mask is not None:
        bnw, h, n, _ = attn.shape
        nw = mask.shape[0]
        attn = (attn.view(bnw // nw, nw, h, n, n)
                + mask[None, :, None]).view(bnw, h, n, n)
    return attn.softmax(-1) @ v


def window_work(q, k, v, bias, mask, hgt: int, wid: int):
    """(flops, bytes) of a window read from its arguments' shapes: per head
    and in-image query 4 * window^2 * d FLOPs (q.k and p.v over the
    window's keys); the in-image tokens' q, k, v and out once each, and
    the bias table once (fp32). Padding cells are not counted."""
    bnw, h, n, d = q
    window = math.isqrt(n)
    windows = math.ceil(hgt / window) * math.ceil(wid / window)
    queries = bnw // windows * hgt * wid
    flops = 4.0 * n * d * h * queries
    nbytes = 4.0 * 4 * queries * h * d + 4.0 * (2 * window - 1) ** 2 * h
    return flops, nbytes


SWIN_WINDOW = Read("swin_window", "enc_window", window_read, window_work)


# --- the encoder ---------------------------------------------------------------

def block(P: Params, pre: str, x, hgt: int, wid: int, heads: int,
          shift: int, mask, ops):
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(P, pre + ".norm1", x).view(b, hgt, wid, c)
    pad_r = (WINDOW - wid % WINDOW) % WINDOW
    pad_b = (WINDOW - hgt % WINDOW) % WINDOW
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = hgt + pad_b, wid + pad_r
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    xw = window_partition(x, WINDOW)
    bnw, n, _ = xw.shape
    d = c // heads
    qkv = linear(P, pre + ".attn.qkv", xw).reshape(bnw, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * d ** -0.5
    table = P[pre + ".attn.relative_position_bias_table"]
    bias = table[relative_position_index(WINDOW, x.device)].view(
        n, n, heads).permute(2, 0, 1)
    out = ops.read(SWIN_WINDOW, q, k, v, bias, mask if shift > 0 else None,
                   hgt, wid)
    out = linear(P, pre + ".attn.proj", out.transpose(1, 2).reshape(bnw, n, c))
    x = window_reverse(out.view(-1, WINDOW, WINDOW, c), WINDOW, hp, wp)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x[:, :hgt, :wid].reshape(b, hgt * wid, c)
    y = layer_norm(P, pre + ".norm2", x)
    y = linear(P, pre + ".mlp.fc2", F.gelu(linear(P, pre + ".mlp.fc1", y)))
    return x + y


def patch_merging(P: Params, pre: str, x, hgt: int, wid: int):
    b, _, c = x.shape
    x = x.view(b, hgt, wid, c)
    if hgt % 2 or wid % 2:
        x = F.pad(x, (0, 0, 0, wid % 2, 0, hgt % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], -1).view(b, -1, 4 * c)
    return linear(P, pre + ".reduction", layer_norm(P, pre + ".norm", x))


def swin(P: Params, x, ops, depths: Sequence[int] = DEPTHS,
         heads: Sequence[int] = HEADS, prefix: str = "encoder"
         ) -> List[torch.Tensor]:
    """The encoder over the normalised NCHW image; `depths` and `heads` a
    stage (Swin-B's by default), the widths from the weights."""
    hgt, wid = x.shape[-2:]
    if wid % PATCH or hgt % PATCH:
        x = F.pad(x, (0, (PATCH - wid % PATCH) % PATCH,
                      0, (PATCH - hgt % PATCH) % PATCH))
    x = conv(P, prefix + ".patch_embed.proj", x, stride=PATCH)
    hgt, wid = x.shape[-2:]
    x = layer_norm(P, prefix + ".patch_embed.norm", x.flatten(2).transpose(1, 2))
    outs = []
    for i, (depth, h) in enumerate(zip(depths, heads)):
        pre = f"{prefix}.layers.{i}"
        hp = math.ceil(hgt / WINDOW) * WINDOW
        wp = math.ceil(wid / WINDOW) * WINDOW
        mask = shift_mask(hp, wp, WINDOW, WINDOW // 2, x.device)
        for j in range(depth):
            x = block(P, f"{pre}.blocks.{j}", x, hgt, wid, h,
                      0 if j % 2 == 0 else WINDOW // 2, mask, ops)
        out = layer_norm(P, f"{prefix}.norm{i}", x)
        outs.append(out.view(-1, hgt, wid, out.shape[-1])
                    .permute(0, 3, 1, 2).contiguous())
        if i < len(depths) - 1:
            x = patch_merging(P, f"{pre}.downsample", x, hgt, wid)
            hgt, wid = (hgt + 1) // 2, (wid + 1) // 2
    return outs + [outs[-1]]


def encode(P: Params, x, ops) -> List[torch.Tensor]:
    return swin(P, x, ops)
