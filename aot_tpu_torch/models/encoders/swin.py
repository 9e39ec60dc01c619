"""Swin Transformer encoder, detection variant: the last stage removed, a
LayerNorm on each output (port of aot_tpu/models/encoders/swin.py;
reference: networks/encoders/swin/swin_transformer.py and build.py).
Swin-B: embed 128, depths (2, 2, 18), heads (4, 8, 16), window 7, drop
path 0.3 over the full 24-block schedule.

Emits [x4 (128ch), x8 (256ch), x16 (512ch), x16 (512ch, the same map)]
NCHW. Module names are the reference's (`patch_embed.proj`,
`layers.<i>.blocks.<j>.attn.qkv`, `layers.<i>.downsample.reduction`,
`norm<i>`). The relative position index and the shifted-window mask are
recomputed once a device, not stored (not even as buffers, which a model
built on 'meta' would leave uninitialised): the reference checkpoint's
copies of them are not loaded.

A block's attention takes the route of `ops.attention.window_route`: an
fp32 card tensor in serving runs the qkv Linear over the image's own
tokens, the window kernel (csrc/swin_window_attn.cu, the pad, roll and
partition as its index arithmetic) and the output projection, three
launches; everything else (the CPU, bf16, training) the pad, roll,
partition and reverse below. Each block's attention is one `window_attn`
span (utils/tracing.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.models.layers import Conv2d, DropPath, LayerNorm, Linear
from aot_tpu_torch.ops import attention
from aot_tpu_torch.utils.tracing import span


def relative_position_index(window: int) -> np.ndarray:
    """(win^2, win^2) indices into the (2 win - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).astype(np.int64)


def shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, win^2, win^2) additive mask of a shifted window grid
    on the padded (hp, wp) map: -100 between cells of different regions."""
    img = np.zeros((hp, wp), np.int32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, hs in enumerate(slices):
        for j, ws in enumerate(slices):
            img[hs, ws] = 3 * i + j
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return np.where(win[:, :, None] != win[:, None, :], -100.0,
                    0.0).astype(np.float32)


@lru_cache(maxsize=32)
def _relative_index_on(window: int, device: torch.device) -> torch.Tensor:
    """relative_position_index(window), flat, on `device`: made here and
    not kept as a buffer, so that a model built on 'meta' and moved with
    to_empty (the benchmark's loading) holds no uninitialised index. Made
    outside inference mode, so that a later training step may save it for
    its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            relative_position_index(window).reshape(-1)).to(device)


@lru_cache(maxsize=32)
def _shift_mask_on(hp: int, wp: int, window: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_attn_mask(hp, wp, window, shift)).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, win^2, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B * nW, win^2, C) -> (B, H, W, C)."""
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the learned relative
    position bias (and the shift mask); plain matmuls and softmax."""

    def __init__(self, dim: int, num_heads: int, window: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """x: (B_, win^2, C); mask: (nW, win^2, win^2) or None."""
        b_, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        # scores, bias, mask and softmax in fp32; P in v's dtype, P V
        # summed in fp32 (aot_tpu swin.py:90-101)
        attn = q.float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[
            _relative_index_on(self.window, x.device)]
        attn = attn + bias.view(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(b_ // nw, nw, h, n, n)
                    + mask[None, :, None]).view(b_, h, n, n)
        out = (attn.softmax(-1).to(v.dtype).float() @ v.float()).to(v.dtype)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        # exact (erf) GELU; torch computes a bf16 input in fp32 and rounds
        # once, as aot_tpu swin.py:214 does
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class SwinBlock(nn.Module):
    """(Shifted-)window attention and MLP, each pre-norm with a residual;
    the map is padded at the bottom and right to window multiples."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H*W, C)."""
        y = self.norm1(x)
        attn = self.attn
        needs_grad = torch.is_grad_enabled() and (
            y.requires_grad or any(p.requires_grad
                                   for p in attn.parameters()))
        with span("window_attn"):
            if attention.window_read(y, needs_grad, num_heads=attn.num_heads,
                                     size_2d=hw,
                                     window=self.window) == "kernel":
                y = attn.proj(attention.window_attention(
                    attn.qkv(y), attn.qkv.bias,
                    attn.relative_position_bias_table,
                    num_heads=attn.num_heads, size_2d=hw, window=self.window,
                    shift=self.shift))
            else:
                y = self._windowed(y, hw)
        x = x + self.drop_path(y, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)

    def _windowed(self, y: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """The plain path: y (B, H*W, C) after norm1, padded at the bottom
        and right to window multiples, rolled, partitioned, attended (the
        qkv product on the padded map), reversed, rolled back and cut."""
        hgt, wid = hw
        b, l, c = y.shape
        win, s = self.window, self.shift
        y = y.view(b, hgt, wid, c)
        pad_b, pad_r = (win - hgt % win) % win, (win - wid % win) % win
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = hgt + pad_b, wid + pad_r
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = _shift_mask_on(hp, wp, win, s, y.device)
        y = window_reverse(self.attn(window_partition(y, win), mask), win,
                           hp, wp)
        if s > 0:
            y = torch.roll(y, (s, s), (1, 2))
        return y[:, :hgt, :wid].reshape(b, l, c)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (the reference's order), LayerNorm, a
    linear reduction to 2C; an odd side is padded by one."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        hgt, wid = hw
        b, _, c = x.shape
        y = F.pad(x.view(b, hgt, wid, c), (0, 0, 0, wid % 2, 0, hgt % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                       y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(y.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    """One stage: its blocks, then (all but the last stage) the merge."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 drop_paths: Sequence[float], downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window,
                      0 if j % 2 == 0 else window // 2,
                      drop_path=drop_paths[j]) for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv (no input padding) and LayerNorm."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, 4, 4)
        self.norm = LayerNorm(embed_dim)


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18),
                 full_depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16), window: int = 7,
                 drop_path_rate: float = 0.3,
                 out_indices: Sequence[int] = (0, 1, 2)):
        """full_depths: the stochastic-depth schedule's blocks, the removed
        stage's included (reference: swin_transformer.py:600-603). The
        defaults are Swin-B's."""
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(full_depths)).tolist()
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depth, num_heads[i], window,
                       dpr[sum(full_depths[:i]):], i < len(depths) - 1)
            for i, depth in enumerate(depths))
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        x = self.patch_embed.proj(x)
        b, c, hgt, wid = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        hw = (hgt, wid)
        outs = []
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, hw, generator)
            if i in self.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.transpose(1, 2).reshape(b, -1, *hw))
            if layer.downsample is not None:
                x = layer.downsample(x, hw)
                hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
        outs.append(outs[-1])
        return outs
