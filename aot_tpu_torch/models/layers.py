"""Basic layers shared across the model (port of aot_tpu/models/layers.py).

Stochastic depth and dropout draw from an explicit torch.Generator that the
caller passes down with the input (`generator`); without one (serving, or
a deterministic training forward) they are identities. Linear and LayerNorm
(eps 1e-5, fp32 statistics) are torch's own.
Submodule names follow the reference PyTorch state dict, so
`load_state_dict(strict=True)` takes the keys of
`aot_tpu.utils.torch_import.export_state_dict` as they are.

Token sequences are (B, HW, C); size_2d = (H, W) recovers the grid, and
convolutions run NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.ops import attention as att_ops


def seq_to_2d(x: torch.Tensor, size_2d: Tuple[int, int]) -> torch.Tensor:
    """(B, HW, C) -> (B, C, H, W)."""
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, size_2d[0], size_2d[1])


def seq_from_2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, HW, C)."""
    return x.flatten(2).transpose(1, 2)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth per sample of the leading batch axis
    (aot_tpu/models/layers.py:186): keep = floor(1 - rate + U[0, 1)),
    x / (1 - rate) * keep. Identity when rate is 0 or no generator."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                   device=generator.device).to(x.device)
    return x / keep_prob * torch.floor(keep_prob + u).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element dropout as flax's nn.Dropout: keep with probability 1 - rate,
    scale the kept by 1 / (1 - rate). Identity when rate is 0 or no
    generator."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    u = torch.rand(x.shape, generator=generator,
                   device=generator.device).to(x.device)
    return torch.where(u < keep_prob, x / keep_prob, 0.0)


class DropPath(nn.Module):
    """`drop_path` at a fixed rate; no parameters."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate, generator)


def group_norm_seq(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over the channels of a (B, HW, C) sequence."""
    return gn(x.transpose(1, 2)).transpose(1, 2)


class GNActDWConv2d(nn.Module):
    """GroupNorm(32) + exact GELU + 5x5 depthwise conv: the LSTT FFN
    activation (reference: basic.py:15-35)."""

    def __init__(self, features: int, gn_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(gn_groups, features)
        self.conv = nn.Conv2d(features, features, 5, padding=2,
                              groups=features, bias=False)

    def forward(self, x: torch.Tensor, size_2d) -> torch.Tensor:
        x = F.gelu(group_norm_seq(self.gn, x), approximate="none")
        return seq_from_2d(self.conv(seq_to_2d(x, size_2d)))


class DWConv2d(nn.Module):
    """5x5 depthwise conv on a (B, HW, C) sequence, no bias (reference:
    basic.py:38-57; its channel dropout is an identity at eval). DeAOT's
    gated propagations apply it on every step."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = nn.Conv2d(features, features, 5, padding=2,
                              groups=features, bias=False)

    def forward(self, x: torch.Tensor, size_2d) -> torch.Tensor:
        return seq_from_2d(self.conv(seq_to_2d(x, size_2d)))


class ConvGN(nn.Module):
    """Conv + GroupNorm(8) used by the FPN decoder (reference:
    basic.py:75-85). NCHW."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 gn_groups: int = 8):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size,
                              padding=kernel_size // 2)
        self.gn = nn.GroupNorm(gn_groups, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(self.conv(x))


class MultiheadAttention(nn.Module):
    """Global attention module (reference: attention.py:29-126).
    use_linear=False drops the Q/K/V projections (the LSTT block hoists
    them); the output projection is always present."""

    def __init__(self, d_model: int, num_heads: int = 8,
                 use_linear: bool = True, d_att: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.d_att = d_att
        self.use_linear = use_linear
        self.dropout = dropout
        if use_linear:
            self.linear_Q = nn.Linear(d_model, d_model)
            self.linear_K = nn.Linear(d_model, d_model)
            self.linear_V = nn.Linear(d_model, d_model)
        self.projection = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, *, valid_len=None, top_k: int = -1,
                max_mem_len_ratio: float = -1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.use_linear:
            q, k, v = self.linear_Q(q), self.linear_K(k), self.linear_V(v)
        out = att_ops.global_attention(
            q, k, v, self.num_heads, self.d_att, valid_len=valid_len,
            top_k=top_k, max_mem_len_ratio=max_mem_len_ratio)
        return self.projection(dropout(out, self.dropout, generator))


class MultiheadLocalAttention(nn.Module):
    """Dilated local-window attention with learned relative key/value
    biases (reference: attention.py:248-577). `relative_emb_k` is the
    reference's grouped 1x1 conv, (h*win2, d, 1, 1); it is applied as
    `relative_emb_from_q` to the unscaled q in fp32."""

    def __init__(self, d_model: int, num_heads: int, max_dis: int = 7,
                 dilation: int = 1, d_att: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.max_dis = max_dis
        self.dilation = dilation
        self.d_att = d_att if d_att is not None else d_model // num_heads
        self.win2 = (2 * max_dis + 1) ** 2
        self.relative_emb_k = nn.Conv2d(self.d_att * num_heads,
                                        num_heads * self.win2, 1,
                                        groups=num_heads)
        self.relative_emb_v = nn.Parameter(
            torch.zeros(num_heads, d_model // num_heads, self.win2))
        self.projection = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, size_2d) -> torch.Tensor:
        h = self.num_heads
        rel_bias = att_ops.relative_emb_from_q(
            q.float(), self.relative_emb_k.weight.view(h, self.win2, -1),
            self.relative_emb_k.bias.view(h, self.win2), h)
        out = att_ops.local_attention(
            q, k, v, rel_bias, self.relative_emb_v, num_heads=h,
            size_2d=size_2d, max_dis=self.max_dis, dilation=self.dilation,
            d_att=self.d_att)
        return self.projection(out)


class GatedPropagation(nn.Module):
    """DeAOT gated propagation: softmax attention over a 2x value stream,
    elementwise U-gate, depthwise conv, projection (reference:
    attention.py:589-717; aot_tpu/models/layers.py:288)."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int = 8,
                 d_att: Optional[int] = None, use_linear: bool = True,
                 expand_ratio: float = 2.0):
        super().__init__()
        h = num_heads
        self.num_heads = h
        self.d_att = d_att if d_att is not None else d_qk // h
        self.expand_d_vu = int(d_vu * expand_ratio)
        self.hidden = self.expand_d_vu // h
        self.use_linear = use_linear
        if use_linear:
            half = d_vu // 2
            self.linear_QK = nn.Linear(d_qk, self.d_att * h)
            self.linear_V1 = nn.Linear(half, self.hidden * h // 2)
            self.linear_V2 = nn.Linear(d_vu - half, self.hidden * h // 2)
            self.linear_U1 = nn.Linear(half, self.hidden * h // 2)
            self.linear_U2 = nn.Linear(d_vu - half, self.hidden * h // 2)
        self.dw_conv = DWConv2d(self.expand_d_vu)
        self.projection = nn.Linear(self.expand_d_vu, d_vu)

    def _cat_halves(self, x1, x2):
        """Interleave two half-width projections head by head."""
        if self.num_heads > 1:
            b, n, _ = x1.shape
            x1 = x1.reshape(b, n, self.num_heads, self.hidden // 2)
            x2 = x2.reshape(b, n, self.num_heads, self.hidden // 2)
            return torch.cat([x1, x2], dim=-1).reshape(b, n, -1)
        return torch.cat([x1, x2], dim=-1)

    def forward(self, q, k, v, u, size_2d, *, valid_len=None,
                top_k: int = -1,
                max_mem_len_ratio: float = -1.0) -> torch.Tensor:
        if self.use_linear:
            q = k = self.linear_QK(q)
            half = self.linear_V1.in_features
            v = att_ops.silu(self._cat_halves(self.linear_V1(v[..., :half]),
                                              self.linear_V2(v[..., half:])))
            u = att_ops.silu(self._cat_halves(self.linear_U1(u[..., :half]),
                                              self.linear_U2(u[..., half:])))
        out = att_ops.gated_global_attention(
            q, k, v, self.num_heads, self.d_att, valid_len=valid_len,
            top_k=top_k, max_mem_len_ratio=max_mem_len_ratio)
        return self.projection(self.dw_conv(out * u, size_2d))


class LocalGatedPropagation(nn.Module):
    """DeAOT local gated propagation, without projections of its own
    (use_linear=False, the only form DeAOT builds) and without a relative
    value bias (reference: attention.py:720-914;
    aot_tpu/models/layers.py:339)."""

    def __init__(self, d_qk: int, d_vu: int, num_heads: int,
                 d_att: Optional[int] = None, max_dis: int = 7,
                 dilation: int = 1, expand_ratio: float = 2.0):
        super().__init__()
        self.num_heads = num_heads
        self.d_att = d_att if d_att is not None else d_qk // num_heads
        self.max_dis = max_dis
        self.dilation = dilation
        self.win2 = (2 * max_dis + 1) ** 2
        expand_d_vu = int(d_vu * expand_ratio)
        self.relative_emb_k = nn.Conv2d(self.d_att * num_heads,
                                        num_heads * self.win2, 1,
                                        groups=num_heads)
        self.dw_conv = DWConv2d(expand_d_vu)
        self.projection = nn.Linear(expand_d_vu, d_vu)

    def forward(self, q, k, v, u, size_2d) -> torch.Tensor:
        h = self.num_heads
        rel_bias = att_ops.relative_emb_from_q(
            q.float(), self.relative_emb_k.weight.view(h, self.win2, -1),
            self.relative_emb_k.bias.view(h, self.win2), h)
        out = att_ops.gated_local_attention(
            q, k, v, rel_bias, num_heads=h, size_2d=size_2d,
            max_dis=self.max_dis, dilation=self.dilation, d_att=self.d_att)
        return self.projection(self.dw_conv(out * u, size_2d))
