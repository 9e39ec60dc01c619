"""2-D sine position embeddings (port of aot_tpu/ops/position.py).

DETR-style generator: per-axis normalised coordinates scaled to 2π,
temperature-1e4 frequency ladder, interleaved sin/cos, y-channels first.
Output is channel-last (1, H, W, C).
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(
    h: int,
    w: int,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
    device=None,
) -> torch.Tensor:
    """Returns (1, H, W, 2*num_pos_feats) float32."""
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(h, **f32)[:, None].expand(h, w)
    x = torch.arange(w, **f32)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def interleave(p):  # (H, W, F): sin on even channels, cos on odd
        p = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                        dim=-1)
        return p.reshape(h, w, num_pos_feats)

    pos_x = interleave(x[:, :, None] / dim_t)
    pos_y = interleave(y[:, :, None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)[None]


def sine_position_embedding_seq(h: int, w: int, d_model: int = 256,
                                device=None) -> torch.Tensor:
    """(1, H*W, d_model) flattened variant for token sequences."""
    pos = sine_position_embedding(h, w, num_pos_feats=d_model // 2,
                                  device=device)
    return pos.reshape(1, h * w, d_model)
