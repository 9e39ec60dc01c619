"""Long Short-Term Transformer (port of aot_tpu/models/lstt.py:34-328;
reference: networks/layers/transformer.py).

Memory interface as in the JAX package: long-term memory per layer is a
dict {k, v} whose token axis is the LT ring (live length `lt_valid_len`);
short-term memory per layer is {k, v} of the window frame. Blocks return
their unfused current (k, v); fusing a mask's identity into memory is the
separate `fuse_key_value_id`, so the engine can call it with predicted
masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from aot_tpu_torch.models import layers as L

Mem = Dict[str, torch.Tensor]


class LSTTBlockV1(nn.Module):
    """reference: transformer.py:258-372 (LongShortTermTransformerBlock)."""

    def __init__(self, d_model: int, self_heads: int = 8, att_heads: int = 8,
                 dim_feedforward: int = 1024, local_dilation: int = 1,
                 max_dis: int = 7):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)
        self.linear_Q = nn.Linear(d_model, d_model)
        self.linear_V = nn.Linear(d_model, d_model)
        self.self_attn = L.MultiheadAttention(d_model, self_heads,
                                              use_linear=True)
        self.long_term_attn = L.MultiheadAttention(d_model, att_heads,
                                                   use_linear=False)
        self.short_term_attn = L.MultiheadLocalAttention(
            d_model, att_heads, max_dis=max_dis, dilation=local_dilation)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.activation = L.GNActDWConv2d(dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def fuse_key_value_id(self, key, value, id_emb) -> Mem:
        """V = linear_V(value + id_emb); K unchanged (transformer.py:364-367)."""
        return {"k": key, "v": self.linear_V(value + id_emb.to(value.dtype))}

    def forward(self, tgt, lt_mem: Optional[Mem], st_mem: Optional[Mem],
                curr_id_emb: Optional[torch.Tensor],
                self_pos: Optional[torch.Tensor], size_2d: Tuple[int, int],
                *, lt_valid_len=None, top_k: int = -1,
                max_mem_len_ratio: float = -1.0):
        # self attention: q = k = norm1(tgt) + pos, v = norm1(tgt)
        _tgt = self.norm1(tgt)
        q = _tgt + self_pos.to(_tgt.dtype) if self_pos is not None else _tgt
        tgt = tgt + self.self_attn(q, q, _tgt)

        # long/short-term attention
        _tgt = self.norm2(tgt)
        curr_q = self.linear_Q(_tgt)
        curr_k, curr_v = curr_q, _tgt
        if curr_id_emb is not None:
            fused = self.fuse_key_value_id(curr_k, curr_v, curr_id_emb)
            global_k, global_v = fused["k"], fused["v"]
            local_k, local_v = global_k, global_v
            lt_valid_len = None
        else:
            global_k, global_v = lt_mem["k"], lt_mem["v"]
            local_k, local_v = st_mem["k"], st_mem["v"]

        tgt2 = self.long_term_attn(
            curr_q, global_k, global_v, valid_len=lt_valid_len, top_k=top_k,
            max_mem_len_ratio=max_mem_len_ratio)
        tgt3 = self.short_term_attn(curr_q, local_k, local_v, size_2d)
        tgt = tgt + (tgt2 + tgt3)

        # FFN with the depthwise-conv activation
        _tgt = self.norm3(tgt)
        tgt = tgt + self.linear2(self.activation(self.linear1(_tgt), size_2d))

        mems = {"curr": {"k": curr_k, "v": curr_v},
                "global": {"k": global_k, "v": global_v}}
        return tgt, mems


class LongShortTermTransformer(nn.Module):
    """Stack of LSTT blocks with intermediate norms for the decoder
    (reference: transformer.py:33-140)."""

    def __init__(self, num_layers: int = 2, d_model: int = 256,
                 self_heads: int = 8, att_heads: int = 8,
                 dim_feedforward: int = 1024, intermediate_norm: bool = True,
                 final_norm: bool = True):
        super().__init__()
        self.intermediate_norm = intermediate_norm
        self.final_norm = final_norm
        self.layers = nn.ModuleList(
            LSTTBlockV1(d_model, self_heads, att_heads, dim_feedforward)
            for _ in range(num_layers))
        num_norms = (num_layers - 1) if intermediate_norm else 0
        if final_norm:
            num_norms += 1
        self.decoder_norms = nn.ModuleList(
            nn.LayerNorm(d_model) for _ in range(num_norms))

    def fuse_key_value_id(self, layer_idx: int, key, value, id_emb) -> Mem:
        return self.layers[layer_idx].fuse_key_value_id(key, value, id_emb)

    def forward(self, tgt, lt_mems: Optional[Sequence[Mem]],
                st_mems: Optional[Sequence[Mem]], curr_id_emb, self_pos,
                size_2d, *, lt_valid_len=None, top_k: int = -1,
                max_mem_len_ratio: float = -1.0):
        output = tgt
        intermediates, memories = [], []
        for idx, layer in enumerate(self.layers):
            output, mems = layer(
                output,
                lt_mems[idx] if lt_mems is not None else None,
                st_mems[idx] if st_mems is not None else None,
                curr_id_emb, self_pos, size_2d,
                lt_valid_len=lt_valid_len, top_k=top_k,
                max_mem_len_ratio=max_mem_len_ratio)
            intermediates.append(output)
            memories.append(mems)

        if len(self.decoder_norms) > 0:
            if self.final_norm:
                intermediates[-1] = self.decoder_norms[-1](intermediates[-1])
            if self.intermediate_norm:
                for idx in range(len(intermediates) - 1):
                    intermediates[idx] = self.decoder_norms[idx](
                        intermediates[idx])
        return intermediates, memories
