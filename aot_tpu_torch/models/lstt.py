"""Long Short-Term Transformer and DeAOT's dual-branch stack (port of
aot_tpu/models/lstt.py; reference: networks/layers/transformer.py).

Memory interface as in the JAX package: long-term memory per layer is a
dict {k, v} whose token axis is the LT ring (live length `lt_valid_len`);
short-term memory per layer is {k, v} of the window frame. Blocks return
their unfused current (k, v); fusing a mask's identity into memory is the
separate `fuse_key_value_id`, so the engine can call it with predicted
masks. DeAOT's memory adds a third entry, `id_v`, the identity branch's
values; its blocks fuse the mask's identity into `id_v` alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from aot_tpu_torch.models import layers as L
from aot_tpu_torch.ops import attention as att_ops

Mem = Dict[str, torch.Tensor]


class LSTTBlockV1(nn.Module):
    """reference: transformer.py:258-372 (LongShortTermTransformerBlock)."""

    def __init__(self, d_model: int, self_heads: int = 8, att_heads: int = 8,
                 dim_feedforward: int = 1024, local_dilation: int = 1,
                 max_dis: int = 7, droppath: float = 0.0,
                 lt_dropout: float = 0.0, st_dropout: float = 0.0,
                 droppath_lst: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)
        self.linear_Q = nn.Linear(d_model, d_model)
        self.linear_V = nn.Linear(d_model, d_model)
        self.self_attn = L.MultiheadAttention(d_model, self_heads,
                                              use_linear=True)
        self.long_term_attn = L.MultiheadAttention(
            d_model, att_heads, use_linear=False, dropout=lt_dropout)
        self.short_term_attn = L.MultiheadLocalAttention(
            d_model, att_heads, max_dis=max_dis, dilation=local_dilation)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.activation = L.GNActDWConv2d(dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.droppath = L.DropPath(droppath)
        self.droppath_lst = droppath_lst
        self.lst_dropout = max(lt_dropout, st_dropout)

    def fuse_key_value_id(self, key, value, id_emb) -> Mem:
        """V = linear_V(value + id_emb); K unchanged (transformer.py:364-367)."""
        return {"k": key, "v": self.linear_V(value + id_emb.to(value.dtype))}

    def forward(self, tgt, lt_mem: Optional[Mem], st_mem: Optional[Mem],
                curr_id_emb: Optional[torch.Tensor],
                self_pos: Optional[torch.Tensor], size_2d: Tuple[int, int],
                *, lt_valid_len=None, top_k: int = -1,
                max_mem_len_ratio: float = -1.0,
                generator: Optional[torch.Generator] = None):
        g = generator
        # self attention: q = k = norm1(tgt) + pos, v = norm1(tgt)
        _tgt = self.norm1(tgt)
        q = _tgt + self_pos.to(_tgt.dtype) if self_pos is not None else _tgt
        tgt = tgt + self.droppath(self.self_attn(q, q, _tgt), g)

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
            max_mem_len_ratio=max_mem_len_ratio, generator=g)
        tgt3 = self.short_term_attn(curr_q, local_k, local_v, size_2d)
        if self.droppath_lst:
            tgt = tgt + self.droppath(tgt2 + tgt3, g)
        else:
            tgt = tgt + L.dropout(tgt2 + tgt3, self.lst_dropout, g)

        # FFN with the depthwise-conv activation
        _tgt = self.norm3(tgt)
        tgt = tgt + self.droppath(
            self.linear2(self.activation(self.linear1(_tgt), size_2d)), g)

        mems = {"curr": {"k": curr_k, "v": curr_v},
                "global": {"k": global_k, "v": global_v}}
        return tgt, mems


class LongShortTermTransformer(nn.Module):
    """Stack of LSTT blocks with intermediate norms for the decoder
    (reference: transformer.py:33-140)."""

    def __init__(self, num_layers: int = 2, d_model: int = 256,
                 self_heads: int = 8, att_heads: int = 8,
                 dim_feedforward: int = 1024, intermediate_norm: bool = True,
                 final_norm: bool = True, emb_dropout: float = 0.0,
                 droppath: float = 0.0, lt_dropout: float = 0.0,
                 st_dropout: float = 0.0, droppath_lst: bool = False,
                 droppath_scaling: bool = False):
        super().__init__()
        self.intermediate_norm = intermediate_norm
        self.final_norm = final_norm
        self.emb_dropout = emb_dropout

        def rate(idx):
            if not droppath_scaling:
                return droppath
            return 0.0 if num_layers == 1 else droppath * idx / (num_layers - 1)

        self.layers = nn.ModuleList(
            LSTTBlockV1(d_model, self_heads, att_heads, dim_feedforward,
                        droppath=rate(idx), lt_dropout=lt_dropout,
                        st_dropout=st_dropout, droppath_lst=droppath_lst)
            for idx in range(num_layers))
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
                max_mem_len_ratio: float = -1.0,
                generator: Optional[torch.Generator] = None):
        output = L.dropout(tgt, self.emb_dropout, generator)
        intermediates, memories = [], []
        for idx, layer in enumerate(self.layers):
            output, mems = layer(
                output,
                lt_mems[idx] if lt_mems is not None else None,
                st_mems[idx] if st_mems is not None else None,
                curr_id_emb, self_pos, size_2d,
                lt_valid_len=lt_valid_len, top_k=top_k,
                max_mem_len_ratio=max_mem_len_ratio, generator=generator)
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


class GroupNorm1D(nn.Module):
    """GroupNorm over the channels of a (B, HW, C) sequence, under the
    reference's module name (transformer.py `GroupNorm1D`: `.gn`)."""

    def __init__(self, features: int, groups: int):
        super().__init__()
        self.gn = nn.GroupNorm(groups, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.group_norm_seq(self.gn, x)


class GatedPropagationModule(nn.Module):
    """DeAOT dual-branch block (reference: transformer.py:501-670;
    aot_tpu/models/lstt.py:331). Layer 0 starts the identity branch from the
    attention output; later layers carry it in (`tgt_id`)."""

    def __init__(self, d_model: int, self_heads: int = 1, att_heads: int = 1,
                 layer_idx: int = 0):
        super().__init__()
        expand_d = 2 * d_model
        self.d_model = d_model
        self.att_heads = att_heads
        self.d_att = d_model // 2 if att_heads == 1 else d_model // att_heads
        self.norm1 = nn.LayerNorm(d_model)
        self.linear_QV = nn.Linear(d_model, self.d_att * att_heads + expand_d)
        self.linear_U = nn.Linear(d_model, expand_d)
        if layer_idx == 0:
            self.linear_ID_V = nn.Linear(d_model, expand_d)
        else:
            self.id_norm1 = nn.LayerNorm(d_model)
            self.linear_ID_V = nn.Linear(2 * d_model, expand_d)
            self.linear_ID_U = nn.Linear(d_model, expand_d)
        self.long_term_attn = L.GatedPropagation(
            d_model, d_model * 2, att_heads, d_att=self.d_att,
            use_linear=False)
        self.short_term_attn = L.LocalGatedPropagation(
            d_model, d_model * 2, att_heads, d_att=self.d_att)
        self.norm2 = nn.LayerNorm(d_model)
        self.id_norm2 = nn.LayerNorm(d_model)
        self.self_attn = L.GatedPropagation(
            d_model * 2, d_model * 2, self_heads, d_att=self.d_att,
            use_linear=True)

    def fuse_key_value_id(self, key, value, id_emb) -> Mem:
        """id_v = silu(linear_ID_V([value, id_emb] or id_emb))
        (transformer.py:659-665); key is unused, value is the block's
        normalised identity input (None at layer 0)."""
        del key
        x = id_emb if value is None else torch.cat(
            [value, id_emb.to(value.dtype)], dim=-1)
        return {"id_v": att_ops.silu(self.linear_ID_V(x))}

    def forward(self, tgt, tgt_id, lt_mem: Optional[Mem],
                st_mem: Optional[Mem], curr_id_emb: Optional[torch.Tensor],
                size_2d: Tuple[int, int], *, lt_valid_len=None,
                top_k: int = -1, max_mem_len_ratio: float = -1.0):
        d_model = self.d_model
        n_qk = self.d_att * self.att_heads
        _tgt = self.norm1(tgt)
        qv = self.linear_QV(_tgt)
        # contiguous: the kernels read q and the memory stores k
        curr_q = curr_k = qv[..., :n_qk].contiguous()
        curr_v = att_ops.silu(qv[..., n_qk:])
        curr_u = self.linear_U(_tgt)

        if tgt_id is None:
            curr_id_v = None
            cat_curr_u = torch.cat([att_ops.silu(curr_u),
                                    torch.ones_like(curr_u)], dim=-1)
        else:
            curr_id_v = self.id_norm1(tgt_id)
            cat_curr_u = att_ops.silu(torch.cat(
                [curr_u, self.linear_ID_U(curr_id_v)], dim=-1))

        if curr_id_emb is not None:
            global_k, global_v = curr_k, curr_v
            global_id_v = self.fuse_key_value_id(
                None, curr_id_v, curr_id_emb)["id_v"]
            local_k, local_v, local_id_v = global_k, global_v, global_id_v
            lt_valid_len = None
        else:
            global_k, global_v = lt_mem["k"], lt_mem["v"]
            global_id_v = lt_mem["id_v"]
            local_k, local_v = st_mem["k"], st_mem["v"]
            local_id_v = st_mem["id_v"]

        cat_tgt2 = self.long_term_attn(
            curr_q, global_k, torch.cat([global_v, global_id_v], dim=-1),
            cat_curr_u, size_2d, valid_len=lt_valid_len, top_k=top_k,
            max_mem_len_ratio=max_mem_len_ratio)
        cat_tgt3 = self.short_term_attn(
            curr_q, local_k, torch.cat([local_v, local_id_v], dim=-1),
            cat_curr_u, size_2d)
        cat_tgt = cat_tgt2 + cat_tgt3
        tgt = tgt + cat_tgt[..., :d_model]
        delta_id = cat_tgt[..., d_model:]
        tgt_id = delta_id if tgt_id is None else tgt_id + delta_id

        # gated self-attention over the concatenated dual branch
        qkvu = torch.cat([self.norm2(tgt), self.id_norm2(tgt_id)], dim=-1)
        cat_tgt2 = self.self_attn(qkvu, qkvu, qkvu, qkvu, size_2d)
        tgt = tgt + cat_tgt2[..., :d_model]
        tgt_id = tgt_id + cat_tgt2[..., d_model:]

        # layer 0 has no identity input: its curr memory holds no id_v
        curr = {"k": curr_k, "v": curr_v}
        if curr_id_v is not None:
            curr["id_v"] = curr_id_v
        mems = {"curr": curr,
                "global": {"k": global_k, "v": global_v, "id_v": global_id_v}}
        return tgt, tgt_id, mems


class DualBranchGPM(nn.Module):
    """Stack of GPM blocks; the concatenated [visual, identity] streams feed
    the decoder through GroupNorm(2) norms (reference:
    transformer.py:143-255; aot_tpu/models/lstt.py:481)."""

    def __init__(self, num_layers: int = 2, d_model: int = 256,
                 self_heads: int = 1, att_heads: int = 1,
                 intermediate_norm: bool = True, final_norm: bool = True):
        super().__init__()
        self.intermediate_norm = intermediate_norm
        self.final_norm = final_norm
        self.layers = nn.ModuleList(
            GatedPropagationModule(d_model, self_heads, att_heads,
                                   layer_idx=idx)
            for idx in range(num_layers))
        num_norms = (num_layers - 1) if intermediate_norm else 0
        if final_norm:
            num_norms += 1
        self.decoder_norms = nn.ModuleList(
            GroupNorm1D(d_model * 2, 2) for _ in range(num_norms))

    def fuse_key_value_id(self, layer_idx: int, key, value, id_emb) -> Mem:
        return self.layers[layer_idx].fuse_key_value_id(key, value, id_emb)

    def forward(self, tgt, lt_mems: Optional[Sequence[Mem]],
                st_mems: Optional[Sequence[Mem]], curr_id_emb, self_pos,
                size_2d, *, lt_valid_len=None, top_k: int = -1,
                max_mem_len_ratio: float = -1.0,
                generator: Optional[torch.Generator] = None):
        del self_pos  # the reference GPM accepts but never uses it
        if generator is not None:
            raise NotImplementedError(
                "DeAOT training (dropout and stochastic depth in the GPM "
                "stack) is not ported yet (ROADMAP.md, Queue 1)")
        output, output_id = tgt, None
        intermediates, memories = [], []
        for idx, layer in enumerate(self.layers):
            output, output_id, mems = layer(
                output, output_id,
                lt_mems[idx] if lt_mems is not None else None,
                st_mems[idx] if st_mems is not None else None,
                curr_id_emb, size_2d, lt_valid_len=lt_valid_len, top_k=top_k,
                max_mem_len_ratio=max_mem_len_ratio)
            intermediates.append(torch.cat([output, output_id], dim=-1))
            memories.append(mems)

        if len(self.decoder_norms) > 0:
            if self.final_norm:
                intermediates[-1] = self.decoder_norms[-1](intermediates[-1])
            if self.intermediate_norm:
                for idx in range(len(intermediates) - 1):
                    intermediates[idx] = self.decoder_norms[idx](
                        intermediates[idx])
        return intermediates, memories
