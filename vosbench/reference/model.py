"""Plain PyTorch forward pass of AOT (AOTT) and DeAOT (R50_DeAOTL) for
inference: the yardstick that decides whether a run is correct.

It follows the published model (yoxu515/aot-benchmark: networks/models/
aot.py and deaot.py, networks/layers/transformer.py, attention.py, basic.py,
networks/decoders/fpn.py) and reads its weights by the published
state-dict names from a plain dict of tensors. It imports nothing of the
program under test. The encoder is the file `encoders/<MODEL_ENCODER>.py`
of this package (networks/encoders/ at output stride 16).

Every matrix product is a plain `F.linear`, `F.conv2d` or `@`; attention is
dense softmax over the memory it is given and the local read unfolds the
15 x 15 window. The attention reads go through `Ops`, so that a caller can
count their work instead of running them (vosbench/work.py): the model's
two by their own methods, an encoder's by the `Read` it declares.

Departures from the published code: none in the arithmetic. Layouts are
token-major (B, HW, C) and NCHW for convolutions, as in the published code.
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NEG_INF = -1e30
NEG_LOGIT = -1e10       # ids beyond the video's objects (aot_engine.py:356)
MAX_DIS = 7             # the local window's radius: 15 x 15 slots


# --- the attention reads ------------------------------------------------

def global_read(q, k, v, heads: int, d: int, role: str = "") -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over every key given, per head.
    q (B, Lq, h*d), k (B, Lk, h*d), v (B, Lk, h*dv) -> (B, Lq, h*dv).
    `role` ('self' or 'lt') names the read for a counting stand-in."""
    b, lq, _ = q.shape
    qh = q.reshape(b, lq, heads, -1).transpose(1, 2) / math.sqrt(d)
    kh = k.reshape(b, k.shape[1], heads, -1).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], heads, -1).transpose(1, 2)
    out = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, lq, -1)


def local_read(q, k, v, rel_bias, rel_v, heads: int,
               size_2d: Tuple[int, int], d: int) -> torch.Tensor:
    """Each query attends the 15 x 15 keys around its own position that lie
    inside the image, with a learned bias per slot (rel_bias (B, h, HW,
    225)) and, where given, a learned value per slot (rel_v (h, dv, 225))."""
    hgt, wid = size_2d
    hw = hgt * wid
    b = q.shape[0]
    win = 2 * MAX_DIS + 1

    def windows(x):          # (B, HW, h*c) -> (B*h, c, win², HW)
        c = x.shape[-1] // heads
        img = x.reshape(b, hgt, wid, heads, c).permute(0, 3, 4, 1, 2)
        cols = F.unfold(img.reshape(b * heads, c, hgt, wid), win,
                        padding=MAX_DIS)
        return cols.view(b * heads, c, win * win, hw)

    qt = (q / math.sqrt(d)).reshape(b, hw, heads, d).permute(0, 2, 3, 1)
    scores = torch.einsum("ncq,ncwq->nqw", qt.reshape(b * heads, d, hw),
                          windows(k))
    scores = scores + rel_bias.reshape(b * heads, hw, win * win)
    r = torch.arange(-MAX_DIS, MAX_DIS + 1, device=q.device)
    ky = torch.arange(hgt, device=q.device)[:, None, None, None] + r[:, None]
    kx = torch.arange(wid, device=q.device)[None, :, None, None] + r
    inside = ((ky >= 0) & (ky < hgt) & (kx >= 0) & (kx < wid)).reshape(hw, -1)
    attn = torch.softmax(scores.masked_fill(~inside, NEG_INF), dim=-1)
    out = torch.einsum("nqw,ncwq->nqc", attn, windows(v))
    dv = out.shape[-1]
    out = out.reshape(b, heads, hw, dv)
    if rel_v is not None:
        out = out + torch.einsum("bhqw,hcw->bhqc",
                                 attn.reshape(b, heads, hw, -1), rel_v)
    return out.permute(0, 2, 1, 3).reshape(b, hw, heads * dv)


class Read(NamedTuple):
    """An attention read that an encoder declares of its own (a Swin
    window read, say), called as `ops.read(decl, *args)` with positional
    arguments: `plain(*args)` computes it; `role` names it in the work
    counts (an ops/*.json work function sums the reads of its role);
    `work(*shapes)` gives its (flops, bytes), where `shapes` are the
    arguments with each tensor replaced by its shape."""
    name: str
    role: str
    plain: Callable
    work: Callable


class Ops:
    """The attention reads the model calls; vosbench/work.py swaps in a
    counting stand-in."""
    global_read = staticmethod(global_read)
    local_read = staticmethod(local_read)

    @staticmethod
    def read(decl: Read, *args):
        return decl.plain(*args)


# --- layers -----------------------------------------------------------------

def linear(P: Params, name: str, x):
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def conv(P: Params, name: str, x, stride=1, padding=0, dilation=1, groups=1):
    return F.conv2d(x, P[name + ".weight"], P.get(name + ".bias"), stride,
                    padding, dilation, groups)


def frozen_bn(P: Params, name: str, x, eps: float = 1e-5):
    scale = P[name + ".weight"] * torch.rsqrt(P[name + ".running_var"] + eps)
    shift = P[name + ".bias"] - P[name + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def layer_norm(P: Params, name: str, x):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], 1e-5)


def group_norm(P: Params, name: str, x, groups: int):
    return F.group_norm(x, groups, P[name + ".weight"], P[name + ".bias"],
                        1e-5)


def to_2d(x, size_2d):
    b, _, c = x.shape
    return x.transpose(1, 2).reshape(b, c, size_2d[0], size_2d[1])


def to_seq(x):
    return x.flatten(2).transpose(1, 2)


def silu(x):
    return x * torch.sigmoid(x)


def dw_conv5(P: Params, name: str, x, size_2d):
    """5 x 5 depthwise convolution of a token sequence."""
    c = x.shape[-1]
    return to_seq(conv(P, name, to_2d(x, size_2d), padding=2, groups=c))


def sine_position(h: int, w: int, d_model: int, device) -> torch.Tensor:
    """DETR's 2-D sine embedding (temperature 1e4, normalised to 2 pi),
    y channels first, as (1, HW, d_model)."""
    f = d_model // 2
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(h, **f32)[:, None].expand(h, w)
    x = torch.arange(w, **f32)[None, :].expand(h, w)
    y = y / (y[-1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, -1:] + 1e-6) * 2 * math.pi
    dim_t = torch.arange(f, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / f)

    def interleave(p):
        p = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], -1)
        return p.reshape(h, w, f)

    pos = torch.cat([interleave(y[..., None] / dim_t),
                     interleave(x[..., None] / dim_t)], dim=-1)
    return pos.reshape(1, h * w, d_model)


# --- the model --------------------------------------------------------------

def encoder(name: str):
    """The module `encoders/<name>.py` beside this file."""
    try:
        return importlib.import_module(f"{__package__}.encoders.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.encoders.{name}":
            raise
        raise ValueError(f"no reference encoder {name!r}: add "
                         f"reference/encoders/{name}.py") from None


class Model:
    """AOT or DeAOT at inference, from a flat state dict `P` and the model
    keys of the published config (MODEL_VOS, MODEL_ENCODER,
    MODEL_LSTT_NUM, MODEL_ATT_HEADS, MODEL_SELF_HEADS, MODEL_MAX_OBJ_NUM,
    MODEL_ENCODER_EMBEDDING_DIM, MODEL_ALIGN_CORNERS)."""

    def __init__(self, P: Params, cfg: Dict, ops=Ops):
        self.P = P
        self.ops = ops
        self.deaot = cfg["MODEL_VOS"] == "deaot"
        self.encoder = encoder(cfg["MODEL_ENCODER"])
        self.layers = cfg["MODEL_LSTT_NUM"]
        self.att_heads = cfg["MODEL_ATT_HEADS"]
        self.self_heads = cfg["MODEL_SELF_HEADS"]
        self.max_obj = cfg["MODEL_MAX_OBJ_NUM"]
        self.emb = cfg["MODEL_ENCODER_EMBEDDING_DIM"]
        self.align_corners = cfg["MODEL_ALIGN_CORNERS"]
        self._pos = {}

    # the image and the mask
    def encode(self, img_u8: torch.Tensor):
        """(1, H, W, 3) uint8 -> the encoder's [x4, x8, x16, x16 projected]."""
        mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
        std = torch.tensor(IMAGENET_STD, device=img_u8.device)
        x = ((img_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        xs = self.encoder.encode(self.P, x.contiguous(), self.ops)
        xs[-1] = conv(self.P, "encoder_projector", xs[-1])
        return xs

    def id_emb(self, label: torch.Tensor) -> torch.Tensor:
        """(1, H, W) ids -> (1, HW16, C): the patch-wise identity bank over
        the one-hot mask (kernel 17, stride 16, padding 8 when aligning
        corners, else 16 / 0)."""
        ids = torch.arange(self.max_obj + 1, device=label.device)
        one_hot = (label.long()[:, None] == ids[None, :, None, None]).float()
        pad = 8 if self.align_corners else 0
        x = to_seq(conv(self.P, "patch_wise_id_bank", one_hot, 16, pad))
        return layer_norm(self.P, "id_norm", x) if self.deaot else x

    def pos(self, size_2d, device):
        key = (size_2d, str(device))
        if key not in self._pos:
            self._pos[key] = sine_position(*size_2d, self.emb, device)
        return self._pos[key]

    # AOT's LSTT block (transformer.py:258-372)
    def aot_block(self, i, x, lt, st, id_emb, pos, size_2d):
        P, pre = self.P, f"LSTT.layers.{i}"
        h = self.att_heads
        d = self.emb // h
        t = layer_norm(P, pre + ".norm1", x)
        qk = t + pos
        sa = f"{pre}.self_attn"
        x = x + linear(P, sa + ".projection", self.ops.global_read(
            linear(P, sa + ".linear_Q", qk), linear(P, sa + ".linear_K", qk),
            linear(P, sa + ".linear_V", t), self.self_heads,
            self.emb // self.self_heads, role="self"))
        t = layer_norm(P, pre + ".norm2", x)
        q = linear(P, pre + ".linear_Q", t)
        curr = {"k": q, "v": t}
        if id_emb is not None:
            lt = st = self.aot_fuse(i, curr, id_emb)
        lt_out = self.ops.global_read(q, lt["k"], lt["v"], h, d, role="lt")
        x = x + linear(P, pre + ".long_term_attn.projection", lt_out) + \
            self.local(pre + ".short_term_attn", q, st["k"], st["v"], h, d,
                       size_2d, rel_v=True)
        t = layer_norm(P, pre + ".norm3", x)
        y = linear(P, pre + ".linear1", t)
        y = F.gelu(to_seq(group_norm(P, pre + ".activation.gn", to_2d(
            y, size_2d), 32)))
        y = dw_conv5(P, pre + ".activation.conv", y, size_2d)
        x = x + linear(P, pre + ".linear2", y)
        return x, None, curr

    def aot_fuse(self, i, curr, id_emb):
        name = f"LSTT.layers.{i}.linear_V"
        return {"k": curr["k"], "v": linear(self.P, name, curr["v"] + id_emb)}

    def local(self, name, q, k, v, h, d, size_2d, rel_v: bool):
        """The ST read with its relative key bias (a grouped 1 x 1 conv on
        the unscaled q) and, for AOT, relative value bias; then the
        projection (DeAOT: after the gate, in deaot_block)."""
        P = self.P
        win2 = (2 * MAX_DIS + 1) ** 2
        w = P[name + ".relative_emb_k.weight"].reshape(h, win2, d)
        bias = P[name + ".relative_emb_k.bias"].reshape(h, win2)
        b, hw, _ = q.shape
        qh = q.reshape(b, hw, h, d).transpose(1, 2)
        rel_bias = qh @ w.transpose(1, 2) + bias[:, None, :]
        rv = P[name + ".relative_emb_v"] if rel_v else None
        out = self.ops.local_read(q, k, v, rel_bias, rv, h, size_2d, d)
        return linear(P, name + ".projection", out) if rel_v else out

    # DeAOT's gated propagation block (transformer.py:501-670)
    def deaot_block(self, i, x, x_id, lt, st, id_emb, pos, size_2d):
        P, pre = self.P, f"LSTT.layers.{i}"
        h = self.att_heads
        d = self.emb // 2 if h == 1 else self.emb // h
        t = layer_norm(P, pre + ".norm1", x)
        qv = linear(P, pre + ".linear_QV", t)
        q = qv[..., :d * h]
        v = silu(qv[..., d * h:])
        u = linear(P, pre + ".linear_U", t)
        if x_id is None:
            curr_id = None
            gate = torch.cat([silu(u), torch.ones_like(u)], dim=-1)
        else:
            curr_id = layer_norm(P, pre + ".id_norm1", x_id)
            id_u = linear(P, pre + ".linear_ID_U", curr_id)
            gate = silu(torch.cat([u, id_u], dim=-1))
        curr = {"k": q, "v": v, "id_v": curr_id}
        if id_emb is not None:
            lt = st = self.deaot_fuse(i, curr, id_emb)
        lt_out = self.ops.global_read(q, lt["k"], torch.cat(
            [lt["v"], lt["id_v"]], dim=-1), h, d, role="lt")
        st_out = self.local(pre + ".short_term_attn", q, st["k"], torch.cat(
            [st["v"], st["id_v"]], dim=-1), h, d, size_2d, rel_v=False)
        both = (linear(P, pre + ".long_term_attn.projection", dw_conv5(
            P, pre + ".long_term_attn.dw_conv.conv", lt_out * gate, size_2d))
            + linear(P, pre + ".short_term_attn.projection", dw_conv5(
                P, pre + ".short_term_attn.dw_conv.conv", st_out * gate,
                size_2d)))
        x = x + both[..., :self.emb]
        delta_id = both[..., self.emb:]
        x_id = delta_id if x_id is None else x_id + delta_id
        # the gated self-attention over [visual, identity]
        s = torch.cat([layer_norm(P, pre + ".norm2", x),
                       layer_norm(P, pre + ".id_norm2", x_id)], dim=-1)
        sa = pre + ".self_attn"
        half = s.shape[-1] // 2
        qk = linear(P, sa + ".linear_QK", s)
        sv = silu(torch.cat([linear(P, sa + ".linear_V1", s[..., :half]),
                             linear(P, sa + ".linear_V2", s[..., half:])], -1))
        su = silu(torch.cat([linear(P, sa + ".linear_U1", s[..., :half]),
                             linear(P, sa + ".linear_U2", s[..., half:])], -1))
        heads = self.self_heads
        out = self.ops.global_read(qk, qk, sv, heads, qk.shape[-1] // heads,
                                   role="self")
        out = linear(P, sa + ".projection",
                     dw_conv5(P, sa + ".dw_conv.conv", out * su, size_2d))
        return x + out[..., :self.emb], x_id + out[..., self.emb:], curr

    def deaot_fuse(self, i, curr, id_emb):
        pre = f"LSTT.layers.{i}"
        x = id_emb if curr["id_v"] is None else torch.cat(
            [curr["id_v"], id_emb], dim=-1)
        return {"k": curr["k"], "v": curr["v"],
                "id_v": silu(linear(self.P, pre + ".linear_ID_V", x))}

    def fuse(self, i, curr, id_emb):
        return (self.deaot_fuse if self.deaot else self.aot_fuse)(i, curr,
                                                                  id_emb)

    def lstt(self, xs, lt: Optional[Sequence], st: Optional[Sequence],
             id_emb: Optional[torch.Tensor]):
        """The block stack over the 16x map. lt/st: per layer the memory
        read ({k, v[, id_v]}, tokens concatenated); None with id_emb given
        (a reference frame reads itself). Returns the decoder's input map
        and each layer's current (unfused) memory entry."""
        x16 = xs[-1]
        size_2d = tuple(x16.shape[-2:])
        x = to_seq(x16)
        pos = self.pos(size_2d, x.device)
        x_id, currs, outs = None, [], []
        for i in range(self.layers):
            li = None if lt is None else lt[i]
            si = None if st is None else st[i]
            if self.deaot:
                x, x_id, curr = self.deaot_block(i, x, x_id, li, si, id_emb,
                                                 pos, size_2d)
            else:
                x, _, curr = self.aot_block(i, x, li, si, id_emb, pos, size_2d)
                outs.append(x)
            currs.append(curr)
        if self.deaot:       # GroupNorm(2) on [visual, identity]
            out = to_2d(torch.cat([x, x_id], dim=-1), size_2d)
            out = group_norm(self.P, "LSTT.decoder_norms.0.gn", out, 2)
            return [out], currs
        # AOT hands the decoder every block's output, each under its own
        # norm (MODEL_DECODER_INTERMEDIATE_LSTT, set in every published AOT
        # config; transformer.py LongShortTermTransformer's decoder_norms)
        return [xs[-1]] + [
            to_2d(layer_norm(self.P, f"LSTT.decoder_norms.{i}", out), size_2d)
            for i, out in enumerate(outs)], currs

    def decode(self, inputs, xs, obj_num: int) -> torch.Tensor:
        """FPN head -> (1, h4, w4, M + 1) logits, NHWC, ids beyond obj_num
        at NEG_LOGIT."""
        P, pre = self.P, "decoder"

        def up(x, like):
            return F.interpolate(x, size=like.shape[-2:], mode="bilinear",
                                 align_corners=self.align_corners)

        def cgn(name, x, pad):
            return group_norm(P, f"{pre}.{name}.gn",
                              conv(P, f"{pre}.{name}.conv", x, padding=pad), 8)

        x = torch.cat(list(inputs), dim=1) if not self.deaot else inputs[-1]
        x = torch.relu(cgn("conv_in", x, 0))
        def stage(name, x, shortcut):
            adapted = conv(P, f"{pre}.adapter_{name}", shortcut)
            return torch.relu(cgn(f"conv_{name}", adapted + x, 1))

        x = stage("16x", x, xs[-2])
        x = stage("8x", up(x, xs[-3]), xs[-3])
        x = stage("4x", up(x, xs[-4]), xs[-4])
        logits = conv(P, pre + ".conv_out", x).permute(0, 2, 3, 1)
        ids = torch.arange(self.max_obj + 1, device=logits.device)
        return logits.masked_fill(ids > obj_num, NEG_LOGIT)

    def upsample(self, logits: torch.Tensor, size) -> torch.Tensor:
        """(1, h4, w4, C) -> (1, C, H, W) bilinear."""
        return F.interpolate(logits.permute(0, 3, 1, 2), size=tuple(size),
                             mode="bilinear", align_corners=self.align_corners)
