"""AOT and DeAOT model assemblies (port of aot_tpu/models/aot.py;
reference: networks/models/aot.py, deaot.py).

The engine drives the model through these methods:

  encode_image(img)                  -> [x4, x8, x16, x16-projected] NCHW
  get_id_emb(one_hot) / get_id_emb_label(label) -> (B, HW, C) id embedding
  lstt_forward(emb16, lt, st, id, pos, size_2d) -> (intermediates, memories)
  decode_id_logits(intermediates, shortcuts)    -> (B, M+1, H4, W4)
  fuse_memory(layer_idx, key, value, id_emb)    -> fused memory dict

The patch-wise identity bank is the reference's stride-16 conv over the
one-hot mask; the JAX package's label-matmul form of it is a TPU
lane-padding workaround and is not carried over.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.models.decoders import FPNSegmentationHead
from aot_tpu_torch.models.encoders import build_encoder
from aot_tpu_torch.models.layers import seq_from_2d, seq_to_2d
from aot_tpu_torch.models.lstt import DualBranchGPM, LongShortTermTransformer
from aot_tpu_torch.ops.position import sine_position_embedding_seq


class AOT(nn.Module):
    """reference: networks/models/aot.py:9-115."""

    def __init__(self, encoder_name: str = "mobilenetv2",
                 encoder_dims: Sequence[int] = (24, 32, 96, 1280),
                 emb_dim: int = 256, max_obj_num: int = 10,
                 lstt_num: int = 1, self_heads: int = 8, att_heads: int = 8,
                 decoder_intermediate: bool = True,
                 align_corners: bool = True):
        super().__init__()
        self.emb_dim = emb_dim
        self.max_obj_num = max_obj_num
        self.encoder = build_encoder(encoder_name)
        self.encoder_projector = nn.Conv2d(encoder_dims[-1], emb_dim, 1)
        self.LSTT = self._make_lstt(lstt_num, emb_dim, self_heads, att_heads,
                                    decoder_intermediate)
        self.decoder = FPNSegmentationHead(
            in_dim=self._decoder_indim(lstt_num, decoder_intermediate),
            out_dim=max_obj_num + 1,
            decode_intermediate_input=decoder_intermediate,
            hidden_dim=emb_dim, shortcut_dims=encoder_dims,
            align_corners=align_corners)
        # kernel 17 / pad 8 when align_corners (aot.py:50-63)
        ks = 17 if align_corners else 16
        self.patch_wise_id_bank = nn.Conv2d(
            max_obj_num + 1, emb_dim, ks, stride=16,
            padding=8 if align_corners else 0)

    # --- hooks overridden by DeAOT ---
    def _make_lstt(self, lstt_num, emb_dim, self_heads, att_heads,
                   decoder_intermediate) -> nn.Module:
        return LongShortTermTransformer(
            lstt_num, emb_dim, self_heads, att_heads,
            intermediate_norm=decoder_intermediate, final_norm=True)

    def _decoder_indim(self, lstt_num: int, decoder_intermediate: bool):
        return self.emb_dim * (lstt_num + 1 if decoder_intermediate else 1)

    def _id_post(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def encode_image(self, img: torch.Tensor):
        """img: (B, 3, H, W) normalised. Returns 4 feature maps, the last
        projected to emb_dim (aot.py:81-84)."""
        xs = self.encoder(img)
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def get_id_emb(self, one_hot: torch.Tensor) -> torch.Tensor:
        """one_hot: (B, M+1, H, W) -> (B, HW16, emb_dim) (aot.py:76-79)."""
        return self._id_post(seq_from_2d(self.patch_wise_id_bank(one_hot)))

    def get_id_emb_label(self, label: torch.Tensor) -> torch.Tensor:
        """Identity embedding of an int label map (B, H, W)."""
        one_hot = F.one_hot(label.long(), self.max_obj_num + 1)
        return self.get_id_emb(one_hot.permute(0, 3, 1, 2).float())

    def get_pos_emb(self, size_2d: Tuple[int, int], device) -> torch.Tensor:
        return sine_position_embedding_seq(size_2d[0], size_2d[1],
                                           self.emb_dim, device=device)

    def lstt_forward(self, emb16: torch.Tensor, lt_mems, st_mems,
                     curr_id_emb, pos_emb, size_2d: Tuple[int, int], *,
                     lt_valid_len=None, top_k: int = -1,
                     max_mem_len_ratio: float = -1.0):
        """emb16: (B, C, H16, W16) projected feature -> token sequence ->
        LSTT stack (aot.py:94-108)."""
        return self.LSTT(
            seq_from_2d(emb16), lt_mems, st_mems, curr_id_emb, pos_emb,
            size_2d, lt_valid_len=lt_valid_len, top_k=top_k,
            max_mem_len_ratio=max_mem_len_ratio)

    def decode_id_logits(self, lstt_intermediates, shortcuts) -> torch.Tensor:
        """(aot.py:86-92). Returns (B, M+1, H4, W4) fp32 logits."""
        size_2d = shortcuts[-1].shape[-2:]
        inputs = [shortcuts[-1]]
        inputs += [seq_to_2d(emb, size_2d) for emb in lstt_intermediates]
        return self.decoder(inputs, shortcuts)

    def fuse_memory(self, layer_idx: int, key, value, id_emb):
        """Fuse a mask's identity embedding into the stored memory."""
        return self.LSTT.fuse_key_value_id(layer_idx, key, value, id_emb)


class DeAOT(AOT):
    """reference: networks/models/deaot.py:8-55 (aot_tpu/models/aot.py:295):
    the dual-branch GPM stack, a decoder over its 2*emb_dim streams, and a
    LayerNorm on the identity embedding."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.id_norm = nn.LayerNorm(self.emb_dim)

    def _make_lstt(self, lstt_num, emb_dim, self_heads, att_heads,
                   decoder_intermediate) -> nn.Module:
        return DualBranchGPM(lstt_num, emb_dim, self_heads, att_heads,
                             intermediate_norm=decoder_intermediate,
                             final_norm=True)

    def _decoder_indim(self, lstt_num: int, decoder_intermediate: bool):
        return self.emb_dim * (lstt_num * 2 + 1 if decoder_intermediate
                               else 2)

    def _id_post(self, x: torch.Tensor) -> torch.Tensor:
        return self.id_norm(x)


# --- seeded initialisation ---------------------------------------------------
# Follows the JAX package's init scheme (xavier-uniform transformer/decoder
# weights, torch-default uniform biases, kaiming fan-out encoder convs,
# orthogonal id bank, identity FrozenBN), drawn from an explicit generator.


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=g)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal(0, std) truncated at ±2 std, by inverting the CDF."""
    edge = math.erf(2 / math.sqrt(2))
    t.uniform_(-edge, edge, generator=g)
    t.erfinv_().mul_(std * math.sqrt(2))


def _kaiming_(w: torch.Tensor, fan: int, g: torch.Generator) -> None:
    """flax variance_scaling(2.0, fan, 'truncated_normal'): the std is
    divided by the truncated normal's own std so the variance is 2/fan."""
    _trunc_normal_(w, math.sqrt(2.0 / fan) / 0.87962566103423978, g)


def _xavier_(w: torch.Tensor, g: torch.Generator) -> None:
    rf = w[0, 0].numel() if w.ndim > 2 else 1
    _uniform_(w, math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf)), g)


def _bias_(b: Optional[torch.Tensor], fan_in: int, g: torch.Generator) -> None:
    if b is not None:
        _uniform_(b, 1.0 / math.sqrt(fan_in), g)


def _orthogonal_rows_(w: torch.Tensor, gain: float, g: torch.Generator) -> None:
    o, n = w.shape[0], w[0].numel()
    a = torch.randn(max(n, o), min(n, o), generator=g)
    qm, r = torch.linalg.qr(a)
    qm = qm * torch.sign(torch.diagonal(r))[None, :]
    qm = qm if n < o else qm.T                       # (o, n)
    w.copy_(gain * qm.reshape(w.shape))


@torch.no_grad()
def init_weights(model: AOT, generator: torch.Generator) -> None:
    """Seeded initialisation of every parameter (the model must lie on the
    generator's device)."""
    g = generator
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            _xavier_(mod.weight, g)
            _bias_(mod.bias, mod.in_features, g)
        elif not isinstance(mod, nn.Conv2d):
            continue
        elif name.startswith("encoder."):                 # fan-out
            _kaiming_(mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel(),
                      g)
        elif name.endswith(("activation.conv", "dw_conv.conv")):  # fan-in
            _kaiming_(mod.weight, mod.weight[0].numel(), g)
        elif name.endswith("relative_emb_k"):
            d = mod.weight.shape[1]
            _uniform_(mod.weight, math.sqrt(6.0 / (d + mod.weight.shape[0])), g)
            _bias_(mod.bias, d, g)
        elif name == "patch_wise_id_bank":
            ks = mod.weight.shape[-1]
            _orthogonal_rows_(mod.weight, ks ** -2, g)
            _bias_(mod.bias, mod.weight[0].numel(), g)
        else:                                             # projector, decoder
            _xavier_(mod.weight, g)
            _bias_(mod.bias, mod.weight[0].numel(), g)
    for name, p in model.named_parameters():
        if name.endswith("relative_emb_v"):
            _uniform_(p, math.sqrt(6.0 / (p.shape[1] + p.shape[2])), g)


def build_vos_model(cfg, device="cpu",
                    generator: Optional[torch.Generator] = None) -> AOT:
    """Construct the eval model from a Config (aot.py:328-353): AOT or DeAOT
    (`MODEL_VOS`) with the MobileNetV2 encoder, fp32, weights drawn from
    `generator` (seed 0 when None), on `device`, in eval mode with gradients
    off (the port serves inference only)."""
    classes = {"aot": AOT, "deaot": DeAOT}
    if cfg.MODEL_VOS not in classes:
        raise NotImplementedError(
            f"MODEL_VOS={cfg.MODEL_VOS!r}: aot_tpu_torch serves "
            f"{sorted(classes)}")
    if str(cfg.TEST_DTYPE) != "float32":
        raise NotImplementedError(
            f"TEST_DTYPE={cfg.TEST_DTYPE!r}: aot_tpu_torch serves float32 "
            "only (ROADMAP.md, Queue 1: bf16 serving)")
    model = classes[cfg.MODEL_VOS](
        encoder_name=cfg.MODEL_ENCODER,
        encoder_dims=tuple(cfg.MODEL_ENCODER_DIM),
        emb_dim=cfg.MODEL_ENCODER_EMBEDDING_DIM,
        max_obj_num=cfg.MODEL_MAX_OBJ_NUM,
        lstt_num=cfg.MODEL_LSTT_NUM,
        self_heads=cfg.MODEL_SELF_HEADS,
        att_heads=cfg.MODEL_ATT_HEADS,
        decoder_intermediate=cfg.MODEL_DECODER_INTERMEDIATE_LSTT,
        align_corners=cfg.MODEL_ALIGN_CORNERS)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.requires_grad_(False).to(device).eval()
