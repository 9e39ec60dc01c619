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

Compute dtype (`compute_dtype`: TEST_DTYPE for serving, TRAIN_DTYPE for
training, float32 or bfloat16): the parameters stay fp32 and the layers
compute in their input's dtype (models/layers.py), so the model casts what
enters it, where aot_tpu/models/aot.py:211,217,284 does: the image, the
one-hot mask and the position embedding. The decoder returns fp32 logits,
and the losses are computed from them in fp32, as the JAX package's
(aot_tpu/models/decoders.py:59, aot_tpu/ops/losses.py:83,111,170).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aot_tpu_torch.models.decoders import FPNSegmentationHead
from aot_tpu_torch.models.encoders import build_encoder
from aot_tpu_torch.models.encoders.swin import SwinTransformer
from aot_tpu_torch.models.layers import (Conv2d, LayerNorm, dropout,
                                        seq_from_2d, seq_to_2d)
from aot_tpu_torch.models.lstt import DualBranchGPM, LongShortTermTransformer
from aot_tpu_torch.ops.position import sine_position_embedding_seq
from aot_tpu_torch.utils.device import resolve_device
from aot_tpu_torch.utils.tracing import span


class AOT(nn.Module):
    """reference: networks/models/aot.py:9-115."""

    def __init__(self, encoder_name: str = "mobilenetv2",
                 encoder_dims: Sequence[int] = (24, 32, 96, 1280),
                 emb_dim: int = 256, max_obj_num: int = 10,
                 lstt_num: int = 1, self_heads: int = 8, att_heads: int = 8,
                 decoder_intermediate: bool = True,
                 align_corners: bool = True, id_dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 frozen_bn: bool = True, **lstt_drop):
        """lstt_drop: the LSTT stack's dropout and stochastic-depth rates
        (emb_dropout, droppath, lt_dropout, st_dropout, droppath_lst,
        droppath_scaling); they act only on a forward given a generator.
        frozen_bn=False: the encoder's BatchNorms are trainable
        (encoders.common.TrainableBatchNorm2d)."""
        super().__init__()
        self.compute_dtype = compute_dtype
        self.emb_dim = emb_dim
        self.max_obj_num = max_obj_num
        self.id_dropout = id_dropout
        self.encoder = build_encoder(encoder_name, frozen_bn)
        self.encoder_projector = Conv2d(encoder_dims[-1], emb_dim, 1)
        self.LSTT = self._make_lstt(lstt_num, emb_dim, self_heads, att_heads,
                                    decoder_intermediate, **lstt_drop)
        self.decoder = FPNSegmentationHead(
            in_dim=self._decoder_indim(lstt_num, decoder_intermediate),
            out_dim=max_obj_num + 1,
            decode_intermediate_input=decoder_intermediate,
            hidden_dim=emb_dim, shortcut_dims=encoder_dims,
            align_corners=align_corners)
        # kernel 17 / pad 8 when align_corners (aot.py:50-63)
        ks = 17 if align_corners else 16
        self.patch_wise_id_bank = Conv2d(
            max_obj_num + 1, emb_dim, ks, stride=16,
            padding=8 if align_corners else 0)

    @property
    def swin_window_reads(self) -> bool:
        """Whether the encoder makes Swin window reads (ops.attention.
        window_read), for which serving on a card loads the window kernel
        (ops.attention.load_serving_kernels)."""
        return isinstance(self.encoder, SwinTransformer)

    # --- hooks overridden by DeAOT ---
    def _make_lstt(self, lstt_num, emb_dim, self_heads, att_heads,
                   decoder_intermediate, **lstt_drop) -> nn.Module:
        return LongShortTermTransformer(
            lstt_num, emb_dim, self_heads, att_heads,
            intermediate_norm=decoder_intermediate, final_norm=True,
            **lstt_drop)

    def _decoder_indim(self, lstt_num: int, decoder_intermediate: bool):
        return self.emb_dim * (lstt_num + 1 if decoder_intermediate else 1)

    def _id_post(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def encode_image(self, img: torch.Tensor):
        """img: (B, 3, H, W) normalised. Returns 4 feature maps, the last
        projected to emb_dim (aot.py:81-84)."""
        xs = self.encoder(img.to(self.compute_dtype))
        xs[-1] = self.encoder_projector(xs[-1])
        return xs

    def get_id_emb(self, one_hot: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """one_hot: (B, M+1, H, W) -> (B, HW16, emb_dim) (aot.py:76-79)."""
        x = self._id_post(seq_from_2d(self.patch_wise_id_bank(
            one_hot.to(self.compute_dtype))))
        return dropout(x, self.id_dropout, generator)

    def get_id_emb_label(self, label: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """Identity embedding of an int label map (B, H, W)."""
        one_hot = F.one_hot(label.long(), self.max_obj_num + 1)
        return self.get_id_emb(one_hot.permute(0, 3, 1, 2).float(), generator)

    def get_pos_emb(self, size_2d: Tuple[int, int], device) -> torch.Tensor:
        return sine_position_embedding_seq(
            size_2d[0], size_2d[1], self.emb_dim,
            device=device).to(self.compute_dtype)

    def lstt_forward(self, emb16: torch.Tensor, lt_mems, st_mems,
                     curr_id_emb, pos_emb, size_2d: Tuple[int, int], *,
                     lt_valid_len=None, top_k: int = -1,
                     max_mem_len_ratio: float = -1.0,
                     generator: Optional[torch.Generator] = None):
        """emb16: (B, C, H16, W16) projected feature -> token sequence ->
        LSTT stack (aot.py:94-108), under the span `lstt`."""
        with span("lstt"):
            return self.LSTT(
                seq_from_2d(emb16), lt_mems, st_mems, curr_id_emb, pos_emb,
                size_2d, lt_valid_len=lt_valid_len, top_k=top_k,
                max_mem_len_ratio=max_mem_len_ratio, generator=generator)

    def decode_id_logits(self, lstt_intermediates, shortcuts) -> torch.Tensor:
        """(aot.py:86-92). Returns (B, M+1, H4, W4) fp32 logits, whatever
        the compute dtype (aot_tpu/models/decoders.py:59)."""
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
        self.id_norm = LayerNorm(self.emb_dim)

    def _make_lstt(self, lstt_num, emb_dim, self_heads, att_heads,
                   decoder_intermediate, **lstt_drop) -> nn.Module:
        return DualBranchGPM(lstt_num, emb_dim, self_heads, att_heads,
                             intermediate_norm=decoder_intermediate,
                             final_norm=True, **lstt_drop)

    def _decoder_indim(self, lstt_num: int, decoder_intermediate: bool):
        return self.emb_dim * (lstt_num * 2 + 1 if decoder_intermediate
                               else 2)

    def _id_post(self, x: torch.Tensor) -> torch.Tensor:
        return self.id_norm(x)


# --- seeded initialisation ---------------------------------------------------
# Follows the JAX package's init scheme (xavier-uniform transformer/decoder
# weights, torch-default uniform biases, the encoders' own scheme in
# `_init_encoder_`, orthogonal id bank, identity FrozenBN), drawn from an
# explicit generator.


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=g)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal(0, std) truncated at ±2 std, by inverting the CDF."""
    edge = math.erf(2 / math.sqrt(2))
    t.uniform_(-edge, edge, generator=g)
    t.erfinv_().mul_(std * math.sqrt(2))


def _kaiming_(w: torch.Tensor, fan: int, g: torch.Generator,
              gain: float = 2.0) -> None:
    """flax variance_scaling(gain, fan, 'truncated_normal'): the std is
    divided by the truncated normal's own std so the variance is gain/fan
    (gain 1 is lecun normal)."""
    _trunc_normal_(w, math.sqrt(gain / fan) / 0.87962566103423978, g)


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


def _zero_(b: Optional[torch.Tensor]) -> None:
    if b is not None:
        b.zero_()


def _init_encoder_(name: str, mod: nn.Module, swin: bool,
                   g: torch.Generator) -> None:
    """The JAX encoders' scheme: Swin's linears and patch embedding
    truncated normal 0.02 (aot_tpu swin.py:23); the dense gates (ResNeSt's
    fc1/fc2 1x1 convs, MobileNetV3's squeeze-excite) flax's lecun normal;
    every other conv kaiming fan-out; zero biases, unit LayerNorms."""
    if isinstance(mod, nn.LayerNorm):
        mod.weight.fill_(1.0)
        mod.bias.zero_()
        return
    if not isinstance(mod, (nn.Linear, nn.Conv2d)):
        return
    w = mod.weight
    if swin:
        _trunc_normal_(w, 0.02, g)
    elif isinstance(mod, nn.Linear) or name.endswith((".fc1", ".fc2")):
        _kaiming_(w, w[0].numel(), g, gain=1.0)
    else:                                                 # fan-out
        _kaiming_(w, w.shape[0] * w[0, 0].numel(), g)
    _zero_(mod.bias)


@torch.no_grad()
def init_weights(model: AOT, generator: torch.Generator) -> None:
    """Seeded initialisation of every parameter (the model must lie on the
    generator's device)."""
    g = generator
    swin = hasattr(model.encoder, "patch_embed")
    for name, mod in model.named_modules():
        if name.startswith("encoder."):
            _init_encoder_(name, mod, swin, g)
        elif isinstance(mod, nn.Linear):
            _xavier_(mod.weight, g)
            _bias_(mod.bias, mod.in_features, g)
        elif not isinstance(mod, nn.Conv2d):
            continue
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
        elif name.endswith("relative_position_bias_table"):   # Swin
            _trunc_normal_(p, 0.02, g)


def build_vos_model(cfg, device=None,
                    generator: Optional[torch.Generator] = None, *,
                    train: bool = False) -> AOT:
    """Construct the model from a Config (aot.py:328-353): AOT or DeAOT
    (`MODEL_VOS`) with any encoder of `MODEL_ENCODER` (MobileNetV2/V3,
    ResNet-50/101, ResNeSt-50/101/200/269, Swin-B), fp32 weights drawn from
    `generator` (seed 0 when None), on `device`: cuda:0 by default, which
    raises when there is no card (pass device='cpu' for the CPU).

    train=False: the serving model, in eval mode with gradients off,
    computing in TEST_DTYPE.
    train=True: the trainable model (AOT or DeAOT), computing in
    TRAIN_DTYPE, in train mode with gradients on. With MODEL_FREEZE_BN
    (every config's default) the FrozenBN statistics and affine stay
    buffers, as the JAX package stop_gradients them; with
    MODEL_FREEZE_BN=False the encoder's BNs are trainable, normalising by
    global-batch moments in train mode (encoders.common.
    TrainableBatchNorm2d). The serving model is always built frozen and
    loads either kind's state dict strictly (aot_tpu/models/aot.py:343-345).
    Its dropout and stochastic depth (TRAIN_LSTT_*, the same keys for
    both families, as aot_tpu/models/aot.py:336-353 passes them) act on a
    forward given a generator. Both dtypes are float32 or bfloat16."""
    device = resolve_device(device)
    classes = {"aot": AOT, "deaot": DeAOT}
    if cfg.MODEL_VOS not in classes:
        raise NotImplementedError(
            f"MODEL_VOS={cfg.MODEL_VOS!r}: aot_tpu_torch serves "
            f"{sorted(classes)}")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dtype_key = "TRAIN_DTYPE" if train else "TEST_DTYPE"
    if str(cfg.get(dtype_key)) not in dtypes:
        raise NotImplementedError(
            f"{dtype_key}={cfg.get(dtype_key)!r}: aot_tpu_torch "
            f"{'trains' if train else 'serves'} in {sorted(dtypes)}")
    drop = dict(id_dropout=cfg.TRAIN_LSTT_ID_DROPOUT,
                emb_dropout=cfg.TRAIN_LSTT_EMB_DROPOUT,
                droppath=cfg.TRAIN_LSTT_DROPPATH,
                lt_dropout=cfg.TRAIN_LSTT_LT_DROPOUT,
                st_dropout=cfg.TRAIN_LSTT_ST_DROPOUT,
                droppath_lst=cfg.TRAIN_LSTT_DROPPATH_LST,
                droppath_scaling=cfg.TRAIN_LSTT_DROPPATH_SCALING)
    model = classes[cfg.MODEL_VOS](
        encoder_name=cfg.MODEL_ENCODER,
        encoder_dims=tuple(cfg.MODEL_ENCODER_DIM),
        emb_dim=cfg.MODEL_ENCODER_EMBEDDING_DIM,
        max_obj_num=cfg.MODEL_MAX_OBJ_NUM,
        lstt_num=cfg.MODEL_LSTT_NUM,
        self_heads=cfg.MODEL_SELF_HEADS,
        att_heads=cfg.MODEL_ATT_HEADS,
        decoder_intermediate=cfg.MODEL_DECODER_INTERMEDIATE_LSTT,
        align_corners=cfg.MODEL_ALIGN_CORNERS,
        compute_dtype=dtypes[str(cfg.get(dtype_key))],
        frozen_bn=cfg.MODEL_FREEZE_BN or not train, **drop)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    model = model.to(device)
    if train:
        return model.requires_grad_(True).train()
    return model.requires_grad_(False).eval()
