"""Reference-named weights into the port (counterpart of
aot_tpu/utils/torch_import.py).

The port's module tree carries the reference PyTorch repo's module names,
so a reference-keyed state dict — a reference checkpoint, or
`aot_tpu.utils.torch_import.export_state_dict` of JAX parameters — loads
as it is, with no converter.

Keys a model holds, by module (MobileNetV2's encoder; the others below):
  both      encoder.* (260: convs and FrozenBN weight, bias, running_mean,
            running_var), encoder_projector.{weight,bias},
            patch_wise_id_bank.{weight,bias}, decoder.* (24: conv_in,
            conv_16x, conv_8x, conv_4x as .conv and .gn; adapter_16x,
            adapter_8x, adapter_4x, conv_out)
  AOT       LSTT.layers.{i}.* (32 a block: norm1-3, linear_Q, linear_V,
            self_attn.linear_{Q,K,V}, self_attn.projection,
            long_term_attn.projection, short_term_attn.relative_emb_k,
            short_term_attn.relative_emb_v, short_term_attn.projection,
            linear1, linear2, activation.gn, activation.conv),
            LSTT.decoder_norms.{j} (LayerNorm). AOTT: 322 keys.
  DeAOT     LSTT.layers.{i}.* (33 at block 0: norm1, norm2, id_norm2,
            linear_QV, linear_U, linear_ID_V,
            long_term_attn.{dw_conv.conv,projection},
            short_term_attn.{relative_emb_k,dw_conv.conv,projection},
            self_attn.linear_{QK,V1,V2,U1,U2},
            self_attn.{dw_conv.conv,projection}; 37 at later blocks, which
            add id_norm1 and linear_ID_U), LSTT.decoder_norms.{j}.gn
            (GroupNorm(2)), id_norm. DeAOTL: 399 keys.

The encoders' keys (torchvision's and the reference's module names):
  mobilenetv2  260  features.{0..18}: ConvBNReLU6 .0/.1, InvertedResidual
                    .conv.{j}
  resnet50     215  conv1, bn1, layer{1..3}.{b}.{conv1-3,bn1-3}, block 0's
  resnet101    470  downsample.{0,1}
  resnest50    329  conv1.{0,1,3,4,6} (deep stem), bn1,
  resnest101   720  layer{1..3}.{b}.{conv1,bn1,conv3,bn3},
  resnest200  1479  conv2.{conv,bn0,fc1,bn1,fc2} (split attention; fc1/fc2
  resnest269  1893  1x1 convs with bias), block 0's downsample.{1,2}
  swin_base    302  patch_embed.{proj,norm}, layers.{i}.blocks.{j}.{norm1,
                    attn.{relative_position_bias_table,qkv,proj}, norm2,
                    mlp.{fc1,fc2}}, layers.{0,1}.downsample.{norm,reduction},
                    norm{0,1,2}; relative_position_index and the shift mask
                    are recomputed, not stored
  mobilenetv3  262  features.0.{0,1}, features.{1..15}.conv.{j} (squeeze-
                    excite .fc.{0,2}), conv.{0,1}

Trainable BN (MODEL_FREEZE_BN=False) has the same four keys a BN: weight
and bias are parameters, running_mean and running_var buffers. aot_tpu
keeps the running stats of such a model in a `batch_stats` tree beside
its params, under the same module paths (aot_tpu/models/encoders/
common.py:60-64). To carry them across, merge the batch_stats tree into
the params tree leaf by leaf, as aot_tpu/utils/checkpoint.py:103-108 does
(the paths are disjoint: weight/bias against running_mean/running_var),
export the merged tree with aot_tpu.utils.torch_import.export_state_dict,
and load the result strictly with load_reference_state_dict, into a
trainable-BN or a frozen model alike (tests/test_torch_port_syncbn.py).

Keys of the 14 variants (configs/models.py; tests/test_torch_port_variants.py):
  AOTT 322, AOTS 356, AOTB 390, AOTL 390, R50_AOTL 345, R101_AOTL 600,
  RS101_AOTL 850, SwinB_AOTL 432, DeAOTT 325, DeAOTS 362, DeAOTB 399,
  DeAOTL 399, R50_DeAOTL 354, SwinB_DeAOTL 441.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module,
                              sd: Mapping[str, np.ndarray]) -> None:
    """Load `sd` (reference key -> array) into `model` on its device with
    strict=True; raises RuntimeError on any missing, unexpected or
    mis-shaped key."""
    device = next(model.parameters()).device
    tensors = {k: torch.tensor(np.asarray(v), device=device)
               for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)


def load_weights_file(model: nn.Module, path: str) -> None:
    """Load the weights of a .pth into `model` strictly: a checkpoint of
    the port's trainer (its raw stream {'model': ...} or its EMA stream
    {'state_dict': ...}), or a reference-keyed state dict as it is or under
    'state_dict'. 'module.' is removed wherever it stands in a key, as
    aot_tpu/utils/torch_import.py:73 removes it (DistributedDataParallel
    prefixes every key with it). Unlike aot_tpu's
    load_torch_pretrained, which keeps the parameters a file lacks at their
    init, any missing, unexpected or mis-shaped key raises."""
    from aot_tpu_torch.utils import checkpoint as ckpt_lib

    blob = ckpt_lib.load_checkpoint(path, "cpu")
    sd = blob.get("state_dict", blob.get("model", blob))
    load_reference_state_dict(
        model, {k.replace("module.", ""): v for k, v in sd.items()})


def load_model(cfg, path: Optional[str], device) -> nn.Module:
    """The serving model of `cfg` on `device` with the weights of `path`:
    'test' for seeded random weights, else a .pth that load_weights_file
    loads strictly (the eval CLI's and the demo's loader). The model is
    always built with frozen BN (aot_tpu/models/aot.py:343-345); a
    checkpoint of a trainable-BN run has the same keys (its BN weight,
    bias and running stats) and loads into it strictly."""
    from aot_tpu_torch.models import build_vos_model

    model = build_vos_model(cfg, device=device)
    if path == "test":
        print("[eval] ckpt-less smoke mode: random weights", flush=True)
        return model
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: aot_tpu_torch loads .pth state dicts")
    load_weights_file(model, path)
    print(f"[eval] loaded {path}", flush=True)
    return model
