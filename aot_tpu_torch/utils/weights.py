"""Reference-named weights into the port (counterpart of
aot_tpu/utils/torch_import.py).

The port's module tree carries the reference PyTorch repo's module names,
so a reference-keyed state dict — a reference checkpoint, or
`aot_tpu.utils.torch_import.export_state_dict` of JAX parameters — loads
as it is, with no converter.

Keys a MobileNetV2 model holds, by module:
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
"""

from __future__ import annotations

from typing import Mapping

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
