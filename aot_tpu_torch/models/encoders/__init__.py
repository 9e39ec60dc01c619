"""Backbone encoders. Each returns [x4, x8, x16, x16] NCHW feature maps
(port of aot_tpu/models/encoders/__init__.py)."""

from torch import nn

from aot_tpu_torch.models.encoders.mobilenetv2 import MobileNetV2


def build_encoder(name: str) -> nn.Module:
    if name == "mobilenetv2":
        return MobileNetV2()
    raise NotImplementedError(
        f"encoder {name!r} is not ported yet; aot_tpu_torch has mobilenetv2 "
        "only (ROADMAP.md, Queue 1 lists the remaining encoders)")


def frozen_param_patterns(name: str, freeze_at: int):
    """Parameter-name prefixes the optimizer freezes for `freeze_at`
    (aot_tpu/models/encoders/__init__.py:37, on the port's names): 1 the
    stem, n >= 2 the stem and the first n - 1 stages. Every prefix ends in
    '.', so features.1 does not catch features.10-18."""
    if freeze_at < 1:
        return []
    if name != "mobilenetv2":
        raise NotImplementedError(f"encoder {name!r} is not ported yet")
    stages = [range(0, 1), range(0, 4), range(4, 7), range(7, 14),
              range(14, 19)]
    out = []
    for idx, feats in enumerate(stages):
        if idx == 0 or freeze_at >= idx + 1:
            out += [f"encoder.features.{i}." for i in feats]
    return list(dict.fromkeys(out))
