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
