"""Backbone encoders. Each returns [x4, x8, x16, x16] NCHW feature maps
(port of aot_tpu/models/encoders/__init__.py)."""

from torch import nn

from aot_tpu_torch.models.encoders.mobilenetv2 import MobileNetV2
from aot_tpu_torch.models.encoders.mobilenetv3 import MobileNetV3Large
from aot_tpu_torch.models.encoders.resnest import ResNeSt
from aot_tpu_torch.models.encoders.resnet import ResNet50, ResNet101
from aot_tpu_torch.models.encoders.swin import SwinTransformer


def build_encoder(name: str) -> nn.Module:
    if name == "mobilenetv2":
        return MobileNetV2()
    if name == "resnet50":
        return ResNet50()
    if name == "resnet101":
        return ResNet101()
    if "swin" in name:
        return SwinTransformer()
    if name == "mobilenetv3":
        return MobileNetV3Large()
    if name.startswith("resnest"):
        return ResNeSt.named(name)
    raise NotImplementedError(name)


def _stages(name: str):
    """[stem, stage 1, stage 2, ...] as lists of module-name prefixes."""
    if name == "mobilenetv2":
        feats = [range(0, 1), range(1, 4), range(4, 7), range(7, 14),
                 range(14, 19)]
    elif name == "mobilenetv3":
        feats = [range(0, 1), range(1, 4), range(4, 7), range(7, 13),
                 range(13, 16)]
    elif name.startswith(("resnet", "resnest")):
        return [["encoder.conv1.", "encoder.bn1."]] + [
            [f"encoder.layer{i}."] for i in range(1, 4)]
    elif "swin" in name:
        return [["encoder.patch_embed."]] + [
            [f"encoder.layers.{i}."] for i in range(3)]
    else:
        return None
    stages = [[f"encoder.features.{i}." for i in rng] for rng in feats]
    if name == "mobilenetv3":
        stages[-1].append("encoder.conv.")
    return stages


def frozen_param_patterns(name: str, freeze_at: int):
    """Parameter-name prefixes the optimizer freezes for `freeze_at`
    (aot_tpu/models/encoders/__init__.py:37, on the port's names): 1 the
    stem, n >= 2 the stem and the first n - 1 stages. Every prefix ends in
    '.', so features.1 does not catch features.10-18."""
    stages = _stages(name)
    if freeze_at < 1 or stages is None:
        return []
    return [p for idx, stage in enumerate(stages) if idx == 0 or
            freeze_at >= idx + 1 for p in stage]
