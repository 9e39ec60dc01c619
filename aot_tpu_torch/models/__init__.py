"""Models: the MobileNetV2 encoder, the FPN decoder, the LSTT stack, AOT."""

from aot_tpu_torch.models.aot import AOT, build_vos_model

__all__ = ["AOT", "build_vos_model"]
