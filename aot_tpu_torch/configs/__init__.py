"""Config system: the port's own copy of the JAX package's registry
(aot_tpu/configs/), with only its import paths changed, so that callers of
the port import only aot_tpu_torch.

    cfg = build_config(stage='pre_ytb_dav', model='aott', exp_name='aot')
    cfg.MODEL_LSTT_NUM   # -> 1
"""

from aot_tpu_torch.configs.config import Config, build_config, build_model_config
from aot_tpu_torch.configs.models import MODEL_REGISTRY
from aot_tpu_torch.configs.stages import STAGE_REGISTRY

__all__ = [
    "Config",
    "build_config",
    "build_model_config",
    "MODEL_REGISTRY",
    "STAGE_REGISTRY",
]
