"""Model variant registry.

Hyperparameters reproduce the reference's model configs
(reference: configs/models/*.py — 15 variants) as data, not classes.
"""

from typing import Any, Dict

# Base model defaults (reference: configs/models/default.py)
_AOT_DEFAULT: Dict[str, Any] = dict(
    MODEL_NAME="AOTDefault",
    MODEL_VOS="aot",
    MODEL_ENGINE="aotengine",
    MODEL_ALIGN_CORNERS=True,
    MODEL_ENCODER="mobilenetv2",
    MODEL_ENCODER_PRETRAIN="./pretrain_models/mobilenet_v2.pth",
    MODEL_ENCODER_DIM=[24, 32, 96, 1280],  # 4x, 8x, 16x, 16x
    MODEL_ENCODER_EMBEDDING_DIM=256,
    MODEL_DECODER_INTERMEDIATE_LSTT=True,
    MODEL_FREEZE_BN=True,
    MODEL_FREEZE_BACKBONE=False,
    MODEL_MAX_OBJ_NUM=10,
    MODEL_SELF_HEADS=8,
    MODEL_ATT_HEADS=8,
    MODEL_LSTT_NUM=1,
    MODEL_EPSILON=1e-5,
    MODEL_USE_PREV_PROB=False,
    TRAIN_LONG_TERM_MEM_GAP=9999,
    TRAIN_AUG_TYPE="v1",
    TEST_LONG_TERM_MEM_GAP=9999,
    TEST_SHORT_TERM_MEM_SKIP=1,
)

# DeAOT base (reference: configs/models/default_deaot.py)
_DEAOT_DEFAULT: Dict[str, Any] = dict(
    _AOT_DEFAULT,
    MODEL_NAME="DeAOTDefault",
    MODEL_VOS="deaot",
    MODEL_ENGINE="deaotengine",
    MODEL_DECODER_INTERMEDIATE_LSTT=False,
    MODEL_SELF_HEADS=1,
    MODEL_ATT_HEADS=1,
    TRAIN_AUG_TYPE="v2",
)

_R50 = dict(
    MODEL_ENCODER="resnet50",
    MODEL_ENCODER_PRETRAIN="./pretrain_models/resnet50.pth",
    MODEL_ENCODER_DIM=[256, 512, 1024, 1024],
)
_R101 = dict(
    MODEL_ENCODER="resnet101",
    MODEL_ENCODER_PRETRAIN="./pretrain_models/resnet101.pth",
    MODEL_ENCODER_DIM=[256, 512, 1024, 1024],
)
_RS101 = dict(
    MODEL_ENCODER="resnest101",
    MODEL_ENCODER_PRETRAIN="./pretrain_models/resnest101.pth",
    MODEL_ENCODER_DIM=[256, 512, 1024, 1024],
)
_SWINB = dict(
    MODEL_ENCODER="swin_base",
    MODEL_ENCODER_PRETRAIN="./pretrain_models/swin_base_patch4_window7_224_22k.pth",
    MODEL_ALIGN_CORNERS=False,
    MODEL_ENCODER_DIM=[128, 256, 512, 512],
)
# -L variants store memory every `gap` frames (reference: configs/models/aotl.py)
_LONG_MEM = dict(TRAIN_LONG_TERM_MEM_GAP=2, TEST_LONG_TERM_MEM_GAP=5)


def _variant(base: Dict[str, Any], name: str, **over: Any) -> Dict[str, Any]:
    d = dict(base)
    d.update(over)
    d["MODEL_NAME"] = name
    return d


MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    # AOT family (reference: configs/models/aot{t,s,b,l}.py)
    "aott": _variant(_AOT_DEFAULT, "AOTT"),
    "aots": _variant(_AOT_DEFAULT, "AOTS", MODEL_LSTT_NUM=2),
    "aotb": _variant(_AOT_DEFAULT, "AOTB", MODEL_LSTT_NUM=3),
    "aotl": _variant(_AOT_DEFAULT, "AOTL", MODEL_LSTT_NUM=3, **_LONG_MEM),
    "r50_aotl": _variant(_AOT_DEFAULT, "R50_AOTL", MODEL_LSTT_NUM=3, **_R50, **_LONG_MEM),
    "r101_aotl": _variant(_AOT_DEFAULT, "R101_AOTL", MODEL_LSTT_NUM=3, **_R101, **_LONG_MEM),
    "rs101_aotl": _variant(_AOT_DEFAULT, "RS101_AOTL", MODEL_LSTT_NUM=3, **_RS101, **_LONG_MEM),
    "swinb_aotl": _variant(_AOT_DEFAULT, "SwinB_AOTL", MODEL_LSTT_NUM=3, **_SWINB, **_LONG_MEM),
    # DeAOT family (reference: configs/models/deaot{t,s,b,l}.py)
    "deaott": _variant(_DEAOT_DEFAULT, "DeAOTT"),
    "deaots": _variant(_DEAOT_DEFAULT, "DeAOTS", MODEL_LSTT_NUM=2),
    "deaotb": _variant(_DEAOT_DEFAULT, "DeAOTB", MODEL_LSTT_NUM=3),
    "deaotl": _variant(_DEAOT_DEFAULT, "DeAOTL", MODEL_LSTT_NUM=3, **_LONG_MEM),
    "r50_deaotl": _variant(_DEAOT_DEFAULT, "R50_DeAOTL", MODEL_LSTT_NUM=3, **_R50, **_LONG_MEM),
    "swinb_deaotl": _variant(_DEAOT_DEFAULT, "SwinB_DeAOTL", MODEL_LSTT_NUM=3, **_SWINB, **_LONG_MEM),
    # defaults exposed by name too
    "default": dict(_AOT_DEFAULT),
    "default_deaot": dict(_DEAOT_DEFAULT),
}
