"""Training-stage registry.

Reproduces the reference's stage configs (reference: configs/{pre,ytb,
pre_ytb,pre_dav,pre_ytb_dav}.py) as override dicts. Entries may be callables
receiving the partially-built Config (for stage-chained pretrain paths).
"""

import os
from typing import Any, Callable, Dict, Union

StageOverrides = Union[Dict[str, Any], Callable[["object"], Dict[str, Any]]]


def _chained_pretrain(cfg) -> str:
    """PRE stage's EMA checkpoint seeds the later stages
    (reference: configs/pre_ytb_dav.py:12-19 — hardcodes PRE's
    save_step_100000.pth; we point at the ema_ckpt DIRECTORY and the
    trainer resolves it to the latest checkpoint, so shorter PRE runs
    chain correctly too)."""
    return os.path.join(
        cfg.DIR_ROOT, "result", cfg.EXP_NAME, "PRE", "ema_ckpt")


def _pre(cfg) -> Dict[str, Any]:
    return dict(
        STAGE_NAME="PRE",
        DATASETS=["static"],
        DATA_DYNAMIC_MERGE_PROB=1.0,
        TRAIN_LR=4e-4,
        TRAIN_LR_MIN=2e-5,
        TRAIN_WEIGHT_DECAY=0.03,
        TRAIN_SEQ_TRAINING_START_RATIO=1.0,
        TRAIN_AUX_LOSS_RATIO=0.1,
    )


def _ytb(cfg) -> Dict[str, Any]:
    return dict(STAGE_NAME="YTB")


def _pre_ytb(cfg) -> Dict[str, Any]:
    return dict(
        STAGE_NAME="PRE_YTB",
        PRETRAIN_FULL=True,
        PRETRAIN_MODEL=_chained_pretrain(cfg),
    )


def _pre_dav(cfg) -> Dict[str, Any]:
    return dict(
        STAGE_NAME="PRE_DAV",
        DATASETS=["davis2017"],
        TRAIN_TOTAL_STEPS=50_000,
        PRETRAIN_FULL=True,
        PRETRAIN_MODEL=_chained_pretrain(cfg),
    )


def _pre_ytb_dav(cfg) -> Dict[str, Any]:
    return dict(
        STAGE_NAME="PRE_YTB_DAV",
        DATASETS=["youtubevos", "davis2017"],
        PRETRAIN_FULL=True,
        PRETRAIN_MODEL=_chained_pretrain(cfg),
    )


STAGE_REGISTRY: Dict[str, StageOverrides] = {
    "pre": _pre,
    "ytb": _ytb,
    "pre_ytb": _pre_ytb,
    "pre_dav": _pre_dav,
    "pre_ytb_dav": _pre_ytb_dav,
    "default": _ytb,
}
