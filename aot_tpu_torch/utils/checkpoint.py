"""Training checkpoints (port of aot_tpu/utils/checkpoint.py).

Files are `save_step_{N}.pth`, written with torch.save (to a temporary name,
then renamed, so a reader never sees half a file); at most `max_keep` are
kept per directory, the newest. The trainer writes two streams: the raw
training state (model, optimizer, EMA, step) under DIR_CKPT and the EMA
model state dict under DIR_EMA_CKPT; a write that fails with an OSError
goes to a backup directory (the trainer's ./backup/{EXP_NAME}/
{STAGE_NAME}/{ckpt,ema_ckpt}).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, List, Optional

import torch


def _step_of(path: str) -> int:
    m = re.search(r"save_step_(\d+)\.pth$", path)
    return int(m.group(1)) if m else -1


def list_checkpoints(ckpt_dir: str) -> List[str]:
    """The checkpoints in `ckpt_dir`, oldest first."""
    paths = glob.glob(os.path.join(ckpt_dir, "save_step_*.pth"))
    return sorted((p for p in paths if _step_of(p) >= 0), key=_step_of)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = list_checkpoints(ckpt_dir)
    return paths[-1] if paths else None


def save_checkpoint(ckpt_dir: str, step: int, obj: Any,
                    max_keep: int = 8,
                    backup_dir: Optional[str] = None) -> str:
    """Write save_step_{step}.pth and delete all but the newest
    `max_keep` of its directory; on an OSError, write to `backup_dir`
    instead when one is given (reference: utils/checkpoint.py:124-160;
    aot_tpu/utils/checkpoint.py:50-70). Returns the path."""
    try:
        path = _write(ckpt_dir, step, obj)
    except OSError:
        if backup_dir is None:
            raise
        path = _write(backup_dir, step, obj)
    for old in list_checkpoints(os.path.dirname(path))[:-max_keep]:
        try:
            os.remove(old)
        except OSError:
            pass
    return path


def _write(ckpt_dir: str, step: int, obj: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"save_step_{step}.pth")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:     # a failed write raises OSError
        torch.save(obj, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu") -> Any:
    """A checkpoint this package wrote (weights_only: tensors, numbers,
    strings and containers)."""
    return torch.load(path, map_location=device, weights_only=True)
