"""Training observability (port of aot_tpu/utils/logging.py).

The reference logs scalars/images to tensorboardX behind TRAIN_TBLOG
(trainer.py:132-134, 655-684). Here: a dependency-free JSONL metrics stream
(one object per log step) + optional TensorBoard if the package exists, and
per-step prediction image dumps (reference DIR_IMG_LOG, trainer.py:622-653),
and ProfilerHook, a torch.profiler trace around any stretch of a run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, tb: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if tb:
            try:
                from torch.utils.tensorboard import SummaryWriter  # optional

                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def save_pred_image_log(log_dir: str, step: int, frame: np.ndarray,
                        gt: np.ndarray, pred: np.ndarray) -> None:
    """JPEG dump of (image | gt overlay | pred overlay)
    (reference: trainer.py:622-653)."""
    from PIL import Image

    from aot_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
    from aot_tpu_torch.utils.image import label2colormap, masked_image

    os.makedirs(log_dir, exist_ok=True)
    if frame.dtype == np.uint8:  # raw-uint8 training pipeline
        img = frame.astype(np.float32) / 255.0
    else:
        img = frame * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)
    img = np.clip(img, 0, 1)
    panels = [img]
    for mask in (gt, pred):
        cm = label2colormap(mask).astype(np.float32) / 255.0
        panels.append(masked_image(img, cm, mask))
    strip = (np.concatenate(panels, axis=1) * 255).astype(np.uint8)
    Image.fromarray(strip).save(os.path.join(log_dir, f"step_{step}.jpg"),
                                quality=85)


class ProfilerHook:
    """torch.profiler trace capture (the counterpart of aot_tpu/utils/
    logging.py's ProfilerHook, which records jax.profiler traces): host
    activity, plus the card's kernels and copies when torch sees a card.
    `start` creates `trace_dir` and starts recording; `stop` writes the
    recording there as a Chrome trace (chrome://tracing, Perfetto) and
    returns its path. `stop` without a running trace does nothing and
    returns None."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self):
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self.trace_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path
