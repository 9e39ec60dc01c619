"""The training step: loss -> backward -> clipped AdamW -> EMA (port of
aot_tpu/train/step.py:47-95), on one device.

The whole step — the forward and the backward, whose per-frame recompute
re-runs the forward — runs inside `attn_training_context`, so every global
attention takes the differentiable flash path and local attention the
window form (ops/attention.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from aot_tpu_torch.engine.train import TrainEngine
from aot_tpu_torch.ops.attention import attn_training_context
from aot_tpu_torch.ops.image import generate_permute_matrix
from aot_tpu_torch.train.ema import EMA, ema_decay_for
from aot_tpu_torch.train.optim import VOSOptimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: VOSOptimizer
    ema: Optional[EMA]
    step: int = 0

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": None if self.ema is None else self.ema.shadow,
                "ema_updates": 0 if self.ema is None else self.ema.num_updates}

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None and sd["ema"] is not None:
            self.ema.load_shadow(sd["ema"], int(sd["ema_updates"]))
        self.step = int(sd["step"])


def create_train_state(cfg, model: nn.Module,
                       with_ema: bool = True) -> TrainState:
    return TrainState(model=model, optimizer=VOSOptimizer(cfg, model),
                      ema=EMA(model, ema_decay_for(cfg)) if with_ema else None)


def make_train_step(cfg, engine: TrainEngine, enable_id_shuffle: bool = True):
    """Returns train_step(state, frames, masks, obj_nums, generator,
    use_prev_pred) -> stats, which updates `state` in place. frames
    (T, B, H, W, 3), masks (T, B, H, W), obj_nums (B,) on the model's
    device; `generator`, a CPU torch.Generator, draws the id shuffle and the
    seed of the step's dropout."""
    max_obj = cfg.MODEL_MAX_OBJ_NUM
    # (reference: trainer.py:296-298)
    enable_prev_frame = (cfg.TRAIN_ENABLE_PREV_FRAME
                         and "static" not in cfg.DATASETS)

    def train_step(state: TrainState, frames, masks, obj_nums,
                   generator: torch.Generator,
                   use_prev_pred: bool) -> Dict[str, torch.Tensor]:
        b = frames.shape[1]
        shuffle = None
        if enable_id_shuffle:
            shuffle = generate_permute_matrix(max_obj + 1, b, generator
                                              ).to(frames.device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        state.model.zero_grad(set_to_none=True)
        with attn_training_context():
            loss, stats = engine.forward(
                frames, masks, obj_nums, float(state.step),
                shuffle_matrix=shuffle, use_prev_pred=use_prev_pred,
                enable_prev_frame=enable_prev_frame, seed=seed)
            loss.backward()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["grad_norm"] = state.optimizer.step()
        if state.ema is not None:
            state.ema.update(state.model)
        state.step += 1
        return stats

    return train_step
