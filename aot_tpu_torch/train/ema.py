"""Exponential moving average of the parameters (port of
aot_tpu/train/ema.py; reference: utils/ema.py).

decay = min(d, (1 + n) / (10 + n)) at the n-th update, with
d = 1 - 1 / (TRAIN_TOTAL_STEPS * TRAIN_EMA_RATIO) (reference
trainer.py:92-97). The shadow covers the parameters; `state_dict` gives a
full model state dict with the shadow in their place and the model's own
buffers beside it: the BN statistics, fixed with frozen BN and the current
running stats with trainable BN, as aot_tpu's EMA stream carries
batch_stats (aot_tpu/train/trainer.py:234-241).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def ema_decay_for(cfg) -> float:
    return 1.0 - 1.0 / (cfg.TRAIN_TOTAL_STEPS * cfg.TRAIN_EMA_RATIO)


class EMA:
    def __init__(self, model: nn.Module, decay: float):
        self.decay = decay
        self.num_updates = 0
        self.shadow: Dict[str, torch.Tensor] = {
            n: p.detach().clone() for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.num_updates += 1
        n = self.num_updates
        one_minus = 1.0 - min(self.decay, (1.0 + n) / (10.0 + n))
        for name, p in model.named_parameters():
            s = self.shadow[name]
            s.sub_(one_minus * (s - p))

    def state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's state dict with the shadow parameters."""
        sd = model.state_dict()
        sd.update({n: s.clone() for n, s in self.shadow.items()})
        return sd

    @torch.no_grad()
    def load_shadow(self, sd: Dict[str, torch.Tensor], num_updates: int) -> None:
        for name, s in self.shadow.items():
            s.copy_(sd[name])
        self.num_updates = num_updates
