"""Optimizer with the reference's per-parameter-group semantics (port of
aot_tpu/train/optim.py; reference: utils/learning.py).

One update, as the JAX package's: clip all gradients by their global norm,
Adam moments (b1 0.9, b2 0.999, eps 1e-8), then p += -lr (u + wd p) with a
per-parameter lr and weight decay. The learning rate comes from the count
of updates before this one. Groups are read off the port's parameter names
(the reference names; aot_tpu's flax paths in brackets):
  - frozen: the encoder stages below TRAIN_ENCODER_FREEZE_AT (prefixes from
    models.encoders.frozen_param_patterns), or the whole encoder with
    MODEL_FREEZE_BACKBONE. Their gradients are computed and count in the
    clipping norm, and their update is zero — the JAX package's rule. (The
    reference PyTorch repo sets requires_grad=False on them instead, so its
    norm leaves them out; ROADMAP.md, Queue 3.) FrozenBN statistics and
    affine are buffers, outside the optimizer.
  - encoder ("encoder." [encoder/]): lr = (now_lr - min_lr) * ratio + min_lr.
  - seq_freeze (TRAIN_SEQ_TRAINING_FREEZE_PARAMS, the id bank): lr and wd 0
    from TRAIN_SEQ_TRAINING_START_RATIO on.
  - weight decay: 0 for one-dimensional parameters and for name-matched
    exemptions. The dimension is the JAX leaf's: relative_emb_k.bias is
    (h * win2,) here and (h, win2) there [relative_emb_k_b], so it decays,
    as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from aot_tpu_torch.models.encoders import frozen_param_patterns


def poly_warmup_lr(cfg) -> Callable[[float], float]:
    """now_lr(step) (aot_tpu/train/optim.py:30; reference learning.py:4-38)."""
    base, min_lr = cfg.TRAIN_LR, cfg.TRAIN_LR_MIN
    power, total = cfg.TRAIN_LR_POWER, cfg.TRAIN_TOTAL_STEPS
    restart = max(1, cfg.TRAIN_LR_RESTART)
    warm = cfg.TRAIN_LR_WARM_UP_RATIO * total
    cosine = cfg.TRAIN_LR_COSINE_DECAY

    def schedule(step: float) -> float:
        step = float(step)
        if restart > 1:
            each = math.ceil(total / restart)
            step = step % each
            w, m = warm / restart, each
        else:
            w, m = warm, total
        if step < w:
            return min_lr + (base - min_lr) * step / w
        s2, m2 = step - w, m - w
        if cosine:
            return min_lr + (base - min_lr) * (
                math.cos(math.pi * s2 / (m2 + 1)) + 1.0) * 0.5
        return min_lr + (base - min_lr) * (1.0 - s2 / (m2 + 1)) ** power

    return schedule


# JAX leaf dimensions that differ from the port's parameter shapes
_JAX_NDIM = {"relative_emb_k.bias": 2}


def build_param_groups(cfg, named_params: Sequence[Tuple[str, torch.Tensor]]
                       ) -> Dict[str, Dict[str, object]]:
    """name -> {wd, encoder, frozen, seq_freeze} for each parameter
    (aot_tpu/train/optim.py:65)."""
    frozen_prefixes = frozen_param_patterns(cfg.MODEL_ENCODER,
                                            cfg.TRAIN_ENCODER_FREEZE_AT)
    if cfg.MODEL_FREEZE_BACKBONE:
        frozen_prefixes = ["encoder."]
    no_wd_keys = list(cfg.TRAIN_WEIGHT_DECAY_EXEMPTION)
    exclusive = dict(cfg.TRAIN_WEIGHT_DECAY_EXCLUSIVE)
    seq_freeze_keys = list(cfg.TRAIN_SEQ_TRAINING_FREEZE_PARAMS)

    groups = {}
    for name, p in named_params:
        suffix = name.rsplit(".", 2)
        ndim = _JAX_NDIM.get(".".join(suffix[-2:]), p.ndim)
        is_bias = name.endswith(".bias") and ndim <= 1
        encoder = name.startswith("encoder.")
        wd = cfg.TRAIN_WEIGHT_DECAY
        for key, val in exclusive.items():
            if key in name:
                wd = val
                break
        if ndim <= 1:
            # biases never decay; other 1-dim parameters decay only inside
            # the encoder with frozen BN (reference learning.py:69-80)
            if is_bias or not cfg.MODEL_FREEZE_BN or not encoder:
                wd = 0.0
        elif any(key in name for key in no_wd_keys):
            wd = 0.0
        groups[name] = {
            "wd": float(wd),
            "encoder": encoder,
            "frozen": any(name.startswith(fp) for fp in frozen_prefixes),
            "seq_freeze": any(key in name for key in seq_freeze_keys),
        }
    return groups


class VOSOptimizer:
    """Clip-by-global-norm -> Adam moments -> per-group AdamW update, over
    every parameter of `model` that requires grad (frozen ones included)."""

    def __init__(self, cfg, model: nn.Module):
        if cfg.TRAIN_OPT != "adamw":
            raise NotImplementedError(
                f"TRAIN_OPT={cfg.TRAIN_OPT!r}: the port has adamw only")
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.groups = build_param_groups(cfg, named)
        self.schedule = poly_warmup_lr(cfg)
        self.min_lr = cfg.TRAIN_LR_MIN
        self.enc_ratio = cfg.TRAIN_LR_ENCODER_RATIO
        self.seq_start = (cfg.TRAIN_SEQ_TRAINING_START_RATIO
                          * cfg.TRAIN_TOTAL_STEPS)
        self.max_norm = float(cfg.TRAIN_CLIP_GRAD_NORM)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_of(self, name: str, step: float) -> Tuple[float, float]:
        """(lr, wd) of a parameter at `step`; (0, 0) for a frozen one."""
        meta = self.groups[name]
        if meta["frozen"]:
            return 0.0, 0.0
        now = self.schedule(step)
        lr = (now - self.min_lr) * self.enc_ratio + self.min_lr \
            if meta["encoder"] else now
        if meta["seq_freeze"] and step >= self.seq_start:
            return 0.0, 0.0
        return lr, meta["wd"]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' .grad (None counts as 0);
        returns the global norm of the raw gradients (a 0-dim tensor)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # optax.clip_by_global_norm: g / norm * max_norm once norm >= max
        clip = torch.where(norm < self.max_norm, torch.ones_like(norm),
                           self.max_norm / norm)
        step = float(self.count)
        n = self.count + 1
        c1, c2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        for name, p, g, mu, nu in zip(self.names, self.params, grads,
                                      self.mu, self.nu):
            g = g * clip
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            lr, wd = self.lr_of(name, step)
            if lr == 0.0:
                continue
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            p.add_(u + wd * p, alpha=-lr)
        self.count = n
        return norm

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.count = int(sd["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(sd["mu"][name])
            nu.copy_(sd["nu"][name])
