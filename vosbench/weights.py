"""Seeded weights, made on the run's device in one draw.

The published weights are not in the repository, and random weights serve
both speed and the comparison with the reference. One `torch.randn` over
every parameter and buffer of the model, from a generator on the device,
is cut into tensors by name and scaled in place:

- matrices and kernels: normal with variance 1 / fan-in (so the residual
  encoders' maps stay of order one, and the blocks' reads of the memory
  move the logits as much as the frame does);
- running variances: 1 + 0.1 |n|; running means 0.1 n;
- every other vector named `weight` (norm scales): 1 + 0.1 n; biases and
  the relative value biases: 0.05 n.

The program and the reference are both handed the tensors made here.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def make_weights(layout: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> tensor of `layout`'s shape, fp32, on `device`, from `seed`."""
    total = sum(math.prod(s) for s in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in layout.items():
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) >= 2 and not name.endswith("relative_emb_v"):
            t.mul_(math.sqrt(1.0 / math.prod(shape[1:])))
        elif name.endswith("running_var"):
            t.abs_().mul_(0.1).add_(1.0)
        elif name.endswith("running_mean"):
            t.mul_(0.1)
        elif name.endswith("weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.05)
        out[name] = t
    return out
