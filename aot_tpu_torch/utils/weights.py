"""Reference-named weights into the port (counterpart of
aot_tpu/utils/torch_import.py).

The port's module tree carries the reference PyTorch repo's module names,
so a reference-keyed state dict — a reference checkpoint, or
`aot_tpu.utils.torch_import.export_state_dict` of JAX parameters — loads
as it is, with no converter.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module,
                              sd: Mapping[str, np.ndarray]) -> None:
    """Load `sd` (reference key -> array) into `model` on its device with
    strict=True; raises RuntimeError on any missing, unexpected or
    mis-shaped key."""
    device = next(model.parameters()).device
    tensors = {k: torch.tensor(np.asarray(v), device=device)
               for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)
