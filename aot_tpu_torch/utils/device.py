"""The device an entry point of the port runs on: the card unless the
caller asks for another. There is no silent fallback to the CPU: a run
that was meant for the card and found none fails at once."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda:0"


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """`device`, or cuda:0 when None. Raises if a CUDA device is asked for
    (by default or by name) and torch sees no card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {dev}: aot_tpu_torch runs on the card by "
            "default; pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
