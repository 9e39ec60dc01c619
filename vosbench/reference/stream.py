"""The memory of one video in the reference: every frame's entries kept as
tokens concatenated per layer, as the published engine keeps its lists
(networks/engines/aot_engine.py:188-338, deaot_engine.py:20-45).

- The reference frame seeds the long-term (LT) and the short-term (ST)
  memory with its own entries, fused with the given mask's identity.
- Each later frame reads both, and is then written with a mask's identity:
  always into the ST memory (the previous frame), and into the LT memory
  when `lt_gap` frames have passed since the last LT write.
- `lt_policy`: 'grow' keeps every LT frame (the published engine);
  'fifo' keeps at most `lt_cap` frames, the reference frame always and the
  newest others.

The masks written are given by the caller: the reference follows the
masks that the program served (teacher forcing), so that every frame it
judges reads the memory the program's own masks made.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .model import Model


class Stream:
    def __init__(self, model: Model, lt_gap: int, lt_policy: str = "grow",
                 lt_cap: int = 0):
        if lt_policy not in ("grow", "fifo"):
            raise ValueError(f"lt_policy {lt_policy!r}: 'grow' or 'fifo'")
        self.model = model
        self.lt_gap = lt_gap
        self.lt_policy = lt_policy
        self.lt_cap = lt_cap
        self.lt: List[Dict[str, torch.Tensor]] = []
        self.st: List[Dict[str, torch.Tensor]] = []
        self.lt_frames = 0
        self.step = 0
        self.last_write = 0
        self.obj_num = 0
        self._currs: Optional[list] = None

    def _fused(self, currs, mask):
        id_emb = self.model.id_emb(mask)
        return [self.model.fuse(i, c, id_emb) for i, c in enumerate(currs)]

    def reference_frame(self, img: torch.Tensor, mask: torch.Tensor,
                        obj_num: int) -> None:
        """img (1, H, W, 3) uint8, mask (1, H, W) ids 1..obj_num."""
        m = self.model
        xs = m.encode(img)
        _, currs = m.lstt(xs, None, None, m.id_emb(mask))
        fused = self._fused(currs, mask)
        self.lt = [dict(f) for f in fused]
        self.st = fused
        self.lt_frames = 1
        self.step = self.last_write = 0
        self.obj_num = obj_num

    def propagate(self, img: torch.Tensor) -> torch.Tensor:
        """The next frame's logits (1, h4, w4, M + 1), read against the
        memory as it stands."""
        m = self.model
        xs = m.encode(img)
        inputs, self._currs = m.lstt(xs, self.lt, self.st, None)
        self.step += 1
        return m.decode(inputs, xs, self.obj_num)

    def write(self, mask: torch.Tensor) -> None:
        """Write the frame just propagated with the identity of `mask`
        (1, H, W)."""
        fused = self._fused(self._currs, mask)
        self.st = fused
        if self.step - self.last_write < self.lt_gap:
            return
        self.last_write = self.step
        if self.lt_policy == "fifo" and self.lt_frames == self.lt_cap:
            hw = fused[0]["k"].shape[1]
            self.lt = [{k: torch.cat([v[:, :hw], v[:, 2 * hw:]], dim=1)
                        for k, v in layer.items()} for layer in self.lt]
            self.lt_frames -= 1
        self.lt = [{k: torch.cat([v, f[k]], dim=1) for k, v in layer.items()}
                   for layer, f in zip(self.lt, fused)]
        self.lt_frames += 1
