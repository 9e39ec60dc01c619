"""EngineState: the per-video memory of the inference engine (port of
aot_tpu/engine/state.py).

Memory model, as in the JAX package:
  - long-term: per-layer flattened ring buffer (B, CAP*HW, C) plus a total
    write count per group; live tokens = min(count, CAP) * HW.
  - short-term: per-layer depth-SKIP ring (SKIP, B, HW, C) plus
    pointer/count; reads the OLDEST live entry (reference
    `short_term_memories_list[0]`, aot_engine.py:329-332).
  - curr: the unfused per-frame projections consumed by the memory update.

PyTorch runs eagerly, so the scalar counters (frame_step, last_mem_step,
st_ptr, st_count and the per-group lt_count) live on the host as Python
ints: every branch on them is a Python `if`, and a step never waits for the
device to read one. The ring buffers are updated in place by the engine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List

import torch

LayerMem = Dict[str, torch.Tensor]


@dataclass
class EngineState:
    lt: List[LayerMem]
    lt_count: List[int]          # per group: total LT writes
    st: List[LayerMem]
    st_ptr: int                  # most recent ST slot
    st_count: int                # live ST entries (<= SKIP)
    curr: List[LayerMem]
    embs: List[torch.Tensor]     # (B, HW, C) LSTT outputs
    shortcuts: List[torch.Tensor]  # encoder maps, NCHW
    frame_step: int
    last_mem_step: int
    obj_nums: torch.Tensor       # (B,) int64, on the device

    @property
    def batch(self) -> int:
        return self.lt[0]["k"].shape[0]

    def to(self, device) -> "EngineState":
        """A copy of the state with every tensor on `device`."""
        def mv(layers):
            return [{k: v.to(device, copy=True) for k, v in layer.items()}
                    for layer in layers]

        return dataclasses.replace(
            self, lt=mv(self.lt), lt_count=list(self.lt_count),
            st=mv(self.st), curr=mv(self.curr),
            embs=[e.to(device, copy=True) for e in self.embs],
            shortcuts=[s.to(device, copy=True) for s in self.shortcuts],
            obj_nums=self.obj_nums.to(device, copy=True))


def lt_valid_len(state: EngineState, cap: int, hw: int) -> List[int]:
    return [min(c, cap) * hw for c in state.lt_count]


def lt_write_slot(count: int, cap: int, policy: str) -> int:
    """Frame slot for the next LT write. 'grow' writes sequentially (the
    caller re-buckets capacity before it would overflow); 'fifo' pins slot 0
    (the reference frame) and cycles slots 1..CAP-1; 'stop' freezes when
    full."""
    if cap == 1:
        return 0
    if policy == "fifo":
        return count if count < cap else 1 + (count - cap) % (cap - 1)
    return min(count, cap - 1)


def st_oldest_slot(ptr: int, count: int, skip: int) -> int:
    return (ptr - (count - 1)) % skip
