"""VOSEngine: the temporal memory state machine (port of
aot_tpu/engine/engine.py; reference: networks/engines/aot_engine.py).

The per-frame path is `propagate -> decode_logits -> update_memory`, with
the memory in pre-allocated ring buffers. Two departures from the JAX
package, both exact:
  - serving writes the rings in place (slice assignment into the LT/ST
    buffers), so a state is consumed by the call that takes it: the
    returned state shares, and has updated, its buffers. A training engine
    (`inplace_memory = False`, engine/train.py) writes into copies instead,
    since autograd saved the buffers the last frame read;
  - the scalar counters are host ints, so a conditional LT write is a
    Python `if` instead of the per-buffer select that stood in for
    `lax.cond` on the TPU, and the global attention reads only the live
    prefix of the LT ring (masked keys carry exactly zero weight, so
    dropping them changes nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from aot_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from aot_tpu_torch.engine import state as S
from aot_tpu_torch.ops.image import interpolate_bilinear

NEG_LOGIT = -1e10


class VOSEngine:
    """Binds a model and the memory hyperparameters; stateless otherwise
    (besides per-device constants made once)."""

    inplace_memory = True     # ring writes in place (serving)

    def __init__(self, model, max_obj_num: int, lt_gap: int = 9999,
                 st_skip: int = 1, lt_cap: int = 8, lt_policy: str = "fifo",
                 top_k: int = -1, max_mem_len_ratio: float = -1.0,
                 align_corners: bool = True):
        self.model = model
        self.max_obj_num = max_obj_num
        self.lt_gap = lt_gap
        self.st_skip = max(1, st_skip)
        self.lt_cap = max(1, lt_cap)
        self.lt_policy = lt_policy
        self.top_k = top_k
        self.max_mem_len_ratio = max_mem_len_ratio
        self.align_corners = align_corners
        self._consts: Dict[tuple, torch.Tensor] = {}

    def _const(self, key: tuple, make) -> torch.Tensor:
        if key not in self._consts:
            self._consts[key] = make()
        return self._consts[key]

    def _pos(self, size_2d: Tuple[int, int], device) -> torch.Tensor:
        return self._const(("pos", size_2d, device),
                           lambda: self.model.get_pos_emb(size_2d, device))

    def encode_image(self, img: torch.Tensor):
        """img: (B, H, W, 3), normalised float or raw uint8 (normalised on
        the device). Returns the encoder maps, NCHW."""
        if img.dtype == torch.uint8:
            dev = img.device
            mean = self._const(("mean", dev), lambda: torch.tensor(
                IMAGENET_MEAN, dtype=torch.float32, device=dev))
            std = self._const(("std", dev), lambda: torch.tensor(
                IMAGENET_STD, dtype=torch.float32, device=dev))
            img = (img.float() / 255.0 - mean) / std
        return self.model.encode_image(img.permute(0, 3, 1, 2).contiguous())

    # --- state construction ---------------------------------------------
    def _st_rings(self, mems):
        """Per layer, an ST ring holding only this frame's memory."""
        rings = []
        for m in mems:
            layer = {}
            for key, val in m["global"].items():
                layer[key] = val.new_zeros((self.st_skip,) + val.shape)
                layer[key][0] = val
            rings.append(layer)
        return rings

    def _put(self, buf: torch.Tensor, index, val: torch.Tensor) -> torch.Tensor:
        """buf with buf[index] = val: in place, or into a copy when the
        engine keeps the memory out of place."""
        if not self.inplace_memory:
            buf = buf.clone()
        buf[index] = val.to(buf.dtype)
        return buf

    def _seed_state(self, mems, embs, shortcuts, obj_nums,
                    frame_step: int) -> S.EngineState:
        """A fresh EngineState from reference-frame memories."""
        hw = embs[0].shape[1]
        lt = []
        for m in mems:
            layer = {}
            for key, val in m["global"].items():
                b, _, c = val.shape
                layer[key] = val.new_zeros((b, self.lt_cap * hw, c))
                layer[key][:, :hw] = val
            lt.append(layer)
        return S.EngineState(
            lt=lt, lt_count=[1] * embs[0].shape[0], st=self._st_rings(mems),
            st_ptr=0, st_count=1, curr=[dict(m["curr"]) for m in mems],
            embs=list(embs), shortcuts=list(shortcuts),
            frame_step=frame_step, last_mem_step=frame_step,
            obj_nums=obj_nums)

    @staticmethod
    def lt_cap_of(state: S.EngineState, hw: int) -> int:
        """Current LT capacity in frames, from the buffer shape."""
        return state.lt[0]["k"].shape[1] // hw

    def grow_lt(self, state: S.EngineState, hw: int,
                new_cap: int) -> S.EngineState:
        """Re-bucket the LT ring to `new_cap` frames (zero-pad the token
        axis). Valid because slots are written sequentially until full."""
        pad = (new_cap - self.lt_cap_of(state, hw)) * hw
        if pad <= 0:
            return state
        return dataclasses.replace(state, lt=[
            {k: F.pad(v, (0, 0, 0, pad)) for k, v in layer.items()}
            for layer in state.lt])

    def _lt_views(self, state: S.EngineState, hw: int):
        """The live prefix of each LT ring and its valid length: an int when
        every group has the same live length (then no key is masked), else
        a (B,) tensor."""
        valid = S.lt_valid_len(state, self.lt_cap_of(state, hw), hw)
        n = max(valid)
        views = [{k: v[:, :n] for k, v in layer.items()} for layer in state.lt]
        if min(valid) == n:
            return views, n
        return views, torch.tensor(valid, dtype=torch.int32,
                                   device=state.obj_nums.device)

    def _st_views(self, state: S.EngineState):
        slot = S.st_oldest_slot(state.st_ptr, state.st_count, self.st_skip)
        return [{k: v[slot] for k, v in layer.items()} for layer in state.st]

    # --- reference frame --------------------------------------------------
    def add_reference_frame(
        self,
        img: Optional[torch.Tensor],
        mask: torch.Tensor,
        obj_nums: Sequence[int],
        state: Optional[S.EngineState] = None,
        img_embs: Optional[Sequence[torch.Tensor]] = None,
        frame_step: int = 0,
        *,
        id_emb: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> S.EngineState:
        """Seed (or extend, for mid-video new objects) the memory from a
        ground-truth mask (B, H, W) int (reference: aot_engine.py:188-251).
        `generator` drives the model's dropout (training only)."""
        xs = img_embs if img_embs is not None else self.encode_image(img)
        size_2d = tuple(xs[-1].shape[-2:])
        hw = size_2d[0] * size_2d[1]
        dev = xs[-1].device
        if id_emb is None:
            id_emb = self.model.get_id_emb_label(mask, generator)
        embs, mems = self.model.lstt_forward(
            xs[-1], None, None, id_emb, self._pos(size_2d, dev), size_2d,
            generator=generator)
        obj_nums = torch.as_tensor(obj_nums, device=dev).reshape(-1).long()

        if state is None:
            return self._seed_state(mems, embs, xs, obj_nums, frame_step)

        # existing state: append LT, reset the ST ring to this frame
        return dataclasses.replace(
            state, lt=self._write_lt(state, [m["global"] for m in mems], hw),
            lt_count=[c + 1 for c in state.lt_count],
            st=self._st_rings(mems),
            st_ptr=0, st_count=1, curr=[dict(m["curr"]) for m in mems],
            embs=list(embs), shortcuts=list(xs), frame_step=frame_step,
            last_mem_step=frame_step, obj_nums=obj_nums)

    # --- per-frame propagation ---------------------------------------------
    def propagate(self, state: S.EngineState, img: Optional[torch.Tensor],
                  img_embs: Optional[Sequence[torch.Tensor]] = None, *,
                  generator: Optional[torch.Generator] = None
                  ) -> S.EngineState:
        """Attend the new frame against memory (aot_engine.py:340-354)."""
        xs = img_embs if img_embs is not None else self.encode_image(img)
        size_2d = tuple(xs[-1].shape[-2:])
        hw = size_2d[0] * size_2d[1]
        lt_mems, lt_valid = self._lt_views(state, hw)
        embs, mems = self.model.lstt_forward(
            xs[-1], lt_mems, self._st_views(state), None,
            self._pos(size_2d, xs[-1].device), size_2d,
            lt_valid_len=lt_valid, top_k=self.top_k,
            max_mem_len_ratio=self.max_mem_len_ratio, generator=generator)
        return dataclasses.replace(
            state, curr=[dict(m["curr"]) for m in mems], embs=list(embs),
            shortcuts=list(xs), frame_step=state.frame_step + 1)

    # --- decoding -----------------------------------------------------------
    def decode_logits(self, state: S.EngineState,
                      output_size: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
        """(B, h4, w4 or output, M+1) fp32 logits, NHWC, with unused ids
        masked to -1e10 (aot_engine.py:356-380)."""
        logits = self.model.decode_id_logits(state.embs, state.shortcuts)
        logits = logits.permute(0, 2, 3, 1)
        ids = torch.arange(self.max_obj_num + 1, device=logits.device)
        unused = ids > state.obj_nums[:, None, None, None]
        logits = logits.masked_fill(unused, NEG_LOGIT)
        if output_size is not None:
            logits = interpolate_bilinear(logits, output_size,
                                          align_corners=self.align_corners)
        return logits

    # --- memory update -------------------------------------------------------
    def _fuse_curr(self, state: S.EngineState, id_emb):
        """Fuse the mask's identity into the current frame's memory entries
        (aot_engine.py:307-327 / deaot_engine.py:20-45). AOT: K kept, V
        fused. DeAOT (its memory carries `id_v`): K and V kept, only the
        identity branch fused, from the block's identity input (absent at
        layer 0)."""
        fused = []
        for idx, curr in enumerate(state.curr):
            if "id_v" in state.lt[idx]:
                f = self.model.fuse_memory(idx, None, curr.get("id_v"),
                                           id_emb)
                fused.append({"k": curr["k"], "v": curr["v"],
                              "id_v": f["id_v"]})
            else:
                fused.append(self.model.fuse_memory(idx, curr["k"],
                                                    curr["v"], id_emb))
        return fused

    def _write_lt(self, state: S.EngineState, fused, hw: int):
        """Each group's entry written into its LT slot; returns the LT
        rings (the same buffers when the engine writes in place)."""
        cap = self.lt_cap_of(state, hw)
        slots = [S.lt_write_slot(c, cap, self.lt_policy)
                 for c in state.lt_count]
        rings = []
        for layer_lt, layer_f in zip(state.lt, fused):
            layer = {}
            for key, buf in layer_lt.items():
                val = layer_f[key]
                if len(set(slots)) == 1:      # every group: the same slot
                    s = slots[0]
                    buf = self._put(buf, (slice(None), slice(s * hw, (s + 1) * hw)),
                                    val)
                else:
                    for b, s in enumerate(slots):
                        buf = self._put(buf, (b, slice(s * hw, (s + 1) * hw)),
                                        val[b])
                layer[key] = buf
            rings.append(layer)
        return rings

    def update_memory(
        self,
        state: S.EngineState,
        mask: Optional[torch.Tensor] = None,
        prob: Optional[torch.Tensor] = None,
        *,
        id_emb: Optional[torch.Tensor] = None,
        skip_long_term_update: bool = False,
    ) -> S.EngineState:
        """Write the current frame, with the identity of `mask` (B, H, W)
        int or `prob` (B, H, W, M+1), into the ST ring and, every lt_gap
        frames, the LT ring (aot_engine.py:307-338); in place when
        serving."""
        if id_emb is None:
            id_emb = (self.model.get_id_emb(prob.permute(0, 3, 1, 2))
                      if prob is not None
                      else self.model.get_id_emb_label(mask))
        hw = state.embs[0].shape[1]
        fused = self._fuse_curr(state, id_emb)

        ptr = (state.st_ptr + 1) % self.st_skip
        st = [{key: self._put(buf, ptr, layer_f[key])
               for key, buf in layer_st.items()}
              for layer_st, layer_f in zip(state.st, fused)]

        # the gap clock advances whenever the gap is reached, even when the
        # write itself is skipped (aot_engine.py:334-338)
        gap_hit = state.frame_step - state.last_mem_step >= self.lt_gap
        do_lt = gap_hit and not skip_long_term_update
        if self.lt_policy == "stop":
            do_lt = do_lt and min(state.lt_count) < self.lt_cap_of(state, hw)
        lt = self._write_lt(state, fused, hw) if do_lt else state.lt
        return dataclasses.replace(
            state, lt=lt, st=st, st_ptr=ptr,
            st_count=min(state.st_count + 1, self.st_skip),
            lt_count=([c + 1 for c in state.lt_count] if do_lt
                      else state.lt_count),
            last_mem_step=(state.frame_step if gap_hit
                           else state.last_mem_step))
