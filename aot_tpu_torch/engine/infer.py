"""VOSInferEngine: online inference for any number of objects via groups of
at most max_obj_num (port of aot_tpu/engine/infer.py; reference:
networks/engines/aot_engine.py:485-635 AOTInferEngine).

The group axis is the engine's batch axis: the image is encoded once and
its maps broadcast over groups. Group bookkeeping is host-side.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from aot_tpu_torch.engine import state as S
from aot_tpu_torch.engine.engine import VOSEngine
from aot_tpu_torch.ops.attention import set_attn_impl, set_attn_thresholds
from aot_tpu_torch.ops.image import (interpolate_bilinear, nearest_labels,
                                     upsample_argmax)


def groups_for(obj_num: int, max_obj_num: int) -> int:
    return max(1, math.ceil(obj_num / max_obj_num))


def separate_mask(mask: torch.Tensor, num_groups: int,
                  max_obj_num: int) -> torch.Tensor:
    """(1, H, W) full-id mask -> (G, H, W) per-group masks with local ids
    1..max_obj_num (aot_engine.py:515-545)."""
    g = torch.arange(num_groups, dtype=mask.dtype,
                     device=mask.device)[:, None, None]
    start = g * max_obj_num + 1
    m = mask.reshape(mask.shape[-2], mask.shape[-1])[None]
    fg = (m >= start) & (m <= start + max_obj_num - 1)
    return torch.where(fg, m - start + 1, 0)


def separated_obj_nums(obj_num: int, num_groups: int,
                       max_obj_num: int) -> List[int]:
    nums = [max_obj_num] * num_groups
    if obj_num % max_obj_num > 0:
        nums[-1] = obj_num % max_obj_num
    return nums


def soft_aggregate_logits(group_logits: torch.Tensor,
                          max_obj_num: int) -> torch.Tensor:
    """(G, H, W, M+1) -> (1, H, W, 1 + G*M) merged logits
    (aot_engine.py:565-582): bg prob = product of the groups' bg probs; fg
    probs concatenated; clamped logit."""
    g = group_logits.shape[0]
    if g == 1:
        return group_logits
    probs = torch.softmax(group_logits.float(), dim=-1)
    bg = probs[..., 0].prod(dim=0, keepdim=True)[..., None]
    fg = torch.cat([probs[i:i + 1, ..., 1:1 + max_obj_num] for i in range(g)],
                   dim=-1)
    merged = torch.cat([bg, fg], dim=-1).clamp(1e-5, 1 - 1e-5)
    return torch.log(merged) - torch.log1p(-merged)


def min_aggregate_logits(group_logits: torch.Tensor,
                         max_obj_num: int) -> torch.Tensor:
    """(aot_engine.py:547-563)."""
    g = group_logits.shape[0]
    if g == 1:
        return group_logits
    bg = group_logits[..., 0].amin(dim=0, keepdim=True)[..., None]
    fg = torch.cat([group_logits[i:i + 1, ..., 1:1 + max_obj_num]
                    for i in range(g)], dim=-1)
    return torch.cat([bg, fg], dim=-1)


def _expand_groups(state: S.EngineState, new_g: int) -> S.EngineState:
    """Zero-pad the group axis so freshly arrived object groups can join an
    existing state. Group axis: 1 for the ST rings, 0 for everything else."""
    extra = new_g - state.batch

    def pad(x, axis=0):
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    return dataclasses.replace(
        state,
        lt=[{k: pad(v) for k, v in layer.items()} for layer in state.lt],
        lt_count=state.lt_count + [0] * extra,
        st=[{k: pad(v, 1) for k, v in layer.items()} for layer in state.st],
        curr=[{k: pad(v) for k, v in layer.items()} for layer in state.curr],
        embs=[pad(e) for e in state.embs],
        shortcuts=[pad(s) for s in state.shortcuts],
        obj_nums=pad(state.obj_nums))


def build_infer_engine(model, cfg, aggregation: str = "soft"
                       ) -> "VOSInferEngine":
    """The eval engine from a Config (reference:
    networks/engines/__init__.py:5-21). Applies the config's attention
    knobs first, as aot_tpu/engine/infer.py:107-113 does: ATTN_IMPL and the
    three ATTN_* thresholds (None keeps one), process-wide."""
    set_attn_impl(cfg.get("ATTN_IMPL", "auto"))
    set_attn_thresholds(
        flash_min_keys_bf16=cfg.get("ATTN_FLASH_MIN_KEYS_BF16"),
        flash_min_keys_fp32=cfg.get("ATTN_FLASH_MIN_KEYS_FP32"),
        dense_local_max_tokens=cfg.get("ATTN_DENSE_LOCAL_MAX_TOKENS"))
    eng = VOSEngine(
        model,
        max_obj_num=cfg.MODEL_MAX_OBJ_NUM,
        lt_gap=cfg.TEST_LONG_TERM_MEM_GAP,
        st_skip=cfg.TEST_SHORT_TERM_MEM_SKIP,
        lt_cap=cfg.TEST_LONG_TERM_MEM_CAP,
        lt_policy=cfg.TEST_LONG_TERM_MEM_POLICY,
        top_k=cfg.get("TEST_TOP_K", -1),
        max_mem_len_ratio=cfg.get("TEST_MAX_MEM_LEN_RATIO", -1.0),
        align_corners=cfg.MODEL_ALIGN_CORNERS,
    )
    return VOSInferEngine(eng, aggregation=aggregation)


class LTShadow:
    """Host-side mirror of the long-term-memory write schedule, so a caller
    knows the post-write LT frame count and can grow the ring in time
    ('grow' policy)."""

    def __init__(self, lt_gap: int):
        self.gap = lt_gap
        self.count = 0
        self.last = -(1 << 30)

    def add_ref(self, frame_step: int) -> int:
        self.count += 1
        self.last = frame_step
        return self.count

    def will_write(self, frame_step: int) -> bool:
        return frame_step - self.last >= self.gap

    def update(self, frame_step: int, skip_long_term: bool = False) -> int:
        """Mirror of VOSEngine.update_memory's gap clock. Returns the LT
        count after the call."""
        if self.will_write(frame_step):
            if not skip_long_term:
                self.count += 1
            self.last = frame_step
        return self.count


class VOSInferEngine:
    """Online inference engine for one video (any number of objects), or
    for N videos of at most max_obj_num objects each, one a batch row
    (`add_reference_frames_videos`, `step_videos`). Images are (B, H, W, 3)
    float or uint8, masks (B, H, W) int."""

    def __init__(self, engine: VOSEngine, aggregation: str = "soft"):
        self.engine = engine
        self.max_obj_num = engine.max_obj_num
        self.aggregation = aggregation

    def make_shadow(self) -> LTShadow:
        return LTShadow(self.engine.lt_gap)

    def lt_cap(self, state: S.EngineState) -> int:
        return self.engine.lt_cap_of(state, state.embs[0].shape[1])

    def ensure_lt_capacity(self, state: S.EngineState,
                           needed: int) -> S.EngineState:
        """Grow the LT ring (next power-of-two bucket) so `needed` frames
        fit. No-op unless the engine runs the 'grow' policy."""
        if self.engine.lt_policy != "grow":
            return state
        cap = self.lt_cap(state)
        if needed <= cap:
            return state
        new_cap = max(cap * 2, 1 << (needed - 1).bit_length())
        return self.engine.grow_lt(state, state.embs[0].shape[1], new_cap)

    def num_groups(self, obj_num: int) -> int:
        return groups_for(obj_num, self.max_obj_num)

    @staticmethod
    def _broadcast_embs(xs: Sequence[torch.Tensor], g: int):
        return [x.expand((g,) + tuple(x.shape[1:])) for x in xs]

    @torch.inference_mode()
    def add_reference_frame(self, img: torch.Tensor, mask: torch.Tensor,
                            obj_num: int,
                            state: Optional[S.EngineState] = None,
                            frame_step: int = 0) -> S.EngineState:
        """mask ids 1..obj_num; a state given extends it (mid-video new
        objects)."""
        g = self.num_groups(obj_num)
        sep = separate_mask(mask, g, self.max_obj_num)
        xs = self._broadcast_embs(self.engine.encode_image(img), g)
        if state is not None and state.batch < g:
            state = _expand_groups(state, g)
        return self.engine.add_reference_frame(
            None, sep, separated_obj_nums(obj_num, g, self.max_obj_num),
            state=state, img_embs=xs, frame_step=frame_step)

    @torch.inference_mode()
    def propagate(self, state: S.EngineState,
                  img: torch.Tensor) -> S.EngineState:
        xs = self._broadcast_embs(self.engine.encode_image(img), state.batch)
        return self.engine.propagate(state, None, img_embs=xs)

    @torch.inference_mode()
    def decode_logits(self, state: S.EngineState,
                      output_size: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
        """Aggregated (1, h, w, 1 + G*M) logits (aot_engine.py:618-623)."""
        logits = self.engine.decode_logits(state)
        agg = (soft_aggregate_logits if self.aggregation == "soft"
               else min_aggregate_logits)(logits, self.max_obj_num)
        if output_size is not None:
            agg = interpolate_bilinear(agg, output_size,
                                       align_corners=self.engine.align_corners)
        return agg

    @torch.inference_mode()
    def update_memory(self, state: S.EngineState,
                      mask: torch.Tensor) -> S.EngineState:
        """mask: (1, H, W) predicted full-id label map."""
        sep = separate_mask(mask, state.batch, self.max_obj_num)
        return self.engine.update_memory(state, mask=sep)

    @torch.inference_mode()
    def step(self, state: S.EngineState, img: torch.Tensor,
             output_size: Tuple[int, int]):
        """One online frame: propagate -> decode -> upsample+argmax ->
        update_memory, with the mask fed back on the device. Returns
        (state, pred (1, H, W) int64 at output_size, grid-resolution
        aggregated logits (1, h4, w4, 1 + G*M))."""
        state = self.propagate(state, img)
        logits = self.decode_logits(state)
        pred = upsample_argmax(logits, output_size,
                               align_corners=self.engine.align_corners)
        state = self.update_memory(state, pred)
        return state, pred, logits

    # --- batched multi-video serving ------------------------------------
    # N independent videos advanced by one step: the engine's batch axis
    # carries videos instead of object groups (each video <= max_obj_num
    # objects: one group). decode_logits masks each row's unused ids from
    # state.obj_nums, the LT counts are per row, and every memory and
    # attention op treats rows independently, so nothing is aggregated
    # (aot_tpu/engine/infer.py:272-320).

    @torch.inference_mode()
    def add_reference_frames_videos(self, imgs: torch.Tensor,
                                    masks: torch.Tensor,
                                    obj_nums: Sequence[int]
                                    ) -> S.EngineState:
        """imgs (N, H, W, 3), masks (N, H, W) with ids 1..obj_nums[i] (each
        at most max_obj_num): one state whose row i is video i."""
        if max(obj_nums) > self.max_obj_num:
            raise ValueError(
                f"add_reference_frames_videos: obj_nums {list(obj_nums)} "
                f"exceed max_obj_num={self.max_obj_num} (one group a video)")
        return self.engine.add_reference_frame(imgs, masks, list(obj_nums))

    @torch.inference_mode()
    def step_videos(self, state: S.EngineState, imgs: torch.Tensor,
                    orig_size: Tuple[int, int],
                    input_size: Optional[Tuple[int, int]] = None):
        """One step of N videos: propagate -> decode at the original size
        -> argmax -> (nearest-down to the input size) -> update_memory, per
        row exactly the evaluator's scalar cadence. imgs (N, h, w, 3) at
        the input size. A ragged batch replays a finished video's last
        frame and drops its output (rows never interact). Returns (state,
        preds (N, H, W) int64 at orig_size, grid-resolution logits (N, h4,
        w4, M+1), as `step` returns its own)."""
        eng = self.engine
        state = eng.propagate(state, imgs)
        logits = eng.decode_logits(state)
        pred = upsample_argmax(logits, orig_size,
                               align_corners=eng.align_corners)
        lab = pred
        if input_size is not None and tuple(input_size) != tuple(orig_size):
            lab = nearest_labels(pred, input_size)
        return eng.update_memory(state, mask=lab), pred, logits

    @torch.inference_mode()
    def step_chunk(self, state: S.EngineState, imgs: torch.Tensor,
                   orig_size: Tuple[int, int], input_size: Tuple[int, int]):
        """K frames of one video with the masks fed back on the device: the
        eager form of aot_tpu/engine/infer.py:322-364's `lax.scan`. Per
        frame the ops of the evaluator's scalar path (propagate ->
        aggregated logits -> bilinear to orig_size -> argmax -> nearest to
        input_size -> update_memory); nothing in the loop waits for the
        device, so the caller reads the K masks back once. The caller grows
        a 'grow' ring beforehand for every LT write of the chunk (the
        schedule is known on the host: a copy of `LTShadow`).

        imgs: (K, 1, h, w, 3). Returns (state, preds (K, 1, H, W) uint8)."""
        preds = []
        for img in imgs:
            state = self.propagate(state, img)
            pred = upsample_argmax(self.decode_logits(state), orig_size,
                                   align_corners=self.engine.align_corners)
            state = self.update_memory(state, nearest_labels(pred,
                                                             input_size))
            preds.append(pred.to(torch.uint8))
        return state, torch.stack(preds)
