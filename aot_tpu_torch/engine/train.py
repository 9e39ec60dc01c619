"""Training-time engine: the per-clip forward recipe (port of
aot_tpu/engine/train.py; reference: networks/engines/aot_engine.py:33-108).

For a T-frame clip:
  1. encode all T*B frames in one batched pass (with trainable BN,
     MODEL_FREEZE_BN=False, the one pass that normalises by batch moments
     and moves the running stats: aot_tpu/engine/train.py:136-151);
  2. seed the memory from frame 0 and its ground-truth mask; auxiliary loss
     on frame 0 (and on frame 1 when `enable_prev_frame`);
  3. propagate the remaining frames, one loss each; before every frame after
     the first propagated one, write the memory with the previous
     prediction (`use_prev_pred`) or the previous ground truth;
  4. loss = aux_weight(step) * aux + mean(frame losses).

The memory is written out of place (`inplace_memory = False`): autograd
saved the buffers the last frame read. With `remat`, each propagated
frame's forward is recomputed in the backward (torch.utils.checkpoint,
non-reentrant) instead of kept: the JAX package's `TRAIN_REMAT`. The
recomputed function starts from the encoded features, so it never runs a
BN: the running stats move once a step. Dropout
and stochastic depth draw from a generator made from (`seed`, frame) inside
the recomputed function, so the recompute replays the same draws, for AOT's
LSTT and DeAOT's GPM stack alike.

The forward computes in the model's compute dtype (TRAIN_DTYPE): the model
casts the frames, the one-hot masks and the position embedding to it. The
decoder returns fp32 logits, so the resize and the losses are fp32, where
the JAX package leaves bf16 (aot_tpu/models/decoders.py:59,
aot_tpu/engine/train.py:86-110).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from aot_tpu_torch.engine.engine import VOSEngine
from aot_tpu_torch.ops import losses as loss_ops
from aot_tpu_torch.ops.image import interpolate_bilinear_matmul_cf

NEG_LOGIT = -1e10


def build_train_engine(model, cfg) -> "TrainEngine":
    """(aot_tpu/engine/train.py:28)."""
    return TrainEngine(
        model,
        max_obj_num=cfg.MODEL_MAX_OBJ_NUM,
        lt_gap=cfg.TRAIN_LONG_TERM_MEM_GAP,
        st_skip=1,
        lt_cap=cfg.TRAIN_LONG_TERM_MEM_CAP,
        lt_policy="fifo",
        align_corners=cfg.MODEL_ALIGN_CORNERS,
        total_steps=cfg.TRAIN_TOTAL_STEPS,
        aux_weight=cfg.TRAIN_AUX_LOSS_WEIGHT,
        aux_ratio=cfg.TRAIN_AUX_LOSS_RATIO,
        top_k_percent=cfg.TRAIN_TOP_K_PERCENT_PIXELS,
        hard_mining_ratio=cfg.TRAIN_HARD_MINING_RATIO,
        remat=cfg.get("TRAIN_REMAT", True),
    )


def frame_generator(seed: Optional[int], index: int,
                    device) -> Optional[torch.Generator]:
    """The generator of one segment of the clip forward (index 0: the
    reference frames; t: propagated frame t), or None without a seed."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + index) % (2 ** 63))
    return g


class TrainEngine(VOSEngine):
    """Adds the training forward to VOSEngine."""

    inplace_memory = False

    def __init__(self, *args, total_steps: int = 100_000,
                 aux_weight: float = 1.0, aux_ratio: float = 1.0,
                 top_k_percent: float = 0.15, hard_mining_ratio: float = 0.5,
                 remat: bool = True, **kw):
        super().__init__(*args, **kw)
        self.total_steps = total_steps
        self.aux_weight = aux_weight
        self.aux_step = total_steps * aux_ratio + 1e-5
        self.top_k_percent = top_k_percent
        self.hard_mining_step = hard_mining_ratio * total_steps + 1e-5
        self.remat = remat

    # --- helpers ---------------------------------------------------------
    def _id_emb(self, mask, shuffle_matrix, freeze_id: bool, generator):
        """Identity embedding of a (B, H, W) label map, its ids relabelled
        by the shuffle (one_hot(l) @ S == one_hot(perm[l]))."""
        label = mask.long()
        if shuffle_matrix is not None:
            perm = shuffle_matrix.argmax(dim=2)                  # (B, M+1)
            b = label.shape[0]
            label = perm.gather(1, label.reshape(b, -1)).reshape(label.shape)
        emb = self.model.get_id_emb_label(label, generator)
        return emb.detach() if freeze_id else emb

    def _frame_loss(self, state, gt_mask, obj_nums, shuffle_matrix,
                    step: float, input_size) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode -> (per-sample loss, predicted labels) at input resolution
        (aot_tpu/engine/train.py:86)."""
        logits = self.model.decode_id_logits(state.embs, state.shortcuts)
        if shuffle_matrix is not None:     # reverse shuffle
            logits = torch.einsum("bohw,bto->bthw", logits, shuffle_matrix)
        ids = torch.arange(self.max_obj_num + 1, device=logits.device)
        unused = ids[None, :, None, None] > obj_nums[:, None, None, None]
        logits = logits.masked_fill(unused, NEG_LOGIT)
        logits = interpolate_bilinear_matmul_cf(
            logits, input_size, align_corners=self.align_corners)
        ratio = min(1.0, step / self.hard_mining_step)
        loss = loss_ops.combined_vos_loss_cf(
            logits, gt_mask, obj_nums, top_k_percent=self.top_k_percent,
            top_k_ratio=ratio)
        return loss, logits.argmax(dim=1)

    # --- the clip forward --------------------------------------------------
    def forward(
        self,
        frames: torch.Tensor,      # (T, B, H, W, 3) uint8 or normalised
        masks: torch.Tensor,       # (T, B, H, W) int
        obj_nums: torch.Tensor,    # (B,) int
        step: float,               # global training step
        *,
        shuffle_matrix: Optional[torch.Tensor] = None,   # (B, M+1, M+1)
        use_prev_pred: bool = False,
        enable_prev_frame: bool = False,
        seed: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (loss, stats). seed None: no dropout or stochastic depth
        (the JAX package's deterministic=True)."""
        t, b, h, w, _ = frames.shape
        step = float(step)
        freeze_id = use_prev_pred
        obj_nums = obj_nums.long()
        masks = masks.long()
        dev = frames.device
        input_size = (h, w)

        # 1. offline encoder: all frames in one pass, the step's only BN
        # pass (batch moments with trainable BN; never recomputed)
        xs = self.encode_image(frames.reshape(t * b, h, w, 3))
        feats = [x.reshape((t, b) + x.shape[1:]) for x in xs]

        # 2. reference frame (and the optional previous frame)
        g = frame_generator(seed, 0, dev)
        state = self.add_reference_frame(
            None, masks[0], obj_nums, img_embs=[f[0] for f in feats],
            id_emb=self._id_emb(masks[0], shuffle_matrix, freeze_id, g),
            generator=g)
        aux_loss, _ = self._frame_loss(state, masks[0], obj_nums,
                                       shuffle_matrix, step, input_size)
        aux_losses = [aux_loss]
        first = 1
        if enable_prev_frame:
            state = self.add_reference_frame(
                None, masks[1], obj_nums, state=state,
                img_embs=[f[1] for f in feats], frame_step=1,
                id_emb=self._id_emb(masks[1], shuffle_matrix, freeze_id, g),
                generator=g)
            prev_aux, _ = self._frame_loss(state, masks[1], obj_nums,
                                           shuffle_matrix, step, input_size)
            aux_losses.append(prev_aux)
            first = 2

        # 3. propagate the remaining frames
        def body(state, prev_pred, index, frame_feats, gt_mask, prev_gt):
            gen = frame_generator(seed, index, dev)
            if index > first:          # no write before the first frame
                mem_mask = prev_pred if use_prev_pred else prev_gt
                state = self.update_memory(state, id_emb=self._id_emb(
                    mem_mask, shuffle_matrix, freeze_id, gen))
            state = self.propagate(state, None, img_embs=frame_feats,
                                   generator=gen)
            floss, pred = self._frame_loss(state, gt_mask, obj_nums,
                                           shuffle_matrix, step, input_size)
            return state, pred, floss

        pred = torch.zeros((b, h, w), dtype=torch.long, device=dev)
        frame_losses = []
        for index in range(first, t):
            args = (state, pred, index, [f[index] for f in feats],
                    masks[index], masks[index - 1])
            if self.remat:
                state, pred, floss = checkpoint(
                    body, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                state, pred, floss = body(*args)
            frame_losses.append(floss)

        frame_losses = torch.stack(frame_losses)          # (T - first, B)
        pred_loss = frame_losses.mean()
        aux_mean = torch.stack([a.mean() for a in aux_losses]).mean()
        aux_w = self.aux_weight * max(self.aux_step - step, 0.0) / self.aux_step
        total = aux_w * aux_mean + pred_loss
        stats = {
            "loss": total,
            "aux_loss": aux_mean,
            "pred_loss": pred_loss,
            "frame_losses": torch.cat([aux_mean[None],
                                       frame_losses.mean(dim=1)]),
            "iou": loss_ops.mean_iou(pred, masks[t - 1], obj_nums,
                                     self.max_obj_num),
            "last_pred": pred,
        }
        return total, stats
