#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (aot_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-eval [--no-autotune]
    python3 chip_smoke.py --profile-serve MODEL [--batch N]
    python3 chip_smoke.py --profile-train MODEL [--dtype D] [--batch N]
                          [--trainable-bn]
    python3 chip_smoke.py --profile-bwd
    python3 chip_smoke.py --profile-fwd

The second form profiles phase 12's evaluation and runs nothing else
(`profile_full_res_eval`); the third profiles a model's serving path, as
phases 6, 14 and 16 run it (with --batch N: N videos a step, as phase 21),
before and after the flash switch (`profile_serving`); the fourth a
training step, as phases 10, 25, 26 and 28 run it (`profile_training`); the
fifth the flash backward's kernels one by one at phase 9's and 24's shapes
(`profile_bwd`); the sixth the bf16 forward kernels (local window and
flash) one by one at phase 19's shapes (`profile_fwd`).

Phases (2, 3, 8, 9, 19, 23, 24 and 34, the kernel checks, run first, then
4 to 7, then 10 to 18, then 20 to 22, then 25 to 33); any failure raises
and the exit code is non-zero:
  0. refuse to run without a card; print the card's name and power limit
     (nvidia-smi) and the torch/CUDA versions; TF32 off for matmuls and
     convolutions.
  1. build the CUDA kernels from aot_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, all at once).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it (max abs error <= 1e-4): the
     local-window kernel (csrc/local_window_attn_tc.cu) at the 465x465
     grids, Swin-B's 29x29 (464x464; both heads), the demo's 29x51 (DeAOT's
     head), a ragged 46x80 and the full-resolution grids (64x113 and 68x120
     with rel_v, 43x76 at B=2, DeAOT's head at 64x113, a 5x3 grid narrower
     than the window), at a window of one slot (max_dis 0), a grid of one
     row at both heads, max_dis 3 and 5, a 64-column value tile with
     rel_v, dv=160 with rel_v (two passes), d=512 (two passes, 1-row
     tiles), d=128 in 4-row tiles and the TPU narrow kernel's test shapes
     (10x12, 9x7, 8x8, with and without rel_v), the flash forward at
     fourteen: DeAOTL's long-term reads (two passes, key splits;
     SwinB_DeAOTL's, Lq=841 over 8,410 and 17,661 keys; one at DAVIS
     1080p, Lq=7,232 over 14,464 keys, whose scores take two query slabs),
     AOT's heads over a long memory and the flash_mem hw_check shape,
     AOTT's training shape (B=16, h=8, Lq=Lk=900; all keys live and a
     partial (B,) live length), a near-flat softmax at Lk=19,800 (q scaled
     by 1e-3: every weight ~1/Lk, where a running fp32 sum over the keys
     loses most), a one-pass grid that splits its key loop 17 ways (B*h=1,
     some splits empty) and
     d=dv=64 (the one-pass kernel's 128-column value tile).
  3. kernel and plain times (CUDA events around one call, median of
     2 x 50 runs, in the order plain, kernels, kernels reversed,
     plain; 2 x 20 at 64x113 and at 1080p): the local-window kernel at
     30x30, 29x29 and 64x113 (AOT and DeAOT heads), at DeAOT's head
     beside F.scaled_dot_product_attention with the dense window bias
     (rel_bias in the window, -inf elsewhere; no PyTorch call adds AOT's
     rel_v), the flash forward at AOTT's training shape and at
     DeAOTL's long-term shape with 9,000 and 19,800 keys, SwinB_DeAOTL's
     (Lq=841, 17,661 keys) and at 1080p
     (Lq=7,232, 14,464 keys), each beside F.scaled_dot_product_attention
     with a boolean live-key mask (the library yardsticks; the port never
     calls them; the backend each picks is printed).
  4. the first main path: AOTT at 465x465 with 10 objects and seeded random
     weights — VOSInferEngine.add_reference_frame, then STEPS frames of
     VOSInferEngine.step on a seeded synthetic video, in the evaluator's
     loop (the LT ring grown before each LT write); output checks, each
     kernel's launch count of the run against the count the LT schedule
     gives, the median time per frame and the peak memory.
  5. the port on the card against the port on the CPU, from the state the
     run left, for 3 frames: grid logits within 1e-3, masks agree on
     >= 99.9%.
  6. the second main path, DeAOTL (three gated-propagation blocks, LT gap 5,
     'grow' ring from 4 frames), as in 4; the ring passes 8,192 live keys
     at its 10th frame, and from there every LT read runs the flash kernel.
     Median time per frame before and after that switch.
  7. as 5, for DeAOTL, from a state with >= 10 live LT frames.
  8. the flash backward kernels against their plain version (dQ, dK, dV
     max abs error <= 1e-4 of each gradient's largest entry): AOTT's
     training shape (B=16, h=8, d=dv=32, Lq=Lk=900; all keys live, and a
     partial (B,) live length), the hw_check shape (B=2, Lk=7,200, live
     [7200, 4320]), DeAOTL's LT shape (h=1, d=128, dv=1024) at Lk=9,000
     and 19,800 and near-flat at 19,800, at 1080p (Lq=7,232, Lk=14,464:
     two query slabs), DeAOT's GPM self-attention (B=16, h=1, d=128,
     dv=1024, Lq=Lk=900), B=2 with one element's keys all dead (zero
     gradients there), d=dv=64 (two passes), a row with no live key at
     AOT's heads and AOT's heads with live lengths (997, 613) that are no
     multiple of any tile; exact zeros beyond each live length; a second
     run of each must give the same bits (no atomics).
  9. backward kernel and plain times, as 3, at AOTT's training shape and
     DeAOTL's LT shape (Lk=19,800 at Lq=900, and 14,464 at 1080p), each
     beside the autograd backward of F.scaled_dot_product_attention (the
     library yardstick).
 10. the third main path, AOTT training: Trainer.sequential_training on a
     seeded clip source (TRAIN_BATCH clips of moving ellipses, 465x465,
     T=5, fixed: every step sees the same clips), stage pre_ytb_dav, fp32,
     TF32 off, per-frame recompute, local reads on the window form, TRAIN_TOTAL_STEPS = 1000 (the length of
     the LR, aux-weight and hard-mining schedules: the steps run stay in
     the LR warm-up, with the loss's definition nearly fixed),
     TRAIN_WARMUP untimed steps then TRAIN_STEPS - TRAIN_WARMUP timed ones.
     Prints the loss per step, the median and p90 ms per step (host clock,
     ending in torch.cuda.synchronize()), the peak memory and each kernel's
     launches per step, which must be 2 flash forwards per frame plus one
     per recomputed frame, 2 flash backwards per frame, and 0 local-window
     launches. Gates: finite losses, the mean of the last 5 below the mean
     of the first 5, the checkpoint written at the end reloads (raw state
     equal to the trained model; the EMA state dict loads strictly into a
     serving model).
 11. one train step on the card against the same step on the CPU, from
     the same weights and batch (97x97, B=2, T=3, no stochastic depth):
     loss and grad_norm within 1e-4 relative, every gradient within 1e-3
     of its leaf's largest entry (plus 1e-6 of the model's largest), every
     updated parameter within a quarter of one LR unit (two units where
     the gradient is below that floor: Adam's first step is ~lr sign(g)).
 12. the fourth main path, full-resolution evaluation: a DAVIS-2017
     Full-Resolution folder (one seeded 1080x1920 clip of EVAL_FRAMES
     frames with 5 moving ellipses, every frame annotated) evaluated by
     `python -m aot_tpu_torch.eval`'s own code (eval.__main__.run) with
     `--dataset davis2017 --max_resolution 1080 --ckpt_path test --set
     TEST_DATASET_FULL_RESOLUTION=True`, AOTT: the input is 1009x1793, a
     64x113 = 7,232-token grid (asserted), each short-term read on the
     local kernel. Launches asserted: the local kernel once per LSTT
     forward (each frame, the reference frame included, per block), the
     flash forward once per LT read of >= 8,192 live
     keys (the LT schedule gives 0 here: AOTT's LT gap 9999 keeps one
     7,232-token frame). Prints the median and p90 ms/frame of the
     evaluator's per-frame times after EVAL_WARMUP, the peak memory, and
     J&F against the clip's ground truth (random weights: printed, not
     gated). The evaluator autotunes cuDNN's convolutions for its run; a
     second pass over the clip, with the algorithms chosen, shows what the
     first pass at a new input size took more in time and memory.
 13. at that size, the port on the card against the port on the CPU, from
     the same state (reference frame and 2 steps on the card), for 3
     frames of VOSInferEngine.step: grid logits within 1e-3, masks agree on
     >= 99.9%.
 14. the fifth main path, R50_DeAOTL (ResNet-50 encoder) at 465x465, as 6:
     the flash switch at step 46 (asserted).
 15. as 7, for R50_DeAOTL.
 16. the sixth main path, SwinB_DeAOTL (Swin-B encoder,
     MODEL_ALIGN_CORNERS=False) at 464x464, the evaluator's snap of the
     465x465 frames for that mode (a 29x29 grid, asserted: 841 tokens, the
     identity bank at kernel 16 and padding 0), as 6; the flash switch at
     step 46 (10 LT frames of 841 tokens; asserted), and the window kernel
     (phase 34) on each of Swin-B's 22 blocks a frame (asserted; also in
     18's two Swin variants at fp32, never at bf16).
 17. as 7, for SwinB_DeAOTL.
 18. each of the 14 model variants (configs/models.py) on the card: built
     from the seed, its state dict loaded back strictly, the reference
     frame and VARIANT_STEPS steps at its serving size with 10 objects;
     per variant the output checks, the grid, the launches by kernel
     (asserted against the LT schedule), the median ms/frame, the peak
     memory, and the reference repository's 1xV100 FPS labelled as that.
 19. the bf16 kernels (csrc/local_window_attn_bf16.cu, bf16 serving;
     csrc/flash_attn_fwd_bf16.cu, bf16 serving and training) against their
     bf16 plain versions (max abs error <= 1e-2 of the largest entry, lse
     within 1e-2; the plain versions widen to fp32, the flash one rounds P
     to bf16), a second run bit-identical: the local-window kernel at the
     AOT and DeAOT heads at 30x30 with B = 1 and 4 and DeAOT's at the
     demo's 29x51, both at 64x113, the flash
     forward over AOTT-shaped LT rings (Lq=900, Lk=7,200, h=8, d=32, live
     900 to 7,200), DeAOTL's (Lq=900, Lk=19,800, d=128, dv=1024) with B =
     1 and 4, the demo's (Lq=1,479, Lk=5,916, live 4,437 and 5,916) and
     at the training shapes (AOTT B=16, h=8, L=900, d=dv=32; DeAOT's GPM
     self-attention B=16, L=900, d=128, dv=1024, and its LT read at
     Lk=2,700), with NaN in
     every dead key (the same bits: dead keys are never read), and an
     element with no live key (out exactly 0, lse -1e30); each timed
     beside the bf16 plain version, bf16 F.scaled_dot_product_attention
     (its backend named; the DeAOT local head with the dense window bias),
     the fp32 kernel at the same shape (checked at 1e-4) and the bound at
     the bf16 rate (max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s)).
 20. bf16 serving (TEST_DTYPE=bfloat16): AOTT and DeAOTL as 4 and 6 on the
     same clip, ms/frame (median, p90) beside this call's fp32 runs, masks
     against the fp32 runs' (mean >= 99.5%, worst frame >= 99.0%),
     launches from the bf16 rule (flash from 4,096 live keys: DeAOTL from
     step 21); phase 12's clip with --amp (the local kernel's bf16
     instantiation); each of the 14 variants as 18, at bf16.
 21. batched multi-video serving (VOSInferEngine.step_videos): AOTT with
     N = 1, 2, 4, 8 and DeAOTL with N = 1, 2, 4 (55 steps, through the
     flash switch) on seeded clips: ms a step, frames/s in all, peak
     memory; at the largest N each row stepped alone from a copy of its
     state at three steps: grid logits within 1e-4, masks >= 99.9%, and
     whether the two are bit-identical.
 22. chunked serving (VOSInferEngine.step_chunk, K = 8, under
     torch.cuda.set_sync_debug_mode("error")): AOTT and DeAOTL over 56
     frames, masks bit-identical to per-frame stepping, ms/frame of each;
     then `python -m aot_tpu_torch.eval` on a written DAVIS-2017 480p folder
     of 5 clips: the scalar run, --video_batch 4 --frame_chunk 8 (PNGs
     equal to the scalar run's) and the same with --amp (>= 99.5%).
 23. the bf16 backward (csrc/flash_attn_bwd.cu's bf16 instantiation)
     against its bf16 plain version (dq, dk, dv each within 1e-2 of its
     largest entry): AOTT's training shape (B=16, h=8, d=dv=32, Lq=Lk=900;
     all keys live and a partial (B,) live length), DeAOT's training shapes
     (h=1, d=128, dv=1024: the GPM self-attention at Lq=Lk=900, the LT read
     at Lk=2,700, all live and partial), B=2 with one element's keys all
     dead, DeAOT's head at 1080p (two query slabs: dV and dK summed over
     them in fp32), a row with no live key at AOT's heads, AOT's heads
     with live lengths (997, 613) that are no multiple of any tile and
     d=dv=64 (two passes, output tiles wider than the heads); exact zeros
     beyond each live length, a second run bit-identical.
 24. the bf16 backward timed as 9 at the training paths' shapes (AOTT's,
     DeAOT's self-attention and LT read at B=16) beside its bf16 plain
     version, the autograd backward of bf16 F.scaled_dot_product_attention
     and the bf16 bound, with the fp32 kernel at the same shapes.
 25. the seventh main path, AOTT training at the configs' own dtype, bf16
     (TRAIN_DTYPE): phase 10's configuration and report, the bf16 flash
     forward and backward launched 18 and 10 times a step (asserted, the
     fp32 kernels 0), the median of the last 10 steps, and a checkpoint
     whose parameters, Adam moments and EMA are fp32.
 26. the eighth main path, R50_DeAOTL training at bf16, B=16, T=5, 465x465,
     TRAIN_LONG_TERM_MEM_GAP=2 (the -L models' own: the last frame reads
     three LT frames), 10 steps, reported as 25: the GPM self-attention
     and LT read on the bf16 flash kernels (54 forward and 30 backward
     launches a step, asserted), local reads on the window form.
 27. one train step on the card against the CPU, as 11: AOTT at bf16,
     DeAOTT (LT gap 1) at fp32 and at bf16, DeAOT without dropout (the
     card's and the CPU's generators draw other masks). fp32 to phase 11's
     gates; bf16: loss and grad_norm within 2e-2 relative, each gradient
     leaf within 5e-2 of its largest entry or twice the CPU's own bf16
     rounding error there (against the CPU's fp32 step), whichever is
     larger, the updated parameters within 1e-2 of each leaf's largest
     entry.
 28. the ninth main path, data-parallel training with trainable BN:
     R50_DeAOTL at bf16, B=16, T=5, 465x465, MODEL_FREEZE_BN=False, 10
     steps through the Trainer as rank 0 of a world-size-1 NCCL process
     group (parallel.launch): gradients and logged stats all-reduced every
     step. Reported as 26 and beside its ms/step and peak memory (frozen
     BN, this call). Gates: 26's (loss falls, 54 and 30 bf16 flash
     launches a step, the checkpoints), every BN's running stats moved off
     their init and finite, metrics.jsonl holding a line per log step, the
     image log written, and the EMA checkpoint loaded strictly into the
     frozen serving model, which serves 5 frames through
     VOSInferEngine.step (the local kernel's launches asserted).
 29. one fp32 train step with MODEL_FREEZE_BN=False, card against CPU, as
     11 (deterministic, float frames): BN weight and bias among the
     gradients, the running stats within 1e-5 of each channel's spread
     (|d mean| / sqrt(var), |d var| / var). With trainable BN at seeded
     weights the step's gradients move far beyond fp32 rounding when the
     frames move by 1e-6 relative (on the CPU, in aot_tpu too), so the
     grad norm and gradient gates are phase 11's or twice the CPU's own
     move under that change, whichever is larger, and parameters whose
     card and CPU gradients differ by more than half get two LR units.
 30. data-parallel equality on the card: AOTT, fp32, TF32 off,
     MODEL_FREEZE_BN=False, deterministic, one step by one process at
     B=16 against one step by two gloo ranks (spawned processes) of B=8
     on the same card: loss and grad norm within 1e-5 relative, running
     stats within 1e-5 of each channel's spread, the updated parameters
     within a quarter of one LR unit (two where Adam's first update may
     flip), the ranks' models identical.
 31. the attention knobs on the card (ops.attention.set_attn_impl through
     the config's ATTN_IMPL, applied by build_infer_engine): AOTT at
     465x465, the reference frame and KNOB_STEPS steps under each of
     'auto', 'reference' and 'pallas'; launches asserted as the modes
     route them: 'auto' the local kernel on every LSTT forward and no
     flash launch (900 LT keys), 'reference' no kernel launch at all,
     'pallas' the local kernel as 'auto' and the flash forward on both
     global reads of every forward (the self-attention and the LT read,
     900 keys each); each mode's masks against 'auto's (>= 99.9%). The
     mode is set back to 'auto'.
 32. the entry points on the card. A written Demo folder (DEMO_SEQS: 32
     frames with 3 objects and 8 frames with 2, 854x480 JPEGs, the first
     mask of each) served by `python -m aot_tpu_torch.tools.demo`'s main at
     R50_DeAOTL (inference.sh's model) at --max_resolution 480 (449x801, a
     29x51 = 1,479-token grid; the demo never grows its 4-frame LT ring)
     three times: fp32 per frame, fp32 with --frame_chunk 4, and --amp
     (phases 2 and 19 hold #1 and #1b at its 29x51 grid and #5b at its LT
     reads, Lq 1,479 over a 5,916-key ring with 4,437 and 5,916 keys
     live). Each run's launches asserted from the LT schedule (fp32: the
     local kernel on every LSTT forward, no flash launch below 8,192
     live keys; --amp: the bf16 local kernel, and the bf16 flash forward
     on every LT read of >= 4,096 live keys), one PNG and one MJPG video
     frame a frame, ms/frame and FPS by the demo's own clock; the chunked
     PNGs equal the per-frame ones; the first DEMO_CPU_FRAMES frames
     against the port's demo on the CPU (MASK_AGREE a frame). Then
     `python -m aot_tpu_torch.tools.score --json` on the fp32 run against
     every frame's label; ProfilerHook around 3 demo frames, whose Chrome
     trace must name the fp32 local kernel, and the card's busy time a
     frame read from it beside the demo's own clock;
     `python -m aot_tpu_torch.tools.overfit_check` at AOTT, B=4, crop 257,
     200 steps on an npz of seeded ellipse clips: the logged IoU must rise
     (the tool's 0.25 verdict is printed, not gated).
 33. one JSON line with the kernels (the bf16 instantiations as entries of
     their own; launches summed over the main paths; each kernel's time,
     plain time, bound and library time at its main shape), the card line,
     and last the result line {"ok": true, "device": {...}}; every kernel
     must have been launched by a main path.
 34. (run with the kernel checks, after 24) Swin's window kernel
     (csrc/swin_window_attn.cu) with the block's qkv and output
     projections against the block's plain path (pad, roll, partition,
     reverse; max abs error <= 1e-4) at Swin-B's three stage maps at DAVIS
     480p (120x212, 60x106, 30x53: 480x848 frames) and at 464x464
     (116x116, 58x58, 29x29), shifted and unshifted, B = 1 and 2; at the
     480p stages, shifted, the kernel and its plain version
     (swin_window_attention_plain) on the same qkv timed as 3, beside
     F.scaled_dot_product_attention over the windows already partitioned
     with the bias and mask as a float mask, and the bound; and, on a line
     of their own, the block's kernel route (qkv, kernel, proj) against
     its plain path (pad, roll, partition, qkv, read, proj, reverse).
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SIZE = 465          # DAVIS 480p eval size, stride-16 snapped
OBJECTS = 10
WARMUP = 5
STEPS = 105         # steps of each main-path run, warm-up included
CPU_STEPS = 3
KERNEL_TOL = 1e-4   # fp32, only the summation order differs
LOGIT_TOL = 1e-3    # ~20 conv layers: cuDNN vs oneDNN summation order
MASK_AGREE = 0.999  # argmax near-ties may flip a few pixels
MIN_LT_FRAMES_CPU = 10  # DeAOTL's card-vs-CPU check reads the flash path
VARIANT_STEPS = 5   # phase 18's steps of each variant, after its reference frame
PROFILE_STEPS = 10  # --profile-serve: steps in each profiled window
BWD_TOL = 1e-4      # of each gradient's largest entry: fp32, summation order
TRAIN_BATCH = 16    # AOTT's training batch (configs TRAIN_BATCH_SIZE)
TRAIN_T = 5         # DATA_SEQ_LEN
TRAIN_OBJECTS = 5
TRAIN_WARMUP = 3
TRAIN_STEPS = 15    # warm-up included
DEAOT_TRAIN_BATCH = 16    # phase 26: R50_DeAOTL at AOTT's training batch
DEAOT_TRAIN_STEPS = 10
TRAIN_SCHEDULE = 1000  # TRAIN_TOTAL_STEPS: the LR, aux-weight and hard-mining
                       # schedules' length; the steps run stay in its warm-up
CMP_SIZE, CMP_BATCH, CMP_T = 97, 2, 3   # phase 11
STATS_TOL = 1e-5     # BN running stats, of each channel's spread (29, 30)
EVAL_SIZE = (1080, 1920)  # DAVIS 2017 Full-Resolution frames
EVAL_GRID = (64, 113)     # at --max_resolution 1080: 1009x1793 input
EVAL_FRAMES = 9           # the reference frame, then 8 timed by the evaluator
EVAL_OBJECTS = 5
EVAL_WARMUP = 3           # of the evaluator's timed frames

# H100 SXM peaks (NVIDIA's data sheet). The flash kernels compute fp32
# products to fp32 accuracy on the TF32 tensor cores, as three TF32
# products each (3xTF32: 495 TFLOP/s dense / 3); the card's fp32 rate
# outside the tensor cores is 67 TFLOP/s. The faster of the two is the
# least time any kernel could take for fp32-accurate work, so every row's
# bound uses it and no kernel reads faster than its bound. A kernel's bound
# is the larger of its operations over that rate and its bytes (each input
# read once, each output written once) over the HBM3 bandwidth.
PEAK_FP32_ACCURATE_TC_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
# bf16 serving (phases 19-22): the same work on bf16 operands could run at
# the dense bf16 tensor-core rate, and moves half the bytes of q, k, v and
# out
PEAK_BF16_TC_FLOPS = 989e12
BF16_TOL = 1e-2       # of the largest entry: bf16 kernel vs bf16 plain
BATCH_TOL = 1e-4      # phase 21: a batch row's logits vs the video alone

# kernel name -> (the launch counter its wrapper counts, utils/tracing.py
# `launch.<name>`; the TPU kernel it replaces; its source csrc/<source>.cu).
# The local-window kernel serves every dilation-1 grid: it replaces both TPU
# kernels that the JAX package splits at 2,500 query tokens.
KERNELS = {
    "local_window_attn": ("launch.local_window_attn",
                          "aot_tpu/ops/pallas/local_window_attn.py:414, :236",
                          "local_window_attn_tc"),
    "flash_attn_fwd": ("launch.flash_attn_fwd",
                       "aot_tpu/ops/pallas/flash_attn_vjp.py:51",
                       "flash_attn_fwd"),
    "flash_attn_bwd": ("launch.flash_attn_bwd",
                       "aot_tpu/ops/pallas/flash_attn_vjp.py:267",
                       "flash_attn_bwd"),
    # the bf16 instantiations (bf16 serving), each with its own count
    "local_window_attn_bf16": ("launch.local_window_attn_bf16",
                               "aot_tpu/ops/pallas/local_window_attn.py:414, "
                               ":236", "local_window_attn_bf16"),
    "flash_attn_fwd_bf16": ("launch.flash_attn_fwd_bf16",
                            "aot_tpu/ops/pallas/flash_attn_vjp.py:51",
                            "flash_attn_fwd_bf16"),
    # the bf16 instantiation of the backward (bf16 training)
    "flash_attn_bwd_bf16": ("launch.flash_attn_bwd_bf16",
                            "aot_tpu/ops/pallas/flash_attn_vjp.py:267",
                            "flash_attn_bwd"),
    # Swin's window attention (fp32 serving), which replaces no TPU kernel:
    # the JAX package leaves it to XLA
    "swin_window_attn": ("launch.swin_window_attn",
                         "none (aot_tpu/models/encoders/swin.py, XLA)",
                         "swin_window_attn"),
}


def expected_launches(kernels, frames: int, flash_reads: int, layers: int,
                      bf16: bool = False, window_blocks: int = 0):
    """Launches by kernel name of `frames` LSTT forwards (one local read a
    block each) with `flash_reads` LT reads on the flash kernel, at fp32 or
    bf16, and of as many encoder passes with `window_blocks` Swin blocks
    (the window kernel at fp32 only)."""
    want = {name: 0 for name in kernels}
    sfx = "_bf16" if bf16 else ""
    want["local_window_attn" + sfx] = frames * layers
    want["flash_attn_fwd" + sfx] = flash_reads * layers
    if not bf16:
        want["swin_window_attn"] = frames * window_blocks
    return want


def swin_blocks(model) -> int:
    """The Swin blocks of the model's encoder (22 for Swin-B), else 0."""
    layers = getattr(model.encoder, "layers", None)
    if not hasattr(model.encoder, "patch_embed") or layers is None:
        return 0
    return sum(len(layer.blocks) for layer in layers)


def kernel_counters():
    """kernel name -> the name of its launch counter."""
    return {name: counter for name, (counter, _, _) in KERNELS.items()}


def reset_counts(kernels) -> None:
    """Zero the program's counters (only the launch counts are read
    here)."""
    from aot_tpu_torch.utils import tracing

    del kernels
    tracing.reset_counters()


def read_counts(kernels):
    from aot_tpu_torch.utils import tracing

    now = tracing.counters()
    return {name: now.get(counter, 0) for name, counter in kernels.items()}


def restore_counts(kernels, counts) -> None:
    """Set the launch counts back (a check's own launches are not the
    path's)."""
    from aot_tpu_torch.utils import tracing

    tracing.reset_counters()
    for name, counter in kernels.items():
        tracing.count(counter, counts[name])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_video(seed: int, frames: int, size: int, objects: int):
    """Seeded clip: a smooth noisy background and `objects` ellipses of
    distinct colours moving in straight lines. Returns uint8 frames
    (T, 1, H, W, 3) and the first frame's mask (1, H, W) int64."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack([yy / size, xx / size, (yy + xx) / (2 * size)], -1) * 160
    centre = rng.uniform(0.2, 0.8, (objects, 2)) * size
    radius = rng.uniform(0.04, 0.1, (objects, 2)) * size
    speed = rng.uniform(-2.0, 2.0, (objects, 2))
    colour = rng.uniform(40, 255, (objects, 3))
    video = np.empty((frames, 1, size, size, 3), np.uint8)
    mask = np.zeros((1, size, size), np.int64)
    for t in range(frames):
        img = base + rng.normal(0, 6, base.shape)
        for i in range(objects):
            cy, cx = centre[i] + t * speed[i]
            inside = (((yy - cy) / radius[i, 0]) ** 2
                      + ((xx - cx) / radius[i, 1]) ** 2) <= 1
            img[inside] = colour[i]
            if t == 0:
                mask[0][inside] = i + 1
        video[t, 0] = np.clip(img, 0, 255).astype(np.uint8)
    return video, mask


def to_device(arrays, device):
    return [None if a is None else
            torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def local_inputs(rng, b, hgt, wid, h, d, dv, with_rv, max_dis, device):
    hw, win2 = hgt * wid, (2 * max_dis + 1) ** 2
    return to_device([rng.randn(b, hw, h * d), rng.randn(b, hw, h * d),
                      rng.randn(b, hw, h * dv), 0.3 * rng.randn(b, h, hw, win2),
                      0.3 * rng.randn(h, dv, win2) if with_rv else None],
                     device)


def flash_inputs(rng, b, lq, lk, h, d, dv, valid, device, ring=0,
                 q_scale=1.0):
    """q, k, v, valid_len for the flash kernel. ring > 0 hands it k and v as
    the live prefix of a longer ring (batch stride > Lk rows), as the
    engine does; valid: None, an int, or a list (a (B,) int32 tensor).
    q_scale 1e-3 makes every softmax nearly flat (the weights nearly equal:
    the case where a running fp32 sum over the keys loses most)."""
    q, k, v = to_device([q_scale * rng.randn(b, lq, h * d),
                         rng.randn(b, lk + ring, h * d),
                         rng.randn(b, lk + ring, h * dv)], device)
    if isinstance(valid, list):
        valid = torch.tensor(valid, dtype=torch.int32, device=device)
    return q, k[:, :lk], v[:, :lk], valid


def check_kernel_numerics(lwa, fa, device):
    """Phase 2: each kernel vs its plain version on the card. Returns the
    max error by kernel name."""
    rng = np.random.RandomState(SEED)
    worst = check_local_numerics(lwa, device, rng)
    worst["flash_attn_fwd"] = check_flash_numerics(fa, device, rng)
    return worst


def check_local_numerics(lwa, device, rng):
    """Phase 2's local-window cases (csrc/local_window_attn_tc.cu). Returns
    the worst error by kernel name."""
    # name, B, H, W, heads, d, dv, rel_v, max_dis
    local_cases = [
        ("aott_st_b1", 1, 30, 30, 8, 32, 32, True, 7),
        ("aott_st_b2", 2, 30, 30, 8, 32, 32, True, 7),
        ("deaot_st_dv512", 1, 30, 30, 1, 128, 512, False, 7),
        ("deaot_st", 1, 30, 30, 1, 128, 1024, False, 7),
        # Swin-B's 464x464 grid: 29 is no multiple of the 16-pixel row
        ("swinb_aot_st_29x29", 1, 29, 29, 8, 32, 32, True, 7),
        ("swinb_deaot_st_29x29", 1, 29, 29, 1, 128, 1024, False, 7),
        # the demo's 449x801 input at --max_resolution 480 (phase 32)
        ("deaot_demo_29x51", 1, 29, 51, 1, 128, 1024, False, 7),
        ("aott_ragged_46x80", 1, 46, 80, 8, 32, 32, True, 7),
        ("aott_davis_1080p", 1, 64, 113, 8, 32, 32, True, 7),
        ("aott_68x120", 1, 68, 120, 8, 32, 32, True, 7),
        ("aott_720p_b2", 2, 43, 76, 8, 32, 32, True, 7),
        ("deaot_davis_1080p", 1, 64, 113, 1, 128, 1024, False, 7),
        ("aott_narrower_than_window", 1, 5, 3, 8, 32, 32, True, 7),
        # a window of one slot; a grid of one row (a 1-row tile, the other
        # halo rows off the image) at both heads; other radii and widths:
        # a 64-column value tile with rel_v in two chunks (one pass),
        # dv = 160 with rel_v (two passes, a partial second value tile),
        # d = 512 (two passes: q/k channels above 128, 1-row score tiles)
        # and d = 128 in 4-row one-pass tiles (the largest one-pass block)
        ("aott_max_dis0", 1, 30, 30, 8, 32, 32, True, 0),
        ("aott_one_row", 1, 1, 40, 8, 32, 32, True, 7),
        ("deaot_one_row", 1, 1, 40, 1, 128, 1024, False, 7),
        ("aott_max_dis3_17x23", 1, 17, 23, 8, 32, 32, True, 3),
        ("d64_dv64_rel_v", 1, 20, 37, 4, 64, 64, True, 5),
        ("d32_dv160_rel_v", 2, 19, 21, 2, 32, 160, True, 7),
        ("d512_two_passes", 1, 9, 21, 2, 512, 64, True, 7),
        ("d128_dv32_4_row_tiles", 1, 64, 113, 2, 128, 32, True, 7),
    ]
    # the TPU narrow kernel's test shapes (tests/test_local_window_kernel.py)
    for hgt, wid in ((10, 12), (9, 7), (8, 8)):
        for rv in (True, False):
            local_cases.append((f"narrow_{hgt}x{wid}", 2, hgt, wid, 2, 8, 8,
                                rv, 2))
    worst = 0.0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, b, hgt, wid, h, d, dv, rv, m in local_cases:
        args = local_inputs(rng, b, hgt, wid, h, d, dv, rv, m, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=m, d_att=d)
        want = lwa.local_window_attention_plain(*args, **kw)
        plan = lwa.launch_plan(b, h, hgt, wid, d, dv, m, sms)
        got = lwa.local_window_attention_cuda(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"phase 2: local_window_attn {name} B={b} {hgt}x{wid} h={h} "
              f"d={d} dv={dv} rel_v={rv} max_dis={m} (passes {plan.passes}, "
              f"rows {plan.rows}, blocks {plan.blocks}): max_abs_err "
              f"{err:.3e}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"local_window_attn {name}: kernel vs plain "
                                 f"{err} > {KERNEL_TOL}")
        worst = max(worst, err)
    return {"local_window_attn": worst}


def fwd_plan(fa, b, lq, lk, h, dv, device):
    """(key splits, score splits, slab) of a forward launch."""
    return fa.fwd_plan(b, lq, lk, h, dv, fa.sm_count(device))[:3]


def check_flash_numerics(fa, device, rng):
    """Phase 2's flash forward cases: kernel vs plain, out and lse, and the
    two-pass calls' counter. Returns the worst error."""
    from aot_tpu_torch.utils import tracing

    flash_cases = [  # name, B, Lq, Lk, heads, d, dv, valid_len, ring, q_scale
        ("deaotl_lk9000", 1, 900, 9000, 1, 128, 1024, 9000, 0, 1.0),
        # SwinB_DeAOTL's LT reads at 464x464: 841 queries over 10 and 21
        # frames of 841 keys
        ("swinb_deaotl_lk8410", 1, 841, 8410, 1, 128, 1024, 8410, 0, 1.0),
        ("swinb_deaotl_lk17661", 1, 841, 17661, 1, 128, 1024, [17661], 0,
         1.0),
        ("deaotl_1080p_two_slabs", 1, 7232, 14464, 1, 128, 1024, 14464, 0,
         1.0),
        ("deaotl_lk14400_live9900", 1, 900, 14400, 1, 128, 1024, [9900], 0,
         1.0),
        ("deaotl_b2_ring", 2, 900, 14400, 1, 128, 1024, [14400, 8100], 3600,
         1.0),
        ("deaotl_b2_empty", 2, 900, 9000, 1, 128, 1024, [9000, 0], 0, 1.0),
        ("deaotl_lk19800_near_flat", 1, 900, 19800, 1, 128, 1024, 19800, 0,
         1e-3),
        ("aot_heads_lk14400", 1, 900, 14400, 8, 32, 32, None, 0, 1.0),
        ("flash_mem_hw_check", 2, 900, 7200, 8, 32, 32, [7200, 4320], 0, 1.0),
        ("aott_train", 16, 900, 900, 8, 32, 32, None, 0, 1.0),
        ("aott_train_partial", 16, 900, 900, 8, 32, 32,
         [900 - 37 * i for i in range(16)], 0, 1.0),
        # B*h = 1 at AOT's width: 15 blocks, so 17 key splits of 4 tiles,
        # the last ones past the live keys (empty partials in the merge)
        ("split_keys_h1", 1, 900, 4000, 1, 32, 32, [2500], 0, 1.0),
        ("d64_dv64", 2, 300, 1000, 2, 64, 64, [1000, 700], 0, 1.0),
        # the P V pass's edges: a partial 256-column value tile at two
        # heads (each warpgroup's 128 columns, the second partly past dv);
        # B = 2 over several slabs, each with its own key splits' partials
        ("dv160_h2_partial_value_tile", 2, 130, 3000, 2, 32, 160,
         [3000, 1234], 0, 1.0),
        ("deaotl_b2_slabs_splits", 2, 1674, 20000, 1, 128, 1024,
         [20000, 13000], 0, 1.0),
    ]
    worst_flash = 0.0
    before = tracing.counters()
    pv_reads = pv_keys = 0
    for name, b, lq, lk, h, d, dv, valid, ring, q_scale in flash_cases:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device,
                                   ring, q_scale)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        plan = fwd_plan(fa, b, lq, lk, h, dv, device)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, vl, h, d)
        torch.cuda.synchronize()
        err = max((out - want_out).abs().max().item(),
                  (lse - want_lse).abs().max().item())
        del want_out, want_lse
        if name == "deaotl_b2_empty" and not (
                bool((out[1] == 0).all()) and bool((lse[1] == fa.NEG_INF).all())):
            raise AssertionError(f"{name}: an empty row is not out 0, lse -1e30")
        if name == "split_keys_h1" and plan[0] < 2:
            raise AssertionError(f"{name}: {plan} key split(s)")
        if name.endswith("_two_slabs") and -(-lq // plan[2]) != 2:
            raise AssertionError(f"{name}: slab {plan[2]} of {lq} rows")
        if name.endswith("_slabs_splits") and not (
                -(-lq // plan[2]) > 1 and plan[0] > 1):
            raise AssertionError(f"{name}: plan {plan}")
        if dv > 128:
            pv_reads += 1
            pv_keys += valid if isinstance(valid, int) else lk
        shown = "(B,) partial" if isinstance(valid, list) and b > 2 else valid
        print(f"phase 2: flash_attn_fwd {name} B={b} Lq={lq} Lk={lk} h={h} "
              f"d={d} dv={dv} valid={shown} q_scale={q_scale}, key splits "
              f"(output, scores) and query slab {plan}: max_abs_err (out, "
              f"lse) {err:.3e}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
        worst_flash = max(worst_flash, err)
    after = tracing.counters()
    got = tuple(after.get(n, 0) - before.get(n, 0)
                for n in ("flash.fwd.pv", "flash.fwd.pv.keys"))
    print(f"phase 2: flash.fwd.pv counted {got[0]} reads over {got[1]} keys "
          f"(want {pv_reads}, {pv_keys})", flush=True)
    if got != (pv_reads, pv_keys):
        raise AssertionError(f"flash.fwd.pv counted {got}, want "
                             f"{(pv_reads, pv_keys)}")
    return worst_flash


def cuda_times_ms(fn, runs: int = 50, warmup: int = 10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_fns(fns, runs: int = 50, warmup: int = 10):
    """Median ms of each of `fns` (name -> callable), run in turns: the
    given order, then reversed (plain first and last)."""
    samples = {name: [] for name in fns}
    for name in list(fns) + list(reversed(list(fns))):
        samples[name] += cuda_times_ms(fns[name], runs, warmup)
    return {name: float(np.median(t)) for name, t in samples.items()}


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_FP32_ACCURATE_TC_FLOPS):
    """(ms, 'operations' or 'bytes'): the least time the card could take."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def local_bound(b, hgt, wid, h, d, dv, with_rv, max_dis=7, bf16=False):
    """Local-window attention: per head and query, 2d FLOPs of q.k and 2dv
    of p.v (2dv more for p.rel_v) for each window slot inside the image
    (slots outside are never read); q, k, v, rel_bias, rel_v read once and
    out written once; q, k, v and out fp32 (or bf16, at the bf16 rate),
    rel_bias and rel_v fp32."""
    r = np.arange(-max_dis, max_dis + 1)
    rows = ((np.arange(hgt)[:, None] + r) >= 0) & (
        (np.arange(hgt)[:, None] + r) < hgt)
    cols = ((np.arange(wid)[:, None] + r) >= 0) & (
        (np.arange(wid)[:, None] + r) < wid)
    slots = float(rows.sum()) * float(cols.sum())   # in-image (query, slot)
    flops = b * h * slots * (2 * d + 2 * dv * (2 if with_rv else 1))
    win2 = (2 * max_dis + 1) ** 2
    hw = hgt * wid
    elem = 2 if bf16 else 4
    nbytes = (elem * b * hw * h * (2 * d + 2 * dv)
              + 4 * (b * h * hw * win2 + (h * dv * win2 if with_rv else 0)))
    return bound(flops, nbytes,
                 PEAK_BF16_TC_FLOPS if bf16 else PEAK_FP32_ACCURATE_TC_FLOPS)


def flash_fwd_bound(b, lq, live, h, d, dv):
    """Attention over `live` keys: 2(d + dv) FLOPs per (query, live key,
    head); q, the live k and v read once, out and lse written once."""
    flops = 2.0 * b * h * lq * live * (d + dv)
    nbytes = 4 * (b * lq * h * (d + dv) + b * live * h * (d + dv) + b * h * lq)
    return bound(flops, nbytes)


def flash_fwd_bound_live(lq, live, h, d, dv, bf16=False):
    """flash_fwd_bound over a batch whose elements have their own live key
    counts `live` (dead keys are never read); bf16: q, k, v and out in
    bf16 (lse fp32), at the bf16 rate."""
    elem = 2 if bf16 else 4
    flops = sum(2.0 * h * lq * n * (d + dv) for n in live)
    nbytes = sum(elem * (lq * h * (d + dv) + n * h * (d + dv)) + 4 * h * lq
                 for n in live)
    return bound(flops, nbytes,
                 PEAK_BF16_TC_FLOPS if bf16 else PEAK_FP32_ACCURATE_TC_FLOPS)


def flash_bwd_bound(b, lq, live, h, d, dv):
    """Its backward: S = QK^T and dP = dO V^T recomputed, dV = P^T dO,
    dQ = dS K, dK = dS^T Q: 2(3d + 2dv) FLOPs per (query, live key, head);
    q, k, v, out, dout, lse read once, dq, dk, dv written once."""
    flops = 2.0 * b * h * lq * live * (3 * d + 2 * dv)
    nbytes = 4 * (b * lq * h * (2 * d + 2 * dv) + 2 * b * live * h * (d + dv)
                  + b * h * lq)
    return bound(flops, nbytes)


def flash_bwd_bound_live(lq, live, h, d, dv, bf16=False):
    """flash_bwd_bound over a batch whose elements have their own live key
    counts `live`; bf16: q, k, v, out, dout and the gradients in bf16 (lse
    fp32), at the bf16 rate."""
    elem = 2 if bf16 else 4
    flops = sum(2.0 * h * lq * n * (3 * d + 2 * dv) for n in live)
    nbytes = sum(elem * (lq * h * (2 * d + 2 * dv) + 2 * n * h * (d + dv))
                 + 4 * h * lq for n in live)
    return bound(flops, nbytes,
                 PEAK_BF16_TC_FLOPS if bf16 else PEAK_FP32_ACCURATE_TC_FLOPS)


def sdpa_args(q, k, v, vl, h, d):
    """F.scaled_dot_product_attention's layout of the flash inputs: (B, h,
    L, c) copies and a boolean live-key mask (B, 1, 1, Lk)."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    dv = v.shape[-1] // h
    split = lambda x, c: x.reshape(b, -1, h, c).transpose(1, 2).contiguous()
    live = torch.full((b,), lk, device=q.device) if vl is None else (
        torch.as_tensor(vl, device=q.device).reshape(-1).expand(b))
    mask = (torch.arange(lk, device=q.device)[None] < live[:, None])
    return split(q, d), split(k, d), split(v, dv), mask[:, None, None, :]


def sdpa_backend(qs, ks, vs, mask) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(qs, ks, vs, mask)).name


def dense_window_bias(rel_bias, hgt, wid, max_dis):
    """The (B, h, HW, HW) additive bias under which dense softmax attention
    is the local-window attention without rel_v: rel_bias at each query's
    in-image window slots, -inf elsewhere (F.scaled_dot_product_attention's
    float attn_mask)."""
    b, h, hw, win2 = rel_bias.shape
    dev = rel_bias.device
    r = torch.arange(-max_dis, max_dis + 1, device=dev)
    ky = torch.arange(hgt, device=dev)[:, None, None, None] + r[:, None]
    kx = torch.arange(wid, device=dev)[None, :, None, None] + r
    ok = ((ky >= 0) & (ky < hgt) & (kx >= 0) & (kx < wid)).reshape(hw, win2)
    # off-image slots go to a spare column HW, cut off afterwards
    key = torch.where(ok, (ky * wid + kx).reshape(hw, win2), hw)
    bias = torch.full((b, h, hw, hw + 1), float("-inf"), device=dev)
    bias.scatter_(3, key.expand(b, h, hw, win2).contiguous(), rel_bias)
    return bias[..., :hw].contiguous()


def time_local(lwa, device, card: str, rng):
    """Phase 3's local-window timings at the serving shapes, beside the
    plain version; at DeAOT's head (no rel_v) also beside
    F.scaled_dot_product_attention with the dense window bias (the library
    yardstick, its backend and its error against plain printed). Returns
    {label: (kernel ms, plain ms, library ms or None, (bound ms, by))}."""
    import torch.nn.functional as F

    out = {}
    for label, hgt, wid, h, d, dv, rv in (
            ("AOTT 465x465 ST", 30, 30, 8, 32, 32, True),
            ("DeAOT 465x465 ST", 30, 30, 1, 128, 1024, False),
            ("AOT head Swin-B 464x464 ST", 29, 29, 8, 32, 32, True),
            ("DeAOT Swin-B 464x464 ST", 29, 29, 1, 128, 1024, False),
            ("AOTT DAVIS 1080p ST", 64, 113, 8, 32, 32, True),
            ("DeAOT DAVIS 1080p ST", 64, 113, 1, 128, 1024, False)):
        args = local_inputs(rng, 1, hgt, wid, h, d, dv, rv, 7, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        fns = {"plain": lambda: lwa.local_window_attention_plain(*args, **kw),
               "kernel": lambda: lwa.local_window_attention_cuda(*args, **kw)}
        lib_note = ""
        if not rv:
            q, k, v, rel_bias, _ = args
            split = lambda x, c: x.reshape(1, -1, h, c).transpose(1, 2)
            qs, ks, vs = split(q, d).contiguous(), split(k, d).contiguous(), \
                split(v, dv).contiguous()
            bias = dense_window_bias(rel_bias, hgt, wid, 7)
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=bias)
        t = time_fns(fns, *((20, 3) if (hgt, wid) == EVAL_GRID else ()))
        if "library" in fns:
            lib_err = (fns["library"]().transpose(1, 2).reshape(
                1, hgt * wid, h * dv) - fns["plain"]()).abs().max().item()
            lib_note = (f", F.scaled_dot_product_attention with the dense "
                        f"window bias ({sdpa_backend(qs, ks, vs, bias)}) "
                        f"{t['library']:.4f} ms (vs plain {lib_err:.1e})")
            del bias
        b_ms, b_by = local_bound(1, hgt, wid, h, d, dv, rv)
        plan = lwa.launch_plan(1, h, hgt, wid, d, dv, 7,
                               torch.cuda.get_device_properties(
                                   device).multi_processor_count)
        print(f"phase 3: local window {label} {hgt}x{wid} h={h} d={d} "
              f"dv={dv} B=1 (passes {plan.passes}, rows "
              f"{plan.rows}, blocks {plan.blocks}): kernel {t['kernel']:.4f} "
              f"ms, plain {t['plain']:.4f} ms{lib_note}; bound {b_ms:.4f} ms "
              f"({b_by}) ({card})", flush=True)
        out[label] = (t["kernel"], t["plain"], t.get("library"), (b_ms, b_by))
    # the TPU narrow kernel's test shapes (row #3 of PERF.md's table: the
    # kernel that closes it)
    for hgt, wid in ((10, 12), (9, 7), (8, 8)):
        args = local_inputs(rng, 2, hgt, wid, 2, 8, 8, True, 2, device)
        kw = dict(num_heads=2, size_2d=(hgt, wid), max_dis=2, d_att=8)
        t = time_fns({
            "plain": lambda: lwa.local_window_attention_plain(*args, **kw),
            "kernel": lambda: lwa.local_window_attention_cuda(*args, **kw)})
        b_ms, b_by = local_bound(2, hgt, wid, 2, 8, 8, True, 2)
        print(f"phase 3: local window narrow kernel's test shape {hgt}x{wid} "
              f"B=2 h=2 d=dv=8 max_dis=2 rel_v: kernel {t['kernel']:.4f} ms, "
              f"plain {t['plain']:.4f} ms; bound {b_ms:.6f} ms ({b_by}) "
              f"({card})", flush=True)
    return out


def time_kernels(lwa, fa, device, card: str):
    """Phase 3. Returns {name: (kernel ms, plain ms, library ms or None,
    (bound ms, what bounds it))}
    at the shapes the JSON line reports: the local kernel at AOTT's 465x465
    ST shape (no PyTorch call adds rel_v: no library time), the flash
    forward at DeAOTL's longest LT read."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 1)
    local = time_local(lwa, device, card, rng)
    times = {"local_window_attn": local["AOTT 465x465 ST"]}
    # the forward at AOTT's training shape, at DeAOTL's LT reads at 465x465
    # (the JSON line's row: Lk = 19,800) and at DAVIS 1080p (two slabs)
    for label, b, lq, lk, h, d, dv in (
            ("AOTT training", 16, 900, 900, 8, 32, 32),
            ("flash_mem hw_check", 2, 900, 7200, 8, 32, 32),
            ("DeAOTL LT", 1, 900, 9000, 1, 128, 1024),
            ("DeAOTL LT", 1, 900, 19800, 1, 128, 1024),
            ("SwinB_DeAOTL LT", 1, 841, 17661, 1, 128, 1024),
            ("DeAOTL 1080p LT", 1, 7232, 14464, 1, 128, 1024),
            # r50_deaotl.longstream480's LT read: 64 frames of 1,674 keys
            ("R50_DeAOTL 480p LT, 64 frames", 1, 1674, 107136, 1, 128,
             1024)):
        # hw_check (row #4 of PERF.md's table): live lengths 7,200 / 4,320
        vl = ([7200, 4320] if label == "flash_mem hw_check"
              else None if b > 1 else lk)
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, vl, device)
        qs, ks, vs, mask = sdpa_args(q, k, v, vl, h, d)
        t = time_fns({
            "plain": lambda: fa.flash_attention_plain(q, k, v, vl, h, d),
            "kernel": lambda: fa.flash_attention_cuda(q, k, v, vl, h, d),
            "library": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)}, *((20, 3) if lq > 900 else ()))
        lib_err = (F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
                   .transpose(1, 2).reshape(b, lq, h * dv)
                   - fa.flash_attention_plain(q, k, v, vl, h, d)[0]
                   ).abs().max().item()
        b_ms, b_by = (flash_fwd_bound(b, lq, lk, h, d, dv) if vl is None
                      or not isinstance(vl, torch.Tensor) else
                      flash_fwd_bound_live(lq, vl.tolist(), h, d, dv))
        err = ""
        if lk > 100000:
            # the kernel against its plain version under phase 2's gate
            got, got_lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
            want, want_lse = fa.flash_attention_plain(q, k, v, vl, h, d)
            e = max((got - want).abs().max().item(),
                    (got_lse - want_lse).abs().max().item())
            err = f"; max_abs_err (out, lse) vs plain {e:.3e}"
            del got, got_lse, want, want_lse
            if not e <= KERNEL_TOL:
                raise AssertionError(f"phase 3 {label}: kernel vs plain {e} "
                                     f"> {KERNEL_TOL}")
        print(f"phase 3: flash_attn_fwd {label} shape B={b} Lq={lq} Lk={lk} "
              f"h={h} d={d} dv={dv} (key splits (output, scores) and query "
              f"slab {fwd_plan(fa, b, lq, lk, h, dv, device)}): kernel "
              f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"F.scaled_dot_product_attention with a boolean live-key mask "
              f"({sdpa_backend(qs, ks, vs, mask)}) {t['library']:.4f} ms (vs "
              f"plain {lib_err:.1e}); bound {b_ms:.4f} ms ({b_by}){err} "
              f"({card})", flush=True)
        if lk == 19800:
            times["flash_attn_fwd"] = (t["kernel"], t["plain"], t["library"],
                                       (b_ms, b_by))
        del q, k, v, qs, ks, vs
    return times


# Swin-B's window reads (phase 34): (label, token grid, channels, heads) of
# its three stages at DAVIS 480p (480x848 frames, MODEL_ALIGN_CORNERS=False)
# and at phase 16's 464x464
WINDOW_SHAPES = (("480p stage 1", (120, 212), 128, 4),
                 ("480p stage 2", (60, 106), 256, 8),
                 ("480p stage 3", (30, 53), 512, 16),
                 ("464 stage 1", (116, 116), 128, 4),
                 ("464 stage 2", (58, 58), 256, 8),
                 ("464 stage 3", (29, 29), 512, 16))


def window_bound(b, hgt, wid, heads, d=32, window=7):
    """A Swin window read: per head and in-image query 4 window^2 d FLOPs;
    the in-image tokens' q, k, v and out once each and the bias table."""
    flops = 4.0 * window * window * d * heads * b * hgt * wid
    nbytes = 4.0 * (4 * b * hgt * wid * heads * d
                    + (2 * window - 1) ** 2 * heads)
    return bound(flops, nbytes)


def seeded_window_block(dim: int, heads: int, shift: int, device):
    """A Swin block (models/encoders/swin.py) with weights drawn from
    SEED: matrices at variance 1 / fan-in, vectors at 0.3."""
    from aot_tpu_torch.models.encoders.swin import SwinBlock

    blk = SwinBlock(dim, heads, 7, shift).to(device).eval()
    g = torch.Generator(device=device).manual_seed(SEED + shift)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=device)
                    * (p.shape[-1] ** -0.5 if p.ndim > 1 else 0.3))
    return blk


def check_window_kernel(device, card: str):
    """Phase 34: the window kernel (csrc/swin_window_attn.cu, through
    ops.attention.window_attention) with the block's qkv and output
    projections against the block's plain path (pad, roll, partition,
    the qkv product on the padded map, reverse) at WINDOW_SHAPES, shifted
    and unshifted, B = 1 and 2 (max abs error <= KERNEL_TOL); then at the
    480p stages, shifted, B=1, the kernel and its plain version
    (swin_window_attention_plain, the same function) on the same qkv
    timed as phase 3, beside F.scaled_dot_product_attention over the
    windows already partitioned with the bias and mask as a float mask
    (the library yardstick of the read alone) and the read's bound; and
    the block's kernel route (qkv, kernel, proj) against its plain path.
    Returns (max error, the JSON line's times at stage 3: its 18 blocks
    take most of the encoder's windows)."""
    import torch.nn.functional as F

    from aot_tpu_torch.models.encoders import swin
    from aot_tpu_torch.ops import attention
    from aot_tpu_torch.ops.kernels import swin_window_attn as swa

    worst, times = 0.0, None
    for label, (hgt, wid), dim, heads in WINDOW_SHAPES:
        for shift in (0, 3):
            blk = seeded_window_block(dim, heads, shift, device)
            a = blk.attn
            for b in (1, 2):
                x = torch.randn(b, hgt * wid, dim, device=device,
                                generator=torch.Generator(device=device)
                                .manual_seed(SEED + b))
                with torch.inference_mode():
                    y = blk.norm1(x)
                    qkv = a.qkv(y)

                    def read():
                        return attention.window_attention(
                            qkv, a.qkv.bias, a.relative_position_bias_table,
                            num_heads=heads, size_2d=(hgt, wid), window=7,
                            shift=shift)

                    want = blk._windowed(y, (hgt, wid))
                    got = a.proj(read())
                    err = (got - want).abs().max().item()
                    rel = err / want.abs().max().item()
                    print(f"phase 34: swin_window_attn {label} {hgt}x{wid} "
                          f"C={dim} h={heads} shift={shift} B={b}: max abs "
                          f"err vs the plain path {err:.3e} ({rel:.2e} of "
                          f"its largest entry)", flush=True)
                    if not err <= KERNEL_TOL:
                        raise AssertionError(f"phase 34 {label}: {err}")
                    worst = max(worst, err)
                    if b != 1 or shift == 0 or not label.startswith("480p"):
                        continue
                    # the library yardstick: the read alone over windows
                    # already partitioned, bias and mask as a float mask
                    hp, wp = -(-hgt // 7) * 7, -(-wid // 7) * 7
                    pad = F.pad(y.view(1, hgt, wid, dim),
                                (0, 0, 0, wp - wid, 0, hp - hgt))
                    win = swin.window_partition(
                        torch.roll(pad, (-shift, -shift), (1, 2)), 7)
                    q, k, v = a.qkv(win).view(-1, 49, 3, heads, 32).permute(
                        2, 0, 3, 1, 4)
                    bias = a.relative_position_bias_table[
                        swin._relative_index_on(7, device)].view(
                            49, 49, heads).permute(2, 0, 1)
                    mask = torch.from_numpy(swin.shift_attn_mask(
                        hp, wp, 7, shift)).to(device)
                    dense = (bias[None] + mask[:, None]).contiguous()
                    t = time_fns({
                        "plain": lambda: swa.swin_window_attention_plain(
                            qkv, a.qkv.bias, a.relative_position_bias_table,
                            num_heads=heads, size_2d=(hgt, wid), window=7,
                            shift=shift),
                        "kernel": read,
                        "library": lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=dense),
                        "route": lambda: a.proj(attention.window_attention(
                            a.qkv(y), a.qkv.bias,
                            a.relative_position_bias_table, num_heads=heads,
                            size_2d=(hgt, wid), window=7, shift=shift)),
                        "block plain": lambda: blk._windowed(y, (hgt, wid))})
                    b_ms, b_by = window_bound(1, hgt, wid, heads)
                    print(f"phase 34: swin_window_attn {label} {hgt}x{wid} "
                          f"h={heads} shift 3 B=1: kernel {t['kernel']:.4f} "
                          f"ms, its plain version on the same qkv "
                          f"{t['plain']:.4f} ms, F.scaled_dot_product_"
                          f"attention over partitioned windows with a float "
                          f"bias mask ({sdpa_backend(q, k, v, dense)}) "
                          f"{t['library']:.4f} ms; bound {b_ms:.4f} ms "
                          f"({b_by}) ({card})", flush=True)
                    print(f"phase 34: Swin block attention {label} "
                          f"{hgt}x{wid} h={heads} shift 3 B=1: kernel route "
                          f"(qkv, kernel, proj) {t['route']:.4f} ms, plain "
                          f"path (pad, roll, partition, qkv, read, proj, "
                          f"reverse) {t['block plain']:.4f} ms ({card})",
                          flush=True)
                    if label == "480p stage 3":
                        times = (t["kernel"], t["plain"], t["library"],
                                 (b_ms, b_by))
    return worst, times


def check_step_outputs(pred, logits, size: int):
    grid = (size - 1) // 4 + 1    # the decoder's 4x map: 117 at 465, 116 at 464
    if tuple(pred.shape) != (1, size, size):
        raise AssertionError(f"pred shape {tuple(pred.shape)}")
    if tuple(logits.shape) != (1, grid, grid, OBJECTS + 1):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    if int(pred.max()) > OBJECTS or int(pred.min()) < 0:
        raise AssertionError(f"labels outside 0..{OBJECTS}")


def grow_then_step(eng, shadow, state, frame, t, output_size):
    """One frame of the evaluator's loop (aot_tpu/eval/evaluator.py:
    233-256): grow the LT ring before a step that writes it, step, mirror
    the write schedule."""
    if shadow.will_write(t):
        state = eng.ensure_lt_capacity(state, shadow.count + 1)
    state, pred, logits = eng.step(state, frame, output_size)
    shadow.update(t)
    return state, pred, logits


def seeded_model(cfg, device):
    """The serving model with weights drawn from SEED."""
    from aot_tpu_torch.models import build_vos_model

    return build_vos_model(cfg, device=device,
                           generator=torch.Generator().manual_seed(SEED))


def run_main_path(model, cfg, video, mask, steps: int, kernels,
                  size: int = SIZE, preds=None):
    """Phases 4, 6, 14, 16, 18 and 20 at `size` x `size` (the video's
    frames), on the model's device, in its compute dtype. Returns (engine,
    state, shadow, per-step seconds, per-step flash flags, launches by
    kernel name); each step's mask is appended to `preds` (a list) when
    one is given, outside the timed region."""
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.ops.attention import use_flash

    device = next(model.parameters()).device
    eng = build_infer_engine(model, cfg)
    frames = torch.from_numpy(video[:steps + 1]).to(device)  # one upload
    ref_mask = torch.from_numpy(mask).to(device)
    hw = grid_side(size) ** 2
    shadow = eng.make_shadow()
    # a CPU device only rehearses the loop (no kernel runs there)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()

    reset_counts(kernels)
    state = eng.add_reference_frame(frames[0], ref_mask, OBJECTS)
    shadow.add_ref(0)
    seconds, flash_steps = [], []
    for t in range(1, steps + 1):
        # the LT read of step t sees the frames written before it
        live = shadow.count * hw
        flash_steps.append(use_flash(live, live, eng.engine.top_k,
                                     eng.engine.max_mem_len_ratio,
                                     model.compute_dtype))
        t0 = time.perf_counter()
        state, pred, logits = grow_then_step(eng, shadow, state, frames[t], t,
                                             (size, size))
        sync()
        seconds.append(time.perf_counter() - t0)
        check_step_outputs(pred, logits, size)   # outside the timed region
        if preds is not None:
            preds.append(pred.to(torch.uint8).cpu())
    launches = read_counts(kernels)
    return eng, state, shadow, seconds, flash_steps, launches


def compare_with_cpu(cfg, model, eng, state, shadow, video, label: str,
                     size: int = SIZE):
    """Phases 5, 7, 15 and 17: the same steps from the same state on the
    card and on the CPU (plain path). Returns (max logit error, min mask
    agreement)."""
    from aot_tpu_torch.engine import build_infer_engine

    cpu_eng = build_infer_engine(copy.deepcopy(model).to("cpu"), cfg)
    cpu_state = state.to("cpu")
    cpu_shadow = copy.deepcopy(shadow)
    worst_err, worst_agree = 0.0, 1.0
    t0 = state.frame_step + 1
    for t in range(t0, t0 + CPU_STEPS):
        frame = torch.from_numpy(video[t])
        state, pred, logits = grow_then_step(
            eng, shadow, state, frame.to(state.obj_nums.device), t,
            (size, size))
        cpu_state, cpu_pred, cpu_logits = grow_then_step(
            cpu_eng, cpu_shadow, cpu_state, frame, t, (size, size))
        err = (logits.cpu() - cpu_logits).abs().max().item()
        agree = (pred.cpu() == cpu_pred).float().mean().item()
        print(f"phase {label}: frame {t}: card vs CPU logits max_abs_err "
              f"{err:.3e}, mask agreement {agree:.6f}", flush=True)
        worst_err, worst_agree = max(worst_err, err), min(worst_agree, agree)
    if not (worst_err <= LOGIT_TOL and worst_agree >= MASK_AGREE):
        raise AssertionError(
            f"card vs CPU: logits {worst_err} (limit {LOGIT_TOL}), masks "
            f"{worst_agree} (limit {MASK_AGREE})")
    return worst_err, worst_agree


def grid_side(size: int) -> int:
    """The 16x token grid's side at a size x size input: 30 at 465 (the
    align_corners sizes, 16k + 1), 29 at 464 (Swin-B's, 16k)."""
    return (size - 1) // 16 + 1


def drive(name, cfg, device, video, mask, kernels, card: str, phase: int,
          size: int = SIZE, preds=None, cpu_check: bool = True):
    """One main path (phase `phase`) and, with cpu_check, its card-vs-CPU
    check (the next phase). Returns (launches by kernel name, median and
    p90 ms/frame); the masks go to `preds` (run_main_path)."""
    torch.cuda.reset_peak_memory_stats()
    model = seeded_model(cfg, device)
    eng, state, shadow, seconds, flash_steps, launches = run_main_path(
        model, cfg, video, mask, STEPS, kernels, size, preds)
    grid = tuple(state.shortcuts[-1].shape[-2:])
    if grid != (grid_side(size),) * 2:
        raise AssertionError(f"{name}: grid {grid} at {size}x{size}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    bf16 = model.compute_dtype == torch.bfloat16
    want = expected_launches(kernels, STEPS + 1, sum(flash_steps),
                             cfg.MODEL_LSTT_NUM, bf16,
                             window_blocks=swin_blocks(model))
    print(f"phase {phase}: {name} kernel launches in the main path: "
          f"{launches} (expected from the LT schedule: {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want}")
    timed = np.asarray(seconds[WARMUP:]) * 1e3
    flags = np.asarray(flash_steps[WARMUP:])
    frame_ms = float(np.median(timed))
    print(f"phase {phase}: {name} {size}x{size} (grid {grid[0]}x{grid[1]}), "
          f"{OBJECTS} objects, {str(model.compute_dtype)[6:]}, outputs "
          f"checked at every step (shape, "
          f"finite logits, labels in range); {len(timed)} steps after "
          f"{WARMUP} warm-up: median "
          f"{frame_ms:.3f} ms/frame ({1e3 / frame_ms:.2f} FPS), p90 "
          f"{np.percentile(timed, 90):.3f} ms; LT frames at the end "
          f"{shadow.count}; peak memory {peak:.0f} MiB ({card})", flush=True)
    for label, sel in (("before", ~flags), ("after", flags)):
        if sel.any():
            print(f"phase {phase}: {name} {label} the flash switch: "
                  f"{int(sel.sum())} steps, median "
                  f"{float(np.median(timed[sel])):.3f} ms/frame ({card})",
                  flush=True)
    if not cpu_check:
        return launches, (frame_ms, float(np.percentile(timed, 90)))
    if sum(flash_steps) and shadow.count < MIN_LT_FRAMES_CPU:
        raise AssertionError(f"{name}: {shadow.count} LT frames at the end")
    compare_with_cpu(cfg, model, eng, state, shadow, video, str(phase + 1),
                     size)
    return launches, (frame_ms, float(np.percentile(timed, 90)))


# the reference repository's multi-object FPS on one V100 (bench.py:18
# BASELINES; its MODEL_ZOO), printed beside phase 18's times as that
V100_FPS = {
    "aott": 51.4, "aots": 40.0, "aotb": 29.6, "aotl": 18.7,
    "r50_aotl": 18.0, "r101_aotl": 18.0, "rs101_aotl": 18.0,
    "swinb_aotl": 12.1,
    "deaott": 53.4, "deaots": 38.7, "deaotb": 30.4, "deaotl": 24.7,
    "r50_deaotl": 22.4, "swinb_deaotl": 11.9,
}


def serving_size(cfg) -> int:
    """The evaluator's snap of the SIZE x SIZE frames for the model: 465
    with align_corners (16k + 1), 464 without (16k: Swin-B)."""
    from aot_tpu_torch.data.video_aug import restrict_size

    hgt, wid = restrict_size(SIZE, SIZE, 1.0, None, None,
                             cfg.MODEL_ALIGN_CORNERS)
    if hgt != wid:
        raise AssertionError(f"{SIZE}x{SIZE} snapped to {hgt}x{wid}")
    return hgt


def crop(video, mask, size: int):
    """The clip's top-left size x size (the 464 serving size of 465 frames)."""
    return (np.ascontiguousarray(video[:, :, :size, :size]),
            np.ascontiguousarray(mask[:, :size, :size]))


def run_variants(kernels, device, card: str, video, mask,
                 dtype: str = "float32", phase: int = 18):
    """Phase 18 (and, at bf16, 20): each of the 14 variants built from the
    seed, its state dict loaded back strictly, then the reference frame and
    VARIANT_STEPS steps at its serving size, 10 objects, in `dtype`.
    Returns the launches by kernel name, summed over the variants."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.utils.weights import load_reference_state_dict

    total = {name: 0 for name in kernels}
    for name, fps in V100_FPS.items():
        cfg = build_config(stage="pre_ytb_dav", model=name, TEST_DTYPE=dtype)
        size = serving_size(cfg)
        torch.cuda.reset_peak_memory_stats()
        model = seeded_model(cfg, device)
        load_reference_state_dict(model, {
            k: v.cpu().numpy() for k, v in model.state_dict().items()})
        _, state, _, seconds, flash_steps, launches = run_main_path(
            model, cfg, *crop(video, mask, size), VARIANT_STEPS, kernels,
            size)
        peak = torch.cuda.max_memory_allocated() / 2**20
        grid = tuple(state.shortcuts[-1].shape[-2:])
        layers = cfg.MODEL_LSTT_NUM
        want = expected_launches(kernels, VARIANT_STEPS + 1,
                                 sum(flash_steps), layers,
                                 dtype == "bfloat16",
                                 window_blocks=swin_blocks(model))
        if launches != want or grid != (grid_side(size),) * 2:
            raise AssertionError(f"{name}: launches {launches} != {want} "
                                 f"or grid {grid}")
        for k in kernels:
            total[k] += launches[k]
        frame_ms = float(np.median(seconds) * 1e3)
        print(f"phase {phase}: {cfg.MODEL_NAME} ({cfg.MODEL_ENCODER}, "
              f"{layers} blocks, {dtype}) {size}x{size}, grid "
              f"{grid[0]}x{grid[1]}, "
              f"outputs checked; launches {launches}; median "
              f"{frame_ms:.3f} ms/frame ({1e3 / frame_ms:.1f} FPS) over "
              f"{VARIANT_STEPS} steps; peak memory {peak:.0f} MiB ({card}); "
              f"the reference repository's 1xV100 FPS {fps}", flush=True)
        del model, state
        torch.cuda.empty_cache()
    return total


def bwd_slab(b, lq, lk, h, d, dv, dtype, device):
    """Query rows a slab of the flash backward's two-pass form (0: one
    pass), as the library plans it for this shape."""
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
    plan, _ = fab.launch_plan((b, h, lq, lk, d, dv, lk) + (0,) * 8, dtype,
                              fa.sm_count(device))
    return fab.plan_value(plan, "SLAB")


def check_bwd_numerics(fa, fab, device):
    """Phase 8: the backward kernels vs their plain version, gated on the
    error relative to each gradient's largest entry. Returns the worst
    absolute error."""
    rng = np.random.RandomState(SEED + 2)
    cases = [  # name, B, Lq, Lk, heads, d, dv, valid_len, q_scale
        ("aott_train", 16, 900, 900, 8, 32, 32, None, 1.0),
        ("aott_train_partial", 16, 900, 900, 8, 32, 32,
         [900 - 37 * i for i in range(16)], 1.0),
        ("hw_check", 2, 900, 7200, 8, 32, 32, [7200, 4320], 1.0),
        ("deaotl_lk9000", 1, 900, 9000, 1, 128, 1024, None, 1.0),
        ("deaotl_lk19800", 1, 900, 19800, 1, 128, 1024, [19800], 1.0),
        ("deaotl_lk19800_near_flat", 1, 900, 19800, 1, 128, 1024, None, 1e-3),
        ("deaotl_1080p_two_slabs", 1, 7232, 14464, 1, 128, 1024, None, 1.0),
        ("deaotl_b2_empty", 2, 900, 9000, 1, 128, 1024, [6300, 0], 1.0),
        ("d64_dv64", 2, 300, 1000, 2, 64, 64, [1000, 700], 1.0),
        ("empty_row", 2, 130, 200, 2, 32, 32, [200, 0], 1.0),
        ("deaot_self", 16, 900, 900, 1, 128, 1024, None, 1.0),
        ("aott_partial_tile", 2, 333, 1000, 8, 32, 32, [997, 613], 1.0),
    ]
    worst = 0.0
    for name, b, lq, lk, h, d, dv, valid, q_scale in cases:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device,
                                   q_scale=q_scale)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, lq, h * dv), dtype=torch.float32,
                            device=device)
        slab = bwd_slab(b, lq, lk, h, d, dv, torch.float32, device)
        if name.endswith("_two_slabs") and -(-lq // slab) != 2:
            raise AssertionError(f"{name}: slab {slab} of {lq} rows")
        got = fab.flash_attention_bwd_cuda(q, k, v, vl, out, lse, dout, h, d)
        again = fab.flash_attention_bwd_cuda(q, k, v, vl, out, lse, dout, h,
                                             d)
        want = fab.flash_attention_bwd_plain(q, k, v, vl, out, lse, dout, h,
                                             d)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two runs of the backward differ")
        errs, rels = [], []
        for g, w in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: non-finite gradient")
            errs.append((g - w).abs().max().item())
            rels.append(errs[-1] / max(w.abs().max().item(), 1e-30))
        for i, n in enumerate(valid if isinstance(valid, list) else []):
            if bool(got[1][i, n:].any()) or bool(got[2][i, n:].any()):
                raise AssertionError(f"{name}: element {i} has non-zero "
                                     "dk/dv beyond its live keys")
            if n == 0 and bool(got[0][i].any()):
                raise AssertionError(f"{name}: element {i} has no live key "
                                     "and non-zero dq")
        print(f"phase 8: flash_attn_bwd {name} B={b} Lq={lq} Lk={lk} h={h} "
              f"d={d} dv={dv} q_scale={q_scale}: max_abs_err (dq, dk, dv) "
              f"{errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e}; / max|grad| "
              f"{rels[0]:.3e} {rels[1]:.3e} {rels[2]:.3e} (tolerance "
              f"{BWD_TOL}); dead keys exact zeros; a second run "
              "bit-identical", flush=True)
        if not max(rels) <= BWD_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rels} > {BWD_TOL}")
        worst = max(worst, max(errs))
    return worst


def time_bwd(fa, fab, device, card: str):
    """Phase 9. Returns (kernel ms, plain ms, library ms, (bound ms, what
    bounds it)) at AOTT's training shape; the library yardstick is the
    autograd backward of F.scaled_dot_product_attention with a boolean
    live-key mask."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 3)
    result = None
    for label, b, lq, lk, h, d, dv in (
            ("AOTT training", 16, 900, 900, 8, 32, 32),
            ("DeAOTL LT", 1, 900, 19800, 1, 128, 1024),
            ("DeAOTL 1080p LT", 1, 7232, 14464, 1, 128, 1024)):
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, None, device)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, lq, h * dv), dtype=torch.float32,
                            device=device)
        args = (q, k, v, vl, out, lse, dout, h, d)
        qs, ks, vs, mask = sdpa_args(q, k, v, vl, h, d)
        backend = sdpa_backend(qs, ks, vs, mask)
        leaves = [x.requires_grad_() for x in (qs, ks, vs)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_dout = dout.reshape(b, lq, h, dv).transpose(1, 2)
        t = time_fns({
            "plain": lambda: fab.flash_attention_bwd_plain(*args),
            "kernel": lambda: fab.flash_attention_bwd_cuda(*args),
            "library": lambda: torch.autograd.grad(
                lib_out, leaves, lib_dout, retain_graph=True)},
            *((20, 3) if lq > 900 else ()))
        del lib_out, leaves, args, q, k, v, out, dout
        b_ms, b_by = flash_bwd_bound(b, lq, lk, h, d, dv)
        print(f"phase 9: flash_attn_bwd {label} shape B={b} Lq={lq} Lk={lk} "
              f"h={h} d={d} dv={dv}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, F.scaled_dot_product_attention backward "
              f"({backend}) {t['library']:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}) ({card})", flush=True)
        result = result or (t["kernel"], t["plain"], t["library"],
                            (b_ms, b_by))
    return result


# the bf16 backward's shapes on the training paths: AOTT's self-attention
# and LT reads (B=16, h=8, d=dv=32, Lq=Lk=900), DeAOT's GPM
# self-attention (h=1, d=128, dv=1024, Lq=Lk=900) and its LT read at
# TRAIN_LONG_TERM_MEM_GAP=2 (Lk=2,700 at the last frame of a 5-frame clip)
BF16_BWD_SHAPES = (("AOTT training", 16, 900, 900, 8, 32, 32),
                   ("DeAOT GPM self-attention", 16, 900, 900, 1, 128, 1024),
                   ("DeAOT LT read", 16, 900, 2700, 1, 128, 1024))


def bf16_bwd_inputs(fa, rng, b, lq, lk, h, d, dv, valid, device):
    """bf16 q, k, v, valid_len, the bf16 forward kernel's out and lse, and
    a bf16 dout; and the fp32 originals of q, k, v and dout."""
    q32, k32, v32, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device)
    do32 = torch.tensor(rng.randn(b, lq, h * dv), dtype=torch.float32,
                        device=device)
    q, k, v, dout = (x.to(torch.bfloat16) for x in (q32, k32, v32, do32))
    out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
    return (q, k, v, vl, out, lse, dout), (q32, k32, v32, do32)


def check_bf16_bwd(fa, fab, device):
    """Phase 23: the bf16 backward kernels against their bf16 plain version
    on the card: each gradient within BF16_TOL of its largest entry, exact
    zeros for dead keys (and for every gradient of an element with no live
    key), a second run bit-identical. Returns the worst error relative to
    the largest entry."""
    rng = np.random.RandomState(SEED + 4)
    cases = [  # name, B, Lq, Lk, heads, d, dv, valid_len
        ("aott_train", 16, 900, 900, 8, 32, 32, None),
        ("aott_train_partial", 16, 900, 900, 8, 32, 32,
         [900 - 37 * i for i in range(16)]),
        ("deaot_self", 16, 900, 900, 1, 128, 1024, None),
        ("deaot_lt2700", 16, 900, 2700, 1, 128, 1024, None),
        ("deaot_lt2700_partial", 16, 900, 2700, 1, 128, 1024,
         [2700 - 900 * (i % 3) - 7 * i for i in range(16)]),
        ("deaot_b2_empty", 2, 900, 2700, 1, 128, 1024, [1800, 0]),
        ("deaot_1080p_two_slabs", 1, 7232, 14464, 1, 128, 1024, None),
        ("empty_row", 2, 130, 200, 2, 32, 32, [200, 0]),
        ("aott_partial_tile", 2, 333, 1000, 8, 32, 32, [997, 613]),
        ("d64_dv64", 2, 300, 1000, 2, 64, 64, [1000, 700]),
    ]
    worst = 0.0
    for name, b, lq, lk, h, d, dv, valid in cases:
        args, _ = bf16_bwd_inputs(fa, rng, b, lq, lk, h, d, dv, valid,
                                  device)
        q, k, v, vl = args[:4]
        slab = bwd_slab(b, lq, lk, h, d, dv, torch.bfloat16, device)
        if name.endswith("_two_slabs") and -(-lq // slab) != 2:
            raise AssertionError(f"{name}: slab {slab} of {lq} rows")
        got = fab.flash_attention_bwd_cuda(*args, h, d)
        again = fab.flash_attention_bwd_cuda(*args, h, d)
        want = fab.flash_attention_bwd_plain(*args, h, d)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"phase 23 {name}: two runs differ")
        rels = []
        for g, w, x in zip(got, want, (q, k, v)):
            if g.dtype != torch.bfloat16 or g.shape != x.shape:
                raise AssertionError(f"phase 23 {name}: {g.dtype} {g.shape}")
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"phase 23 {name}: non-finite gradient")
            rels.append(rel_err(g, w))
        if isinstance(valid, list):
            for i, n in enumerate(valid):   # dead keys: exact zeros
                if bool(got[1][i, n:].any()) or bool(got[2][i, n:].any()):
                    raise AssertionError(f"phase 23 {name}: element {i} has "
                                         "non-zero dk/dv beyond its live keys")
                if n == 0 and bool(got[0][i].any()):
                    raise AssertionError(f"phase 23 {name}: element {i} has "
                                         "no live key and non-zero dq")
        print(f"phase 23: flash_attn_bwd_bf16 {name} B={b} Lq={lq} Lk={lk} "
              f"h={h} d={d} dv={dv} (slab {slab}): error (dq, dk, dv) / "
              f"max|grad| {rels[0]:.3e} {rels[1]:.3e} {rels[2]:.3e} "
              f"(tolerance {BF16_TOL}); dead keys exact zeros; a second run "
              "bit-identical", flush=True)
        if not max(rels) <= BF16_TOL:
            raise AssertionError(f"phase 23 {name}: {rels} > {BF16_TOL}")
        worst = max(worst, max(rels))
        del args, got, again, want, q, k, v
    return worst


def time_bf16_bwd(fa, fab, device, card: str):
    """Phase 24: the bf16 backward at the training paths' shapes
    (BF16_BWD_SHAPES), timed as phase 9 beside its bf16 plain version, the
    autograd backward of bf16 F.scaled_dot_product_attention and the bound
    at the bf16 rate, with the fp32 kernel at the same shape in the same
    call. Returns (kernel ms, plain ms, library ms, (bound ms, by)) at
    AOTT's training shape."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 5)
    result = None
    for label, b, lq, lk, h, d, dv in BF16_BWD_SHAPES:
        args, (q32, k32, v32, do32) = bf16_bwd_inputs(
            fa, rng, b, lq, lk, h, d, dv, None, device)
        q, k, v, vl = args[:4]
        out32, lse32 = fa.flash_attention_cuda(q32, k32, v32, None, h, d)
        args32 = (q32, k32, v32, None, out32, lse32, do32, h, d)
        qs, ks, vs, mask = sdpa_args(q, k, v, vl, h, d)
        backend = sdpa_backend(qs, ks, vs, mask)
        leaves = [x.requires_grad_() for x in (qs, ks, vs)]
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_dout = args[6].reshape(b, lq, h, dv).transpose(1, 2)
        # the fp32 kernel's own yardsticks at this shape (PERF.md row 6)
        qs32, ks32, vs32, mask32 = sdpa_args(q32, k32, v32, None, h, d)
        leaves32 = [x.requires_grad_() for x in (qs32, ks32, vs32)]
        with torch.enable_grad():
            lib_out32 = F.scaled_dot_product_attention(*leaves32,
                                                       attn_mask=mask32)
        lib_dout32 = do32.reshape(b, lq, h, dv).transpose(1, 2)
        t = time_fns({
            "plain": lambda: fab.flash_attention_bwd_plain(*args, h, d),
            "kernel": lambda: fab.flash_attention_bwd_cuda(*args, h, d),
            "fp32 kernel": lambda: fab.flash_attention_bwd_cuda(*args32),
            "fp32 plain": lambda: fab.flash_attention_bwd_plain(*args32),
            "fp32 library": lambda: torch.autograd.grad(
                lib_out32, leaves32, lib_dout32, retain_graph=True),
            "library": lambda: torch.autograd.grad(
                lib_out, leaves, lib_dout, retain_graph=True)},
            *((20, 3) if dv > 32 else ()))
        del lib_out, leaves, lib_out32, leaves32
        b_ms, b_by = flash_bwd_bound_live(lq, [lk] * b, h, d, dv, True)
        f_ms = flash_bwd_bound_live(lq, [lk] * b, h, d, dv)[0]
        print(f"phase 24: flash_attn_bwd_bf16 {label} shape B={b} Lq={lq} "
              f"Lk={lk} h={h} d={d} dv={dv}: kernel {t['kernel']:.4f} ms, "
              f"bf16 plain {t['plain']:.4f} ms, bf16 "
              f"F.scaled_dot_product_attention backward ({backend}) "
              f"{t['library']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); the fp32 "
              f"kernel {t['fp32 kernel']:.4f} ms, fp32 plain "
              f"{t['fp32 plain']:.4f} ms, fp32 F.scaled_dot_product_attention "
              f"backward ({sdpa_backend(qs32, ks32, vs32, mask32)}) "
              f"{t['fp32 library']:.4f} ms (fp32 bound {f_ms:.4f} ms) "
              f"({card})", flush=True)
        result = result or (t["kernel"], t["plain"], t["library"],
                            (b_ms, b_by))
        del args, args32, q, k, v, q32, k32, v32, qs, ks, vs, qs32, ks32, vs32
    return result


class EllipseClips:
    """A fixed training set of `n` seeded clips (moving ellipses, as the
    serving video), each {'frames': (T, H, W, 3) uint8, 'labels': (T, H, W)
    int32, 'obj_num': int32}: the Trainer's dataset argument. Made once; a
    batch of size n holds every clip."""

    def __init__(self, n: int, frames: int, size: int, objects: int):
        self.clips = []
        for i in range(n):
            video, _ = synthetic_video(SEED + 100 + i, frames, size, objects)
            labels = np.stack([ellipse_mask(SEED + 100 + i, t, size, objects)
                               for t in range(frames)])
            self.clips.append({"frames": video[:, 0], "labels": labels,
                               "obj_num": np.int32(objects)})

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx):
        return self.clips[idx]


def ellipse_mask(seed: int, t: int, size: int, objects: int) -> np.ndarray:
    """Frame t's label map of synthetic_video(seed, ...): the same ellipses,
    later ones painted over earlier ones."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    centre = rng.uniform(0.2, 0.8, (objects, 2)) * size
    radius = rng.uniform(0.04, 0.1, (objects, 2)) * size
    speed = rng.uniform(-2.0, 2.0, (objects, 2))
    mask = np.zeros((size, size), np.int32)
    for i in range(objects):
        cy, cx = centre[i] + t * speed[i]
        inside = (((yy - cy) / radius[i, 0]) ** 2
                  + ((xx - cx) / radius[i, 1]) ** 2) <= 1
        mask[inside] = i + 1
    return mask


def train_cfg(root: str, model: str = "aott", **over):
    from aot_tpu_torch.configs import build_config

    over = dict(dict(TRAIN_DTYPE="float32", PRETRAIN=False,
                     TRAIN_AUTO_RESUME=False, DATA_WORKERS=0,
                     TRAIN_REMAT=True, TRAIN_LOG_STEP=5, DIR_ROOT=root), **over)
    cfg = build_config(stage="pre_ytb_dav", model=model, **over)
    return cfg.init_dir(make=True)


def run_training(kernels, device, card: str, phase: int = 10,
                 model: str = "aott", dtype: str = "float32",
                 batch: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
                 nccl: bool = False, after=None, **over):
    """Phase 10 (AOTT, fp32), 25 (AOTT, bf16), 26 (R50_DeAOTL, bf16) or 28
    (R50_DeAOTL, bf16, trainable BN, nccl: the Trainer as rank 0 of a
    world-size-1 NCCL group, parallel.launch): `steps` training steps of
    `model` through Trainer.sequential_training, `over` the config's other
    overrides. after(trainer, cfg), if given, runs once the checkpoint
    checks pass. Returns (launches by kernel name, median ms/step, peak
    GiB)."""
    import shutil

    from aot_tpu_torch import parallel

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_train_{model}_{dtype}_{phase}")
    shutil.rmtree(root, ignore_errors=True)
    cfg = train_cfg(root, model, TRAIN_DTYPE=dtype, TRAIN_BATCH_SIZE=batch,
                    DATA_SEQ_LEN=TRAIN_T, TRAIN_TOTAL_STEPS=TRAIN_SCHEDULE,
                    **over)
    t0 = time.perf_counter()
    data = EllipseClips(batch, TRAIN_T, SIZE, TRAIN_OBJECTS)
    print(f"phase {phase}: {batch} clips of {TRAIN_T} frames at {SIZE}x{SIZE} "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    if nccl:
        run = {}
        parallel.launch(lambda dev: run.update(out=run_training_body(
            kernels, dev, card, phase, cfg, data, steps, batch, dtype,
            after)), 1, devices=[str(device)])
        return run["out"]
    return run_training_body(kernels, device, card, phase, cfg, data, steps,
                             batch, dtype, after)


def run_training_body(kernels, device, card, phase, cfg, data, steps, batch,
                      dtype, after):
    from aot_tpu_torch import parallel
    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.train.trainer import Trainer
    from aot_tpu_torch.utils import checkpoint as ckpt_lib

    trainer = Trainer(cfg, seed=SEED, device=device)
    if parallel.is_live():
        print(f"phase {phase}: the Trainer is rank {trainer.rank} of "
              f"{trainer.world} ({torch.distributed.get_backend()})",
              flush=True)
    losses, ends = [], []

    def on_step(step, stats):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses.append(float(stats["loss"]))
        print(f"phase {phase}: step {step} loss {losses[-1]:.5f} pred_loss "
              f"{float(stats['pred_loss']):.5f} iou {float(stats['iou']):.4f} "
              f"grad_norm {float(stats['grad_norm']):.4f}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    start = time.perf_counter()
    trainer.sequential_training(steps, dataset=data, on_step=on_step)
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    step_ms = np.diff([start] + ends)[TRAIN_WARMUP:] * 1e3
    last10 = ""
    if len(step_ms) > 10:
        last10 = (f" (the last 10: median "
                  f"{float(np.median(step_ms[-10:])):.1f} ms/step)")
    print(f"phase {phase}: {cfg.MODEL_NAME} training {SIZE}x{SIZE}, B={batch}, "
          f"T={TRAIN_T}, {TRAIN_OBJECTS} objects, {dtype}, recompute on, "
          f"TRAIN_TOTAL_STEPS={TRAIN_SCHEDULE}, TRAIN_LONG_TERM_MEM_GAP="
          f"{cfg.TRAIN_LONG_TERM_MEM_GAP}: {len(step_ms)} steps after "
          f"{TRAIN_WARMUP} warm-up: median {float(np.median(step_ms)):.1f} "
          f"ms/step, p90 {float(np.percentile(step_ms, 90)):.1f} ms{last10}, "
          f"{batch * TRAIN_T * 1e3 / float(np.median(step_ms)):.1f} "
          f"frames/s; peak memory {peak:.2f} GiB ({card})", flush=True)
    layers = cfg.MODEL_LSTT_NUM
    sfx = "_bf16" if dtype == "bfloat16" else ""
    per_step = dict({name: 0 for name in kernels},
                    **{"flash_attn_fwd" + sfx:
                       (2 * TRAIN_T + 2 * (TRAIN_T - 1)) * layers,
                       "flash_attn_bwd" + sfx: 2 * TRAIN_T * layers})
    want = {k: n * steps for k, n in per_step.items()}
    print(f"phase {phase}: kernel launches in the training path: {launches}, "
          f"per step {({k: v / steps for k, v in launches.items()})} "
          f"(expected {per_step}: two global attentions a frame and block, "
          f"the {TRAIN_T - 1} propagated frames' forwards run again in the "
          "backward; local reads on the window form)", flush=True)
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")

    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"phase {phase}: mean loss of the first 5 steps {first:.5f}, of the "
          f"last 5 {last:.5f}", flush=True)
    if not last < first:
        raise AssertionError(f"the loss did not fall: {losses}")

    raw = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint(cfg.DIR_CKPT),
                                   device)
    if raw["step"] != steps or any(
            not torch.equal(v, raw["model"][k])
            for k, v in trainer.model.state_dict().items()):
        raise AssertionError("the raw checkpoint does not hold the model")
    floats = [v for v in list(raw["model"].values())
              + list(raw["optimizer"]["mu"].values())
              + list(raw["ema"].values()) if v.is_floating_point()]
    if any(v.dtype != torch.float32 for v in floats):
        raise AssertionError("a checkpointed parameter, moment or EMA entry "
                             "is not fp32")
    serving = build_vos_model(cfg, device=device)
    ema = ckpt_lib.load_checkpoint(
        ckpt_lib.latest_checkpoint(cfg.DIR_EMA_CKPT), device)
    serving.load_state_dict(ema["state_dict"], strict=True)
    print(f"phase {phase}: checkpoint of step {raw['step']} reloaded (raw "
          "state equal, parameters, Adam moments and EMA fp32, EMA weights "
          "loaded strictly into a serving model)", flush=True)
    if after is not None:
        for k, n in after(trainer, cfg).items():
            launches[k] += n
    del trainer, serving, raw, ema
    torch.cuda.empty_cache()
    return launches, float(np.median(step_ms)), peak


SERVE_STEPS = 5        # phase 28: frames served from the EMA checkpoint


def trainable_bn_checks(trainer, cfg, kernels):
    """Phase 28's gates after the run: the running stats moved off their
    init and are finite, metrics.jsonl has a line per log step, the image
    log exists, and the EMA checkpoint loads strictly into the frozen
    serving model, which then serves SERVE_STEPS frames through
    VOSInferEngine.step. Returns the serving run's launches."""
    import json

    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.models.encoders.common import (FrozenBatchNorm2d,
                                                       TrainableBatchNorm2d)
    from aot_tpu_torch.utils import checkpoint as ckpt_lib

    steps = trainer.state.step
    bns = [m for m in trainer.model.modules()
           if isinstance(m, TrainableBatchNorm2d)]
    moved = sum(not (torch.equal(m.running_mean, torch.zeros_like(
        m.running_mean)) and torch.equal(m.running_var, torch.ones_like(
            m.running_var))) for m in bns)
    finite = all(bool(torch.isfinite(m.running_mean).all()
                      and torch.isfinite(m.running_var).all()) for m in bns)
    print(f"phase 28: {len(bns)} trainable BNs, {moved} with running stats "
          f"moved off their init, all finite: {finite}", flush=True)
    if not bns or moved != len(bns) or not finite:
        raise AssertionError("the running stats did not all move, or are "
                             "not finite")
    with open(os.path.join(cfg.DIR_LOG, "metrics.jsonl")) as f:
        logged = [json.loads(line)["step"] for line in f]
    want = list(range(cfg.TRAIN_LOG_STEP, steps + 1, cfg.TRAIN_LOG_STEP))
    images = sorted(os.listdir(cfg.DIR_IMG_LOG))
    print(f"phase 28: metrics.jsonl steps {logged}, image log {images}",
          flush=True)
    if logged != want or not images:
        raise AssertionError(f"metrics.jsonl steps {logged} != {want}, or "
                             "no image log")
    serving = build_vos_model(cfg, device=trainer.device)
    if any(isinstance(m, TrainableBatchNorm2d) for m in serving.modules()) \
            or not any(isinstance(m, FrozenBatchNorm2d)
                       for m in serving.modules()):
        raise AssertionError("the serving model is not built frozen")
    ema = ckpt_lib.load_checkpoint(
        ckpt_lib.latest_checkpoint(cfg.DIR_EMA_CKPT), trainer.device)
    serving.load_state_dict(ema["state_dict"], strict=True)
    video, mask = synthetic_video(SEED, SERVE_STEPS + 1, SIZE, OBJECTS)
    _, _, _, seconds, flash_steps, launches = run_main_path(
        serving, cfg, video, mask, SERVE_STEPS, kernels, SIZE)
    want = expected_launches(kernels, SERVE_STEPS + 1, sum(flash_steps),
                             cfg.MODEL_LSTT_NUM)
    print(f"phase 28: the EMA checkpoint (running stats in it) loaded "
          f"strictly into the frozen serving model; {SERVE_STEPS} frames "
          f"served, median {float(np.median(seconds)) * 1e3:.1f} ms/frame, "
          f"launches {launches}", flush=True)
    if launches != want or launches["local_window_attn"] == 0:
        raise AssertionError(f"serving launches {launches} != {want}")
    return launches


SENS_EPS = 1e-6     # phase 29: the relative move of the CPU's own frames


def normalised_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 frames as the float pipeline gives them (the engine's own
    normalisation, in fp32)."""
    from aot_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD

    return ((frames.astype(np.float32) / np.float32(255.0)
             - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32)).astype(np.float32)


def running_stats_err(got, want) -> float:
    """The worst running-stat error of `got` against `want` ({name:
    tensor}), each BN channel's in units of its own spread: |d mean| /
    sqrt(var) and |d var| / var."""
    err = 0.0
    for n, w in want.items():
        if n.endswith("running_mean"):
            spread = want[n[:-len("mean")] + "var"].sqrt()
        else:
            spread = w
        err = max(err, float(((got[n] - w).abs() / spread).max()))
    return err


def train_step_on(cfg, dev, frames, labels, deterministic: bool,
                  objects: int = 3):
    """One train step of a seeded model on `dev`: (loss and grad_norm,
    gradients, updated parameters, BN running stats), on the CPU."""
    from aot_tpu_torch.engine.train import build_train_engine
    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.train.step import create_train_state, make_train_step

    model = build_vos_model(cfg, device=dev, train=True,
                            generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, build_train_engine(model, cfg))
    stats = step(state, torch.from_numpy(frames).to(dev),
                 torch.from_numpy(labels).to(dev),
                 torch.full((frames.shape[1],), objects, device=dev),
                 torch.Generator().manual_seed(SEED), False,
                 deterministic=deterministic)
    return ({k: float(stats[k]) for k in ("loss", "grad_norm")},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers() if "running" in n})


# phase 29: the trainable BN alone, at the shapes of R50_DeAOTL's stem and
# layer3 BNs (4 frames), card against CPU
BN_SHAPES = ((4, 64, 233, 233), (4, 1024, 30, 30))
BN_TOL = 1e-5           # fp32, of each tensor's largest entry
BF16_BN_TOL = 1e-2      # bf16 output: one bf16 rounding of the product


def compare_trainable_bn(device):
    """Phase 29: a TrainableBatchNorm2d's train-mode forward and backward on
    the card against the CPU on the same inputs: the output, the updated
    running stats and the gradients of the input, weight and bias within
    BN_TOL of each tensor's largest entry at fp32 (the sums add in another
    order), the output within BF16_BN_TOL and the running stats within
    BN_TOL at bf16 input. A well-conditioned check of the moments and
    their gradients, which the whole step's gate (the step's own move,
    PERF.md section 7) cannot make."""
    from aot_tpu_torch.models.encoders.common import TrainableBatchNorm2d

    rng = np.random.RandomState(SEED + 29)
    worst = 0.0
    for shape in BN_SHAPES:
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 0.5)
        cot = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        affine = torch.from_numpy(
            rng.uniform(0.5, 1.5, (2, shape[1])).astype(np.float32))
        for dtype, tol in ((torch.float32, BN_TOL),
                           (torch.bfloat16, BF16_BN_TOL)):
            out = []
            for dev in (device, torch.device("cpu")):
                bn = TrainableBatchNorm2d(shape[1]).to(dev)
                with torch.no_grad():
                    bn.weight.copy_(affine[0])
                    bn.bias.copy_(affine[1])
                xt = x.to(dev, dtype).requires_grad_(True)
                y = bn(xt)
                got = {"y": y.float(), "mean": bn.running_mean,
                       "var": bn.running_var}
                if dtype == torch.float32:
                    (y * cot.to(dev)).sum().backward()
                    got.update(dx=xt.grad, dw=bn.weight.grad,
                               db=bn.bias.grad)
                out.append({k: v.detach().cpu() for k, v in got.items()})
            card, cpu = out
            for k, w in cpu.items():
                err = float((card[k] - w).abs().max()) / float(w.abs().max())
                gate = tol if k == "y" else BN_TOL
                if dtype == torch.float32:
                    worst = max(worst, err)
                if err > gate:
                    raise AssertionError(f"phase 29: trainable BN {shape} "
                                         f"{dtype} {k}: {err:.2e} > {gate}")
    print(f"phase 29: trainable BN card vs CPU at {BN_SHAPES}: worst fp32 "
          f"error {worst:.2e} of a tensor's largest entry (output, running "
          f"stats, input/weight/bias gradients; tolerance {BN_TOL}; bf16 "
          f"output {BF16_BN_TOL})", flush=True)


def own_move(cfg, frames, labels, eps: float, base):
    """The CPU's own move: the deterministic step of `cfg` on the CPU on
    frames moved by eps relative, against `base`, its (stats, gradients)
    on `frames`. Returns (the grad norm's relative move, each gradient
    leaf's largest absolute move)."""
    moved = (frames * (1 + eps * np.random.RandomState(SEED + 7).randn(
        *frames.shape))).astype(np.float32)
    ms, mg = train_step_on(cfg, torch.device("cpu"), moved, labels,
                           True)[:2]
    hs, hg = base
    return (abs(ms["grad_norm"] - hs["grad_norm"]) / hs["grad_norm"],
            {n: float((mg[n] - hg[n]).abs().max()) for n in hg})


def worst_leaf(moves, grads):
    """The largest of `moves` (by leaf) over its leaf's largest gradient
    plus 1e-3 of the model's largest (phase 11's gradient scale), and its
    leaf."""
    gmax = max(float(g.abs().max()) for g in grads.values())
    return max((moves[n] / (float(g.abs().max()) + 1e-3 * gmax), n)
               for n, g in grads.items())


SENS_SIZES = ((CMP_SIZE, CMP_BATCH), (CMP_SIZE, 4), (193, 2), (193, 4))


def bn_sensitivity() -> int:
    """--bn-sensitivity: the CPU's own move of an AOTT fp32 step with
    MODEL_FREEZE_BN=False, T=CMP_T, at each of SENS_SIZES, for input moves
    of SENS_EPS and SENS_EPS / 10, with ReLU6 as it is and as a smooth
    clamp (softplus, beta 20), to see what its kinks do. Needs no card."""
    import torch.nn.functional as F

    torch.manual_seed(SEED)
    cfg = train_cfg(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "chip_smoke_sens"), "aott",
                    TRAIN_LSTT_DROPPATH=0.0, TRAIN_TOTAL_STEPS=1000,
                    MODEL_FREEZE_BN=False)
    print(f"CPU, {torch.get_num_threads()} threads; AOTT fp32 trainable BN, "
          f"T={CMP_T}, deterministic", flush=True)
    relu6 = torch.nn.ReLU6.forward
    for size, batch in SENS_SIZES:
        data = EllipseClips(batch, CMP_T, size, 3)
        frames = normalised_frames(
            np.stack([c["frames"] for c in data.clips], axis=1))
        labels = np.stack([c["labels"] for c in data.clips], axis=1)
        for smooth in (False, True):
            if smooth:
                torch.nn.ReLU6.forward = lambda self, x: (
                    F.softplus(x, beta=20) - F.softplus(x - 6, beta=20))
            try:
                base = train_step_on(cfg, torch.device("cpu"), frames,
                                     labels, True)[:2]
                for eps in (SENS_EPS, SENS_EPS / 10):
                    norm, moves = own_move(cfg, frames, labels, eps, base)
                    grad, leaf = worst_leaf(moves, base[1])
                    print(f"{size}x{size} B={batch} eps {eps:g} "
                          f"{'smooth clamp' if smooth else 'ReLU6       '}: "
                          f"grad norm {norm:.2e}, worst leaf {grad:.2e} "
                          f"({leaf})", flush=True)
            finally:
                torch.nn.ReLU6.forward = relu6
    return 0


def compare_train_step(device, model: str = "aott", dtype: str = "float32",
                       phase: int = 11, deterministic: bool = False, **over):
    """Phase 11 (AOTT, fp32), 27 (AOTT at bf16, DeAOTT at fp32 and bf16)
    and 29 (AOTT, fp32, MODEL_FREEZE_BN=False, float frames: BN weight
    and bias among the gradients, the running stats within STATS_TOL of
    each channel's spread, and the grad-norm and gradient gates raised to
    twice the CPU's own move when its frames move by SENS_EPS, where that
    is larger; entries whose CPU gradient is under twice their leaf's own
    move get two LR units; PERF.md section 7 has the own move by size):
    one train step on the card and on the CPU from the same weights and
    batch, no id-shuffle difference (the same generator) and, for DeAOT, no
    dropout (deterministic: the card's and the CPU's generators draw other
    masks). fp32: loss and grad_norm within 1e-4 relative, every gradient
    within 1e-3 of its leaf's largest entry (plus 1e-6 of the model's
    largest), every updated parameter within a quarter of one LR unit. bf16
    (tests/test_torch_port_train_bf16.py's tolerances): loss and grad_norm
    within 2e-2 relative, each gradient leaf within 5e-2 of its largest
    entry or twice the CPU's own bf16 rounding error there (its distance
    from the CPU's fp32 step), whichever is larger, every updated
    parameter within 1e-2 of its leaf's largest entry beyond two LR units
    (Adam's first update is ~lr sign(g): an entry whose gradient's sign
    bf16 decides otherwise moves 2 lr apart, all of a zero-initialised
    leaf's scale). Returns (loss error, worst gradient error)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cmp")
    cfg = train_cfg(root, model, TRAIN_DTYPE=dtype, TRAIN_LSTT_DROPPATH=0.0,
                    TRAIN_TOTAL_STEPS=1000, **over)
    bf16 = dtype == "bfloat16"
    trainable = not cfg.MODEL_FREEZE_BN
    deterministic = deterministic or cfg.MODEL_VOS == "deaot"
    data = EllipseClips(CMP_BATCH, CMP_T, CMP_SIZE, 3)
    frames = np.stack([c["frames"] for c in data.clips], axis=1)
    labels = np.stack([c["labels"] for c in data.clips], axis=1)
    if trainable:     # float frames, so that a copy can be moved a little
        frames = normalised_frames(frames)
    (cs, cg, cp, cb), (hs, hg, hp, hb) = (
        train_step_on(cfg, dev, frames, labels, deterministic)
        for dev in (device, torch.device("cpu")))
    exact = None
    if bf16:    # the CPU's fp32 step: bf16's own rounding error
        cfg32 = train_cfg(root, model, TRAIN_DTYPE="float32",
                          TRAIN_LSTT_DROPPATH=0.0, TRAIN_TOTAL_STEPS=1000,
                          **over)
        exact = train_step_on(cfg32, torch.device("cpu"), frames, labels,
                              deterministic)[1]
    loss_err = abs(cs["loss"] - hs["loss"]) / abs(hs["loss"])
    norm_err = abs(cs["grad_norm"] - hs["grad_norm"]) / hs["grad_norm"]
    gmax = max(float(g.abs().max()) for g in hg.values())
    floor = 1e-6 * gmax
    label = f"{cfg.MODEL_NAME} {dtype}"
    own_grad = own_norm = 0.0
    own_abs = {}        # a leaf's largest own move, absolute
    if trainable:
        # the CPU's own step on frames moved by SENS_EPS relative: how far
        # the function itself moves its gradients at rounding-sized input
        # changes (with trainable BN at seeded weights, far beyond fp32's
        # rounding of the step: a frozen-BN step moves < 1e-5 of the gate;
        # PERF.md section 7)
        own_norm, own_abs = own_move(cfg, frames, labels, SENS_EPS,
                                     (hs, hg))
        own_grad = worst_leaf(own_abs, hg)[0]
        print(f"phase {phase}: {label}: the CPU's own step on frames moved "
              f"by {SENS_EPS:g} relative moves the grad norm by "
              f"{own_norm:.2e} relative and the worst gradient leaf by "
              f"{own_grad:.2e} of its gate's scale", flush=True)
    if bf16:
        # a leaf's error over the larger of 5e-2 of its largest entry and
        # twice the CPU's bf16 error on it: <= 1 passes
        rel = sorted(((float((cg[n] - hg[n]).abs().max())
                       / max(5e-2 * float(hg[n].abs().max()),
                             2 * float((hg[n] - exact[n]).abs().max()),
                             1e-30),
                       float(hg[n].abs().max()) / gmax, n) for n in hg),
                     reverse=True)
        grad_gate, loss_gate, param_gate = 1.0, 2e-2, 1e-2
    else:
        # a gradient's error over its leaf's largest entry, with a floor of
        # 1e-3 of the model's largest gradient: at init the
        # self-attention's q and k gradients are ~1e-9 of it (its tokens
        # are near alike) and are fp32 noise on both devices
        rel = sorted(((float((cg[n] - hg[n]).abs().max())
                       / (float(hg[n].abs().max()) + 1e-3 * gmax),
                       float(hg[n].abs().max()) / gmax, n) for n in hg),
                     reverse=True)
        grad_gate, loss_gate, param_gate = 1e-3, 1e-4, 0.25
    # trainable BN: the function's own movement, twice, where it is larger
    norm_gate = max(loss_gate, 2 * own_norm)
    grad_gate = max(grad_gate, 2 * own_grad)
    grad_err = rel[0][0]
    for r, scale, n in rel[:3]:
        print(f"phase {phase}: {label} gradient {n}: "
              + (f"err / max(5e-2 of the leaf's largest entry, 2x the CPU's "
                 f"bf16 error) {r:.2e}" if bf16 else
                 f"err / (leaf scale + 1e-3 of the model's largest) {r:.2e}")
              + f"; leaf scale / model's largest {scale:.2e}", flush=True)
    lr = cfg.TRAIN_LR_MIN
    param_err = 0.0
    for n, p in hp.items():
        if bf16:        # beyond 2 LR units, of the leaf's largest entry
            beyond = ((cp[n] - p).abs() - 2 * lr).clamp(min=0.0)
            param_err = max(param_err, float(beyond.max())
                            / max(float(p.abs().max()), 1e-30))
            continue
        # in LR units, outside entries whose gradient is noise (with
        # trainable BN also those under twice their leaf's own move: the
        # CPU's own step may flip their sign, and Adam's first updates
        # then differ by 2 lr)
        noise = hg[n].abs() < floor if n in hg else torch.ones_like(
            p, dtype=torch.bool)
        if n in own_abs:
            noise |= hg[n].abs() < 2 * own_abs[n]
        err = (cp[n] - p).abs() / lr
        if bool((err[noise] > 2).any()):
            raise AssertionError(f"{n}: a noise entry moved > 2 LR units")
        param_err = max(param_err, float(err[~noise].max()) if
                        bool((~noise).any()) else 0.0)
    stats_err = running_stats_err(cb, hb)
    if stats_err > STATS_TOL:
        raise AssertionError(f"running stats {label}: card vs CPU "
                             f"{stats_err:.2e} > {STATS_TOL}")
    unit = ("beyond 2 LR units, of the leaf's largest entry" if bf16
            else "LR units")
    print(f"phase {phase}: {label} train step card vs CPU ({CMP_SIZE}x"
          f"{CMP_SIZE}, B={CMP_BATCH}, T={CMP_T}): loss {cs['loss']:.6f} vs "
          f"{hs['loss']:.6f} (rel err {loss_err:.2e}), grad_norm rel err "
          f"{norm_err:.2e}, worst gradient err {grad_err:.2e}, worst "
          f"updated-parameter err {param_err:.3e} {unit}, running stats "
          f"err {stats_err:.2e} of a channel's spread (tolerances {loss_gate}, "
          f"{norm_gate:.2e}, {grad_gate:.2e}, {param_gate}, {STATS_TOL})",
          flush=True)
    if not (loss_err <= loss_gate and norm_err <= norm_gate
            and grad_err <= grad_gate and param_err <= param_gate):
        raise AssertionError(f"train step {label}: card and CPU disagree")
    return loss_err, grad_err


DP_RANKS = 2


def dp_step(device, out: str, rows: slice):
    """Phase 30: one deterministic fp32 train step of the seeded AOTT
    (MODEL_FREEZE_BN=False, TF32 off) on `rows` of the 465x465 batch, on
    `device`; a rank of a live process group averages its gradients and
    stats with the others. Saves (loss and grad_norm, updated parameters,
    running stats, gradients, this process's kernel launches) to `out`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = train_cfg(os.path.join(os.path.dirname(out), "cfg"), "aott",
                    MODEL_FREEZE_BN=False, TRAIN_LSTT_DROPPATH=0.0,
                    TRAIN_TOTAL_STEPS=TRAIN_SCHEDULE)
    data = EllipseClips(TRAIN_BATCH, TRAIN_T, SIZE, TRAIN_OBJECTS)
    frames = np.stack([c["frames"] for c in data.clips], axis=1)[:, rows]
    labels = np.stack([c["labels"] for c in data.clips], axis=1)[:, rows]
    kernels = kernel_counters()
    reset_counts(kernels)
    stats, grads, params, running = train_step_on(
        cfg, device, frames, labels, True, TRAIN_OBJECTS)
    torch.save((stats, params, running, grads, read_counts(kernels)), out)


def dp_rank(device, root: str):
    """A rank of phase 30's data-parallel step: its share of the batch."""
    from aot_tpu_torch import parallel

    r, share = parallel.rank(), TRAIN_BATCH // parallel.world_size()
    dp_step(device, os.path.join(root, f"rank{r}.pt"),
            slice(r * share, (r + 1) * share))


def compare_dp_step(device, card: str):
    """Phase 30: one step by one process at B=TRAIN_BATCH against one step
    by DP_RANKS gloo ranks on the same card (NCCL refuses two ranks on one
    device), each rank a spawned process with B/DP_RANKS clips: loss and
    grad norm within 1e-5 relative, the running stats within STATS_TOL of
    each channel's spread, every updated parameter within a quarter of one
    LR unit (two where the gradient is fp32 noise or the two gradients
    differ by more than half: Adam's first update is ~lr sign(g)); both
    ranks hold the same model. Returns the launches of both runs by kernel
    name."""
    import shutil

    from aot_tpu_torch import parallel

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dp_step(device, os.path.join(root, "single.pt"), slice(0, TRAIN_BATCH))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    try:
        parallel.launch(dp_rank, DP_RANKS, (root,),
                        devices=[str(device)] * DP_RANKS)
    except Exception as err:
        print(f"phase 30: {DP_RANKS} gloo ranks on one card failed: {err!r}",
              flush=True)
        raise
    t2 = time.perf_counter()
    load = lambda name: torch.load(os.path.join(root, name),
                                   weights_only=True)
    s1, p1, b1, g1, k1 = load("single.pt")
    ranks = [load(f"rank{r}.pt") for r in range(DP_RANKS)]
    s2, p2, b2, _, _ = ranks[0]
    loss_err = abs(s2["loss"] - s1["loss"]) / abs(s1["loss"])
    norm_err = abs(s2["grad_norm"] - s1["grad_norm"]) / s1["grad_norm"]
    same = all(torch.equal(p2[n], r[1][n]) for r in ranks[1:] for n in p2)
    stats_err = running_stats_err(b2, b1)
    cfg_lr = train_cfg(os.path.join(root, "cfg"), "aott").TRAIN_LR_MIN
    gmax = max(float(g.abs().max()) for g in g1.values())
    g2 = ranks[0][3]
    param_err, flips = 0.0, 0
    for n, p in p1.items():
        loose = ((g1[n].abs() < 1e-6 * gmax)
                 | ((g2[n] - g1[n]).abs() > 0.5 * g1[n].abs()))
        err = (p2[n] - p).abs() / cfg_lr
        if bool((err[loose] > 2).any()):
            raise AssertionError(f"phase 30 {n}: an entry moved > 2 LR units")
        flips += int(loose.sum())
        if bool((~loose).any()):
            param_err = max(param_err, float(err[~loose].max()))
    print(f"phase 30: AOTT fp32 trainable BN, {SIZE}x{SIZE}, B={TRAIN_BATCH}, "
          f"T={TRAIN_T}, deterministic: one process ({t1 - t0:.1f} s) vs "
          f"{DP_RANKS} gloo ranks x B={TRAIN_BATCH // DP_RANKS} on one card "
          f"({t2 - t1:.1f} s): loss {s2['loss']:.6f} vs {s1['loss']:.6f} (rel "
          f"err {loss_err:.2e}), grad_norm rel err {norm_err:.2e}, running "
          f"stats err {stats_err:.2e} of a channel's spread, worst parameter "
          f"{param_err:.3f} LR units ({flips} entries at the 2-unit "
          f"allowance), ranks identical: {same} (tolerances 1e-5, 1e-5, "
          f"{STATS_TOL}, 0.25) ({card})", flush=True)
    if not (loss_err <= 1e-5 and norm_err <= 1e-5 and stats_err <= STATS_TOL
            and param_err <= 0.25 and same):
        raise AssertionError("phase 30: the data-parallel step differs from "
                             "the one-process step")
    launches = dict(k1)
    for r in ranks:
        for k, n in r[4].items():
            launches[k] += n
    return launches


def write_davis_full_res(root: str, seed: int, frames: int,
                         objects: int) -> str:
    """A DAVIS-2017 Full-Resolution folder under root/DAVIS: one seeded
    1080x1920 clip of `frames` JPEG frames with `objects` ellipses moving
    over a noisy gradient, and every frame's palettised annotation (as
    DAVIS val has; the evaluator reads the first, J&F all). Returns the
    annotation directory."""
    seq = "ellipses"
    davis = os.path.join(root, "DAVIS")
    ann_root = os.path.join(davis, "Annotations", "Full-Resolution")
    os.makedirs(os.path.join(davis, "ImageSets", "2017"), exist_ok=True)
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write(seq + "\n")
    write_ellipse_clip(
        os.path.join(davis, "JPEGImages", "Full-Resolution", seq),
        os.path.join(ann_root, seq), seed, frames, EVAL_SIZE, objects)
    return ann_root


def ellipse_clip(seed: int, frames: int, size, objects: int,
                 speed: float = 6.0, radius=(0.05, 0.1)):
    """A seeded clip of `frames` uint8 RGB frames of (H, W) `size` with
    `objects` ellipses (radii the given fractions of H and W) moving over a
    noisy gradient, at most `speed` pixels a frame along each axis, and
    their label maps: ((T, H, W, 3) uint8, (T, H, W) uint8)."""
    hgt, wid = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hgt, 0:wid].astype(np.float32)
    base = np.stack([yy / hgt, xx / wid, (yy + xx) / (hgt + wid)], -1) * 160
    centre = rng.uniform(0.25, 0.75, (objects, 2)) * (hgt, wid)
    radii = rng.uniform(*radius, (objects, 2)) * (hgt, wid)
    velocity = rng.uniform(-speed, speed, (objects, 2))
    colour = rng.uniform(40, 255, (objects, 3)).astype(np.float32)
    rgb = np.empty((frames, hgt, wid, 3), np.uint8)
    labels = np.zeros((frames, hgt, wid), np.uint8)
    for t in range(frames):
        img = base + rng.standard_normal((hgt, wid, 3), np.float32) * 6
        for i in range(objects):
            cy, cx = centre[i] + t * velocity[i]
            inside = (((yy - cy) / radii[i, 0]) ** 2
                      + ((xx - cx) / radii[i, 1]) ** 2) <= 1
            img[inside] = colour[i]
            labels[t][inside] = i + 1
        rgb[t] = np.clip(img, 0, 255).astype(np.uint8)
    return rgb, labels


def write_ellipse_clip(img_dir: str, ann_dir: str, seed: int, frames: int,
                       size, objects: int, speed: float = 6.0) -> None:
    """ellipse_clip's frames as JPEGs into img_dir and its label maps as
    palettised PNGs into ann_dir."""
    import cv2
    from PIL import Image

    from aot_tpu_torch.utils.image import vos_palette

    for d in (img_dir, ann_dir):
        os.makedirs(d, exist_ok=True)
    palette = vos_palette()
    rgb, labels = ellipse_clip(seed, frames, size, objects, speed)
    for t in range(frames):
        cv2.imwrite(os.path.join(img_dir, f"{t:05d}.jpg"), rgb[t][..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        im = Image.fromarray(labels[t]).convert("P")
        im.putpalette(palette)
        im.save(os.path.join(ann_dir, f"{t:05d}.png"))


def full_res_clip(name: str, device, label: str):
    """Write the DAVIS-2017 Full-Resolution clip under build/<name>; returns
    (its annotation directory, the eval CLI's arguments for it)."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    gt_root = write_davis_full_res(root, SEED + 7, EVAL_FRAMES, EVAL_OBJECTS)
    print(f"{label}: DAVIS-2017 Full-Resolution folder, 1 clip of "
          f"{EVAL_FRAMES} frames {EVAL_SIZE[0]}x{EVAL_SIZE[1]}, "
          f"{EVAL_OBJECTS} objects, written in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    argv = ["--stage", "pre_ytb_dav", "--model", "aott",
            "--dataset", "davis2017", "--max_resolution", "1080",
            "--ckpt_path", "test", "--device", str(device),
            "--set", "TEST_DATASET_FULL_RESOLUTION=True",
            "--set", f"DIR_DATA={root}", "--set", f"DIR_ROOT={root}"]
    print(f"{label}: python -m aot_tpu_torch.eval {' '.join(argv)}",
          flush=True)
    return gt_root, argv


def run_full_res_eval(kernels, device, card: str):
    """Phase 12. Returns (evaluator, launches by kernel name)."""
    from aot_tpu_torch.eval import __main__ as eval_cli
    from aot_tpu_torch.eval import metrics
    from aot_tpu_torch.ops.attention import use_flash

    gt_root, argv = full_res_clip("chip_smoke_eval", device, "phase 12")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    ev, summary = eval_cli.run(argv)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    stats = summary["per_sequence"][0]
    (in_h, in_w), = stats["input_sizes"]
    grid = ((in_h - 1) // 16 + 1, (in_w - 1) // 16 + 1)
    print(f"phase 12: input {in_h}x{in_w}, grid {grid[0]}x{grid[1]} = "
          f"{grid[0] * grid[1]} tokens", flush=True)
    if grid != EVAL_GRID or stats["frames"] != EVAL_FRAMES:
        raise AssertionError(f"grid {grid}, {stats['frames']} frames")
    # every LSTT forward (the reference frame's and each propagated
    # frame's) reads its short-term window once per block; an LT read
    # takes the flash kernel from FLASH_MIN_KEYS live keys on
    cfg, eng = ev.cfg, ev.engine
    hw = grid[0] * grid[1]
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    flash_reads = 0
    for t in range(1, EVAL_FRAMES):
        live = shadow.count * hw
        flash_reads += use_flash(live, live, eng.engine.top_k,
                                 eng.engine.max_mem_len_ratio)
        shadow.update(t)
    want = expected_launches(kernels, EVAL_FRAMES, flash_reads,
                             cfg.MODEL_LSTT_NUM)
    print(f"phase 12: kernel launches in the evaluation: {launches} "
          f"(expected: {want}; LT frames at the end {shadow.count}, "
          f"{shadow.count * hw} live keys)", flush=True)
    if launches != want:
        raise AssertionError(f"evaluation launches {launches} != {want}")
    ms = np.asarray(stats["frame_times"][EVAL_WARMUP:]) * 1e3
    print(f"phase 12: AOTT DAVIS-2017 Full-Resolution evaluation, "
          f"{EVAL_OBJECTS} objects, fp32: {len(ms)} frames after "
          f"{EVAL_WARMUP} warm-up: median {float(np.median(ms)):.3f} "
          f"ms/frame ({1e3 / float(np.median(ms)):.2f} FPS), p90 "
          f"{float(np.percentile(ms, 90)):.3f} ms (evaluator's per-frame "
          f"time: upload to mask on the host); {wall:.1f} s for the whole "
          f"run ({wall * 1e3 / EVAL_FRAMES:.1f} ms a frame with decoding, "
          f"resizing, model set-up and PNG writes); peak memory "
          f"{peak:.2f} GiB ({card})", flush=True)

    # the same clip again: cuDNN has chosen its algorithms for this input
    # size, so what the first pass took more is what a new size costs once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    again = ev.evaluate()
    peak_again = torch.cuda.max_memory_allocated() / 2**30
    ms_again = np.asarray(again["per_sequence"][0]["frame_times"]) * 1e3
    print(f"phase 12: a second pass over the clip: evaluate() "
          f"{again['wall_time']:.3f} s (first pass {summary['wall_time']:.3f}"
          f" s: a new input size costs "
          f"{summary['wall_time'] - again['wall_time']:.3f} s once, cuDNN's "
          f"autotuning), median {float(np.median(ms_again)):.3f} ms/frame "
          f"over all {len(ms_again)} timed frames, first frame "
          f"{ms_again[0]:.3f} ms (first pass {stats['frame_times'][0] * 1e3:.3f}"
          f" ms); peak memory {peak_again:.2f} GiB (first pass {peak:.2f} "
          f"GiB) ({card})", flush=True)
    jf = metrics.evaluate_davis(ev.result_root, gt_root, verbose=False)
    print(f"phase 12: J&F against the clip's ground truth (random weights, "
          f"not gated): J {jf['J']:.4f} F {jf['F']:.4f} J&F "
          f"{jf['J&F']:.4f}", flush=True)
    return ev, launches


def compare_full_res_with_cpu(ev, device):
    """Phase 13: the reference frame and 2 steps on the card, then 3 steps
    from that state on the card and on the CPU, at the evaluation's input
    size (VOSInferEngine.step feeds its mask back at the size it returns).
    Returns (max logit error, min mask agreement)."""
    from aot_tpu_torch.data.eval_datasets import build_eval_dataset
    from aot_tpu_torch.data.video_aug import multi_restrict_size
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.ops.image import interpolate_nearest

    cfg, eng = ev.cfg, ev.engine
    seq = build_eval_dataset(cfg)[0]

    def frame(t):
        s = seq[t]
        v = multi_restrict_size(s["image"], s["label"], multi_scale=[1.0],
                                max_short_edge=cfg.TEST_MAX_SHORT_EDGE,
                                max_long_edge=cfg.TEST_MAX_LONG_EDGE,
                                align_corners=cfg.MODEL_ALIGN_CORNERS)[0]
        return torch.from_numpy(v["image"][None]), s

    img, s0 = frame(0)
    size = tuple(img.shape[1:3])      # the masks fed back are at this size
    lab = torch.from_numpy(s0["label"][None].astype(np.float32))[..., None]
    lab = interpolate_nearest(lab, size)[..., 0].long()
    state = eng.add_reference_frame(img.to(device), lab.to(device),
                                    int(s0["meta"]["obj_num"]))
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    for t in (1, 2):
        state, _, _ = grow_then_step(eng, shadow, state, frame(t)[0].to(device),
                                     t, size)
    cpu_eng = build_infer_engine(copy.deepcopy(ev.model).to("cpu"), cfg)
    cpu_state = state.to("cpu")
    cpu_shadow = copy.deepcopy(shadow)
    worst_err, worst_agree = 0.0, 1.0
    for t in range(3, 3 + CPU_STEPS):
        img = frame(t)[0]
        t0 = time.perf_counter()
        state, pred, logits = grow_then_step(eng, shadow, state,
                                             img.to(device), t, size)
        cpu_state, cpu_pred, cpu_logits = grow_then_step(
            cpu_eng, cpu_shadow, cpu_state, img, t, size)
        err = (logits.cpu() - cpu_logits).abs().max().item()
        agree = (pred.cpu() == cpu_pred).float().mean().item()
        print(f"phase 13: frame {t} at {EVAL_GRID[0]}x{EVAL_GRID[1]}: card vs "
              f"CPU logits max_abs_err {err:.3e}, mask agreement "
              f"{agree:.6f} ({time.perf_counter() - t0:.1f} s)", flush=True)
        worst_err, worst_agree = max(worst_err, err), min(worst_agree, agree)
    if not (worst_err <= LOGIT_TOL and worst_agree >= MASK_AGREE):
        raise AssertionError(
            f"full resolution, card vs CPU: logits {worst_err} (limit "
            f"{LOGIT_TOL}), masks {worst_agree} (limit {MASK_AGREE})")
    return worst_err, worst_agree


def profile_full_res_eval(card: str, autotune: bool) -> int:
    """--profile-eval: where a full-resolution evaluation frame's time goes.
    Evaluates phase 12's clip once (cuDNN autotuning on, or off with
    --no-autotune), then once more under torch.profiler, and prints the
    evaluator's ms/frame, the peak memory, the device time and the kernel
    launches a frame, and the kernels that take the most time. A process
    keeps the algorithm cuDNN first chose for a shape, so the two settings
    are compared in two runs of this script."""
    from torch.profiler import ProfilerActivity, profile

    from aot_tpu_torch.eval import __main__ as eval_cli

    _, argv = full_res_clip("chip_smoke_profile", "cuda:0", "profile")
    ev, summary = eval_cli.run(argv, cudnn_benchmark=autotune)
    ms = np.asarray(summary["per_sequence"][0]["frame_times"]) * 1e3
    print(f"profile: cudnn.benchmark={autotune}: first pass ms/frame "
          f"{np.round(ms, 3).tolist()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        summary = ev.evaluate()
    torch.cuda.synchronize()
    ms = np.asarray(summary["per_sequence"][0]["frame_times"]) * 1e3
    frames = len(ms) + 1                         # the reference frame too
    print(f"profile: profiled pass: median {float(np.median(ms)):.3f} "
          f"ms/frame; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})",
          flush=True)
    print_profile(prof, frames,
                  f"(of {frames}, the reference frame included)")
    return 0


def print_profile(prof, frames: int, label: str, unit: str = "frame"
                  ) -> float:
    """A profiled window's kernel time and launches a frame (or `unit`),
    and the kernels that take the most time. Returns the kernel ms a
    frame."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    launches = sum(e.count for e in kernels) / frames
    print(f"profile: a {unit} {label}: {total:.3f} ms of kernels, "
          f"{launches:.0f} kernel launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile: {e.self_device_time_total / 1e3 / frames:8.3f} "
              f"ms/{unit} {e.count / frames:8.1f} launches/{unit}  "
              f"{e.key[:100]}", flush=True)
    return total


def profile_serving(card: str, model_name: str, batch: int = 1) -> int:
    """--profile-serve MODEL: where a serving frame's time goes. Runs the
    model's main path as phases 6, 14 and 16 do (its serving size, 10
    objects, the evaluator's grow loop), before and after the flash switch
    a window of PROFILE_STEPS steps timed on the host clock and then one
    under torch.profiler (which slows the host): the unprofiled ms a
    frame, kernel ms and launches a frame, the device's busy share (kernel
    time over the unprofiled frame) and the kernels that take the most
    time. batch > 1: N seeded clips a step through step_videos (phase 21),
    the numbers a step of N frames."""
    from torch.profiler import ProfilerActivity, profile

    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.engine import build_infer_engine

    cfg = build_config(stage="pre_ytb_dav", model=model_name)
    size = serving_size(cfg)
    device = torch.device("cuda", 0)
    clips = [crop(*synthetic_video(SEED + (10 + i if batch > 1 else 0),
                                   STEPS + 1, SIZE, OBJECTS), size)
             for i in range(batch)]
    eng = build_infer_engine(seeded_model(cfg, device), cfg)
    frames = torch.from_numpy(np.concatenate([c[0] for c in clips], 1)).to(
        device)                                   # (T, N, H, W, 3)
    masks = torch.from_numpy(np.concatenate([c[1] for c in clips])).to(device)
    shadow = eng.make_shadow()
    if batch > 1:
        state = eng.add_reference_frames_videos(frames[0], masks,
                                                [OBJECTS] * batch)
    else:
        state = eng.add_reference_frame(frames[0], masks, OBJECTS)
    shadow.add_ref(0)
    t = 0

    def window(n: int):
        """n steps, each ending in a synchronize; their median ms."""
        nonlocal state, t
        seconds = []
        for _ in range(n):
            t += 1
            t0 = time.perf_counter()
            if batch > 1:
                if shadow.will_write(t):
                    state = eng.ensure_lt_capacity(state, shadow.count + 1)
                state, _, _ = eng.step_videos(state, frames[t], (size, size))
                shadow.update(t)
            else:
                state, _, _ = grow_then_step(eng, shadow, state, frames[t], t,
                                             (size, size))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return float(np.median(seconds) * 1e3)

    # the flash switch comes at step 46 (10 LT frames of 841 or 900 keys)
    for label, start in (("before the flash switch", 20),
                         ("after the flash switch", 50)):
        window(start - t)
        host = window(PROFILE_STEPS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = window(PROFILE_STEPS)
        print(f"profile: {cfg.MODEL_NAME} {size}x{size}, {batch} video(s) a "
              f"step, {label} ({shadow.count}"
              f" LT frames): median {host:.3f} ms a step over steps "
              f"{t - 2 * PROFILE_STEPS + 1}-{t - PROFILE_STEPS}, "
              f"{profiled:.3f} under the profiler over the next "
              f"{PROFILE_STEPS} ({card})", flush=True)
        unit = "frame" if batch == 1 else f"step of {batch} frames"
        kernel = print_profile(prof, PROFILE_STEPS, label, unit)
        print(f"profile: {label}: the card busy {kernel / host:.0%} of the "
              f"unprofiled median {unit}", flush=True)
    return 0


# the flash backward's kernels by name (csrc/flash_attn_bwd.cu's, and the
# earlier mma.sync form's grad_qk_kernel and grad_t_kernel, so a profile of
# an older tree reads the same share)
FLASH_BWD_KERNELS = ("::bwd_", "grad_qk_kernel", "grad_t_kernel")
# ... and the flash forward's (fp32 and bf16, this tree's and earlier ones')
FLASH_FWD_KERNELS = ("::fwd_", "::score_kernel", "::pv_kernel",
                     "::merge_kernel", "::sum_splits_kernel")


def profile_training(card: str, model_name: str, dtype: str,
                     batch: int, trainable_bn: bool = False) -> int:
    """--profile-train MODEL [--dtype D] [--batch N] [--trainable-bn]: where
    a training step's time goes, at phase 10's, 25's, 26's or (with
    --trainable-bn, MODEL_FREEZE_BN=False) 28's configuration (B clips of
    TRAIN_T seeded frames at SIZE, per-frame recompute): 3 warm-up steps of
    the Trainer's train_step, 3 timed on the host clock (each ending in a
    synchronize), then 2 under torch.profiler: kernel ms and launches a
    step, the busy share against the unprofiled median, the kernels that
    take the most time, and the peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from aot_tpu_torch.train.trainer import Trainer

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_profile_train")
    cfg = train_cfg(root, model_name, TRAIN_DTYPE=dtype,
                    TRAIN_BATCH_SIZE=batch, DATA_SEQ_LEN=TRAIN_T,
                    TRAIN_TOTAL_STEPS=TRAIN_SCHEDULE,
                    MODEL_FREEZE_BN=not trainable_bn)
    device = torch.device("cuda", 0)
    trainer = Trainer(cfg, seed=SEED, device=device)
    data = EllipseClips(batch, TRAIN_T, SIZE, TRAIN_OBJECTS)
    frames = torch.from_numpy(np.stack([c["frames"] for c in data.clips],
                                       1)).to(device)
    labels = torch.from_numpy(np.stack([c["labels"] for c in data.clips],
                                       1)).to(device)
    obj_nums = torch.full((batch,), TRAIN_OBJECTS, device=device)
    generator = torch.Generator().manual_seed(SEED)

    def window(n: int) -> float:
        seconds = []
        for _ in range(n):
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, frames, labels, obj_nums,
                               generator, False)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return float(np.median(seconds) * 1e3)

    window(3)
    torch.cuda.reset_peak_memory_stats()
    host = window(3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = window(2)
    print(f"profile: {cfg.MODEL_NAME} training {SIZE}x{SIZE}, B={batch}, "
          f"T={TRAIN_T}, {dtype}, {'trainable' if trainable_bn else 'frozen'}"
          f" BN: median {host:.1f} ms a step over 3 steps "
          f"after 3 warm-up, {profiled:.1f} under the profiler over the next "
          f"2; peak memory {peak:.2f} GiB ({card})", flush=True)
    kernel = print_profile(prof, 2, f"{cfg.MODEL_NAME} {dtype}", "step")
    print(f"profile: the card busy {kernel / host:.0%} of the unprofiled "
          "median step", flush=True)
    for what, keys in (("backward", FLASH_BWD_KERNELS),
                       ("forward", FLASH_FWD_KERNELS)):
        part = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                and any(n in e.key for n in keys)]
        ms = sum(e.self_device_time_total for e in part) / 1e3 / 2
        names = sorted({e.key.split("<")[0].split("::")[-1] for e in part})
        print(f"profile: the flash {what}'s kernels {ms:.3f} ms a step, "
              f"{sum(e.count for e in part) / 2:.0f} launches, "
              f"{ms / kernel:.1%} of the kernel time ({', '.join(names)})",
              flush=True)
    return 0


# the flash backward's shapes on the training and long-read paths: phase 9's
# (fp32) and phase 24's (bf16, and fp32 at DeAOT's)
BWD_PROFILE_SHAPES = (
    ("AOTT training", torch.float32, 16, 900, 900, 8, 32, 32),
    ("DeAOTL LT", torch.float32, 1, 900, 19800, 1, 128, 1024),
    ("DeAOTL 1080p LT", torch.float32, 1, 7232, 14464, 1, 128, 1024),
    ("DeAOT GPM self-attention", torch.float32, 16, 900, 900, 1, 128, 1024),
    ("DeAOT LT read", torch.float32, 16, 900, 2700, 1, 128, 1024),
    ("AOTT training", torch.bfloat16, 16, 900, 900, 8, 32, 32),
    ("DeAOT GPM self-attention", torch.bfloat16, 16, 900, 900, 1, 128, 1024),
    ("DeAOT LT read", torch.bfloat16, 16, 900, 2700, 1, 128, 1024))


def profile_calls(tag: str, label: str, fn, runs: int, card: str) -> None:
    """`runs` calls of `fn` after two warm-up calls under torch.profiler:
    each kernel's device ms and launches a call, and the call's median on
    CUDA events, printed with `tag`."""
    from torch.profiler import ProfilerActivity, profile

    call_ms = float(np.median(cuda_times_ms(fn, 4 * runs, 2)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    print(f"{tag}: {label}: a call {call_ms:.4f} ms on CUDA events, "
          f"{total:.4f} ms of kernels under the profiler ({card})",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / runs
        print(f"{tag}:   {ms:9.4f} ms {e.count / runs:6.1f} "
              f"launches  {e.key[:110]}", flush=True)


def print_build_logs(names) -> None:
    """The build's ptxas lines (registers, shared memory, spills) of each
    source in `names` that this process built."""
    from aot_tpu_torch.ops.kernels import _build

    for name in names:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            print(f"  nvcc {name}: {line}", flush=True)


def profile_bwd(card: str, runs: int = 5) -> int:
    """--profile-bwd: where the flash backward's time goes, kernel by
    kernel, at BWD_PROFILE_SHAPES: `runs` calls of the wrapper after two
    warm-up calls under torch.profiler; each kernel's device ms and
    launches a call, and the call's total on CUDA events. Prints the
    build's ptxas lines (registers, spills) for every instantiation
    first."""
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab

    _build.build("flash_attn_fwd", "flash_attn_bwd")
    print_build_logs(["flash_attn_bwd"])
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED + 6)
    for label, dt, b, lq, lk, h, d, dv in BWD_PROFILE_SHAPES:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, None, device)
        q, k, v = (x.to(dt) for x in (q, k, v))
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, lq, h * dv), dtype=dt,
                            device=device)
        args = (q, k, v, vl, out, lse, dout, h, d)
        profile_calls("profile-bwd", f"{label} {str(dt)[6:]} B={b} Lq={lq} "
                      f"Lk={lk} h={h} d={d} dv={dv}",
                      lambda: fab.flash_attention_bwd_cuda(*args), runs, card)
        del q, k, v, out, lse, dout, args
        torch.cuda.empty_cache()
    return 0


def profile_fwd(card: str, runs: int = 5) -> int:
    """--profile-fwd: where the bf16 forward kernels' time goes, kernel by
    kernel: the local-window kernel at BF16_LOCAL_SHAPES, the flash
    forward at BF16_FLASH_SHAPES (profile_calls each), then the build's
    ptxas lines of the sources they loaded. It
    drives the wrappers only, so it also times an earlier tree's kernels
    (this file run from that tree's root)."""
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa

    device = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED + 7)
    for label, b, hgt, wid, h, d, dv, rv in BF16_LOCAL_SHAPES:
        args, _ = bf16_local_case(rng, b, hgt, wid, h, d, dv, rv, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        profile_calls("profile-fwd", f"local {label} B={b} h={h} d={d} "
                      f"dv={dv} rel_v={rv}",
                      lambda: lwa.local_window_attention_cuda(*args, **kw),
                      runs, card)
    for label, b, lq, lk, h, d, dv, valid in BF16_FLASH_SHAPES:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        profile_calls("profile-fwd", f"flash {label} B={b} Lq={lq} Lk={lk} "
                      f"h={h} d={d} dv={dv} live {valid}",
                      lambda: fa.flash_attention_cuda(q, k, v, vl, h, d),
                      runs, card)
        del q, k, v
        torch.cuda.empty_cache()
    print_build_logs(sorted(_build.BUILD_LOGS))
    return 0


KNOB_STEPS = 3      # phase 31: steps under each attention mode


def check_attn_knobs(kernels, device, card: str):
    """Phase 31: AOTT stepped under ATTN_IMPL 'auto', 'reference' and
    'pallas' (the config key, applied by build_infer_engine), each mode's
    launches asserted as ops.attention routes it and its masks held
    against 'auto's. Sets the mode back to 'auto'."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.ops import attention as att

    video, mask = synthetic_video(SEED, KNOB_STEPS + 1, SIZE, OBJECTS)
    frames = torch.from_numpy(video).to(device)
    ref = torch.from_numpy(mask).to(device)
    base = build_config(stage="pre_ytb_dav", model="aott")
    model = seeded_model(base, device)
    layers = base.MODEL_LSTT_NUM
    runs = {}
    try:
        for impl in ("auto", "reference", "pallas"):
            cfg = build_config(stage="pre_ytb_dav", model="aott",
                               ATTN_IMPL=impl)
            eng = build_infer_engine(model, cfg)
            if att.attn_impl() != impl:
                raise AssertionError(f"phase 31: ATTN_IMPL={impl} gave "
                                     f"{att.attn_impl()}")
            shadow = eng.make_shadow()
            torch.cuda.synchronize()
            reset_counts(kernels)
            state = eng.add_reference_frame(frames[0], ref, OBJECTS)
            shadow.add_ref(0)
            preds = []
            for t in range(1, KNOB_STEPS + 1):
                state, pred, logits = grow_then_step(eng, shadow, state,
                                                     frames[t], t,
                                                     (SIZE, SIZE))
                check_step_outputs(pred, logits, SIZE)
                preds.append(pred)
            torch.cuda.synchronize()
            runs[impl] = (read_counts(kernels), preds)
    finally:
        att.set_attn_impl("auto")
    forwards = (KNOB_STEPS + 1) * layers     # the reference frame's too
    # 'pallas' takes both global reads of every LSTT forward to the flash
    # kernel: the self-attention (900 keys, no live length) and the LT
    # read (900 keys)
    want = {
        "auto": {"local_window_attn": (forwards, forwards),
                 "flash_attn_fwd": (0, 0)},
        "reference": {"local_window_attn": (0, 0), "flash_attn_fwd": (0, 0)},
        "pallas": {"local_window_attn": (forwards, forwards),
                   "flash_attn_fwd": (2 * forwards, 2 * forwards)},
    }
    for impl, (counts, preds) in runs.items():
        others = {k: n for k, n in counts.items() if k not in want[impl]}
        agree = min(float((p == q).float().mean())
                    for p, q in zip(preds, runs["auto"][1]))
        print(f"phase 31: ATTN_IMPL={impl}: launches {counts} over the "
              f"reference frame and {KNOB_STEPS} steps (want {want[impl]}, "
              f"other kernels 0); masks against 'auto' {agree:.6f} ({card})",
              flush=True)
        if (any(not lo <= counts[k] <= hi
                for k, (lo, hi) in want[impl].items())
                or any(others.values())):
            raise AssertionError(f"phase 31 {impl}: launches {counts}, want "
                                 f"{want[impl]} and no other")
        if agree < MASK_AGREE:
            raise AssertionError(f"phase 31 {impl}: masks {agree} against "
                                 "auto's")


# --- phase 32: the entry points ---------------------------------------------


DEMO_SIZE = (480, 854)      # the Demo clips' frames (H, W): 480p at 16:9
DEMO_SEQS = (("ellipses3", 32, 3), ("ellipses2", 8, 2))  # name, frames, objects
DEMO_MODEL = "r50_deaotl"   # inference.sh's default
DEMO_CHUNK = 4              # --frame_chunk of the chunked run
DEMO_CPU_FRAMES = 5         # the fp32 run's first frames, held against the CPU
DEMO_PROFILED = 3           # frames stepped inside ProfilerHook
OVERFIT_BATCH = 4           # the overfit check's defaults (tools/overfit_check.py)
OVERFIT_CROP = 257
OVERFIT_STEPS = 200
OVERFIT_OBJECTS = 3


def write_demo(root: str):
    """A datasets/Demo folder under root (images/<seq>/*.jpg, masks/<seq>/
    00000.png) of DEMO_SEQS, and beside it an Annotations folder with every
    frame's label map. Returns (the Demo folder, the Annotations folder)."""
    import shutil

    data = os.path.join(root, "Demo")
    ann = os.path.join(root, "Annotations")
    for i, (seq, frames, objects) in enumerate(DEMO_SEQS):
        write_ellipse_clip(os.path.join(data, "images", seq),
                           os.path.join(ann, seq), SEED + 300 + i, frames,
                           DEMO_SIZE, objects, speed=3.0)
        os.makedirs(os.path.join(data, "masks", seq))
        shutil.copy(os.path.join(ann, seq, "00000.png"),
                    os.path.join(data, "masks", seq))
    return data, ann


def demo_prefix(data: str, dst: str, frames: int) -> str:
    """A Demo folder at dst holding the first `frames` frames of DEMO_SEQS'
    first sequence (and its first mask). Returns dst."""
    import shutil

    seq = DEMO_SEQS[0][0]
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(dst, sub, seq))
    for t in range(frames):
        shutil.copy(os.path.join(data, "images", seq, f"{t:05d}.jpg"),
                    os.path.join(dst, "images", seq))
    shutil.copy(os.path.join(data, "masks", seq, "00000.png"),
                os.path.join(dst, "masks", seq))
    return dst


def demo_argv(data: str, out: str, device, *extra):
    return ["--model", DEMO_MODEL, "--ckpt_path", "test", "--data_path",
            data, "--output_path", out, "--max_resolution", "480",
            "--device", str(device), *extra]


def read_pngs(out: str):
    """{seq/frame.png: mask} of a demo output folder."""
    from PIL import Image

    return {f"{seq}/{f}": np.array(Image.open(os.path.join(out, seq, f)))
            for seq in sorted(os.listdir(out))
            if os.path.isdir(os.path.join(out, seq))
            for f in sorted(os.listdir(os.path.join(out, seq)))}


def video_frames(path: str) -> int:
    """Frames cv2 decodes from a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    try:
        while cap.read()[0]:
            n += 1
    finally:
        cap.release()
    return n


def demo_expected_launches(kernels, cfg, bf16: bool):
    """Launches by kernel name of the demo over DEMO_SEQS at DEMO_SIZE: a
    local read a block for every LSTT forward (each frame, the reference
    frame's included) on the local kernel, and the flash forward for every
    LT read of enough live keys. The demo never grows its LT ring, so the
    live keys stop at TEST_LONG_TERM_MEM_CAP frames. Returns (launches,
    the grid's tokens, the live LT keys at each sequence's end)."""
    from aot_tpu_torch.data.video_aug import restrict_size
    from aot_tpu_torch.engine.infer import LTShadow
    from aot_tpu_torch.ops.attention import use_flash

    hgt, wid = restrict_size(*DEMO_SIZE, 1.0, None, 480 * 800 / 480,
                             cfg.MODEL_ALIGN_CORNERS)
    hw = ((hgt - 1) // 16 + 1) * ((wid - 1) // 16 + 1)
    cap = cfg.TEST_LONG_TERM_MEM_CAP
    dtype = torch.bfloat16 if bf16 else torch.float32
    frames = flash_reads = 0
    live_end = []
    for _, n, _ in DEMO_SEQS:
        shadow = LTShadow(cfg.TEST_LONG_TERM_MEM_GAP)
        shadow.add_ref(0)
        for t in range(1, n):
            live = min(shadow.count, cap) * hw
            flash_reads += use_flash(live, live, cfg.get("TEST_TOP_K", -1),
                                     cfg.get("TEST_MAX_MEM_LEN_RATIO", -1.0),
                                     dtype)
            shadow.update(t)
        frames += n
        live_end.append(min(shadow.count, cap) * hw)
    return (expected_launches(kernels, frames, flash_reads,
                              cfg.MODEL_LSTT_NUM, bf16=bf16), hw, live_end)


def overfit_batch(path: str) -> None:
    """An npz batch in the overfit check's layout (frames (T, B, H, W, 3)
    uint8, labels (T, B, H, W) uint8, obj_nums (B,) int32): OVERFIT_BATCH
    seeded clips of TRAIN_T frames at the check's crop, OVERFIT_OBJECTS
    ellipses each with radii of 10-20% of the crop."""
    clips = [ellipse_clip(SEED + 200 + i, TRAIN_T, (OVERFIT_CROP,) * 2,
                          OVERFIT_OBJECTS, speed=4.0, radius=(0.1, 0.2))
             for i in range(OVERFIT_BATCH)]
    np.savez(path, frames=np.stack([c[0] for c in clips], axis=1),
             labels=np.stack([c[1] for c in clips], axis=1),
             obj_nums=np.full((OVERFIT_BATCH,), OVERFIT_OBJECTS, np.int32))


def run_demo_modes(kernels, device, card: str, root: str, data: str):
    """Phase 32's demo runs on the card: fp32 per frame, with --frame_chunk,
    and --amp, each with its launches asserted, one PNG and one video frame
    a frame, the chunked PNGs equal to the per-frame ones. Returns (the
    launches by kernel name of the three runs, {run: (output folder, PNGs,
    ms a frame by the demo's own clock)})."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.tools import demo

    total = {name: 0 for name in kernels}
    outs = {}
    for tag, extra in (("fp32", ()),
                       ("fp32_chunk", ("--frame_chunk", str(DEMO_CHUNK))),
                       ("amp", ("--amp",))):
        cfg = build_config(stage="pre_ytb_dav", model=DEMO_MODEL,
                           TEST_DTYPE="bfloat16" if tag == "amp"
                           else "float32")
        want, hw, live_end = demo_expected_launches(kernels, cfg,
                                                    tag == "amp")
        out = os.path.join(root, "out_" + tag)
        argv = demo_argv(data, out, device, *extra)
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        stats = demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        for k in kernels:
            total[k] += launches[k]
        frames = sum(s["frames"] for s in stats)
        secs = sum(s["seconds"] for s in stats)
        per_seq = ", ".join(f"{s['seq']} {s['frames']} frames "
                            f"{s['seconds'] * 1e3 / s['frames']:.3f} ms/frame"
                            for s in stats)
        print(f"phase 32: python -m aot_tpu_torch.tools.demo "
              f"{' '.join(argv)}: {hw} tokens a frame, live LT keys at the "
              f"sequences' ends {live_end}; {frames} frames stepped in "
              f"{secs:.3f} s: {secs * 1e3 / frames:.3f} ms/frame, "
              f"{frames / secs:.2f} FPS (the demo's own clock: stepping, "
              f"upscale and read-back, overlay; {per_seq}); {wall:.1f} s "
              f"with model set-up, PNG and video writes; launches "
              f"{ {k: n for k, n in launches.items() if n} } (expected "
              f"{ {k: n for k, n in want.items() if n} }) ({card})",
              flush=True)
        if launches != want:
            raise AssertionError(f"phase 32 {tag}: launches {launches} != "
                                 f"{want}")
        pngs = read_pngs(out)
        for seq, n, _ in DEMO_SEQS:
            got = sum(name.startswith(seq + "/") for name in pngs)
            avi = os.path.join(out, seq + ".avi")
            avi = video_frames(avi) if os.path.exists(avi) else 0
            if got != n or avi != n:
                raise AssertionError(f"phase 32 {tag}: {seq} has {got} PNGs "
                                     f"and {avi} video frames, want {n}")
        outs[tag] = (out, pngs, secs * 1e3 / frames)
    base, chunked = outs["fp32"][1], outs["fp32_chunk"][1]
    if sorted(chunked) != sorted(base) or any(
            not np.array_equal(chunked[k], v) for k, v in base.items()):
        raise AssertionError("phase 32: the chunked PNGs differ from the "
                             "per-frame ones")
    amp = min(float((outs["amp"][1][k] == v).mean()) for k, v in base.items())
    print(f"phase 32: the --frame_chunk {DEMO_CHUNK} PNGs equal the "
          f"per-frame ones ({len(base)} masks); --amp against "
          f"fp32: worst frame {amp:.6f} of pixels equal (not gated: random "
          "weights)", flush=True)
    return total, outs


def compare_demo_with_cpu(root: str, data: str, card_pngs) -> None:
    """Phase 32: the demo's first DEMO_CPU_FRAMES frames on the CPU against
    the card's fp32 run, MASK_AGREE a frame."""
    from aot_tpu_torch.tools import demo

    t0 = time.perf_counter()
    out = os.path.join(root, "out_cpu")
    demo.main(demo_argv(demo_prefix(data, os.path.join(root, "cpu"),
                                    DEMO_CPU_FRAMES),
                        out, "cpu", "--no_video"))
    agree = {k: float((v == card_pngs[k]).mean())
             for k, v in read_pngs(out).items()}
    print(f"phase 32: the fp32 run's first {DEMO_CPU_FRAMES} frames against "
          f"the port's CPU run ({time.perf_counter() - t0:.1f} s): "
          f"{agree}", flush=True)
    if len(agree) != DEMO_CPU_FRAMES or min(agree.values()) < MASK_AGREE:
        raise AssertionError(f"phase 32: card vs CPU masks {agree}")


def device_busy_ms(events) -> float:
    """The card's busy time in a Chrome trace: the union of its kernel,
    copy and memset spans, in ms."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def profile_demo(device, card: str, root: str, data: str, kernel: str,
                 host_ms: float) -> None:
    """Phase 32: DEMO_PROFILED demo frames (after the reference frame)
    inside ProfilerHook; the Chrome trace it writes must name `kernel`
    and hold an `infer.step` span a frame. Prints the card's busy time a frame beside the demo's own clock (in
    this run and `host_ms`, the unprofiled fp32 run's): the busy time
    counts the random model's build and the reference frame too, so it
    bounds a frame's device time from above."""
    from aot_tpu_torch.tools import demo
    from aot_tpu_torch.utils.logging import ProfilerHook

    hook = ProfilerHook(os.path.join(root, "trace"))
    prof_data = demo_prefix(data, os.path.join(root, "profiled"),
                            DEMO_PROFILED + 1)
    hook.start()
    stats = demo.main(demo_argv(prof_data, os.path.join(root, "out_profiled"),
                                device, "--no_video"))
    torch.cuda.synchronize()
    trace = hook.stop()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    hits = [e for e in events if e.get("cat") == "kernel"
            and kernel in e.get("name", "")]
    steps = [e for e in events if e.get("cat") == "program_span"
             and e["name"] == "infer.step"]
    if len(steps) != DEMO_PROFILED:
        raise AssertionError(f"phase 32: {len(steps)} infer.step spans in "
                             f"the trace, not {DEMO_PROFILED}")
    kernel_ms = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel") / 1e3
    busy = device_busy_ms(events)
    own = stats[0]["seconds"] * 1e3 / stats[0]["frames"]
    print(f"phase 32: ProfilerHook around {DEMO_PROFILED} demo frames (and "
          f"the reference frame): {os.path.getsize(trace)} bytes of Chrome "
          f"trace, {len(events)} events ({len(steps)} infer.step spans), "
          f"{kernel} {len(hits)} times, "
          f"{sum(e.get('dur', 0) for e in hits) / 1e3:.3f} ms; the card busy "
          f"{busy:.3f} ms ({kernel_ms:.3f} ms of kernels), "
          f"{busy / (DEMO_PROFILED + 1):.3f} ms a frame with the model's "
          f"build and the reference frame counted in, against the demo's own "
          f"clock {own:.3f} ms/frame here (profiled) and {host_ms:.3f} "
          f"ms/frame in the fp32 run ({card})", flush=True)
    if not hits:
        raise AssertionError(f"phase 32: the trace names no {kernel}")


def run_overfit(kernels, device, card: str, root: str):
    """Phase 32: the overfit check on an npz of seeded ellipse clips; the
    logged IoU must rise. Returns its launches by kernel name."""
    from aot_tpu_torch.tools import overfit_check

    npz = os.path.join(root, "overfit_batch.npz")
    overfit_batch(npz)
    jsonl = os.path.join(root, "overfit.jsonl")
    args = ["--model", "aott", "--batch", str(OVERFIT_BATCH), "--crop",
            str(OVERFIT_CROP), "--steps", str(OVERFIT_STEPS)]
    cwd = os.getcwd()
    os.chdir(root)          # the check's config writes its run folders here
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        iou = overfit_check.main(args + [
            "--batch_npz", npz, "--jsonl", jsonl, "--device", str(device)])
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
    finally:
        os.chdir(cwd)
    with open(jsonl) as f:
        lines = [json.loads(x) for x in f]
    print(f"phase 32: python -m aot_tpu_torch.tools.overfit_check "
          f"{' '.join(args)} on seeded ellipse clips: IoU "
          f"{[r['iou'] for r in lines]} at steps "
          f"{[r['step'] for r in lines]}, {lines[-1]['sec_per_it'] * 1e3:.1f}"
          f" ms/step, {wall:.1f} s; verdict at tools/overfit_check.py's 0.25 "
          f"bar (set on a real Static batch, not gated here): "
          f"{'PASS' if iou > 0.25 else 'FAIL'}; launches "
          f"{ {k: n for k, n in launches.items() if n} } ({card})",
          flush=True)
    if not lines[-1]["iou"] > lines[0]["iou"]:
        raise AssertionError(f"phase 32: overfit IoU did not rise: {lines}")
    return launches


def run_entry_points(kernels, device, card: str):
    """Phase 32. Returns the launches by kernel name of the demo's three
    runs and the overfit check."""
    import shutil

    from aot_tpu_torch.tools import score

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_demo")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data, ann = write_demo(root)
    print(f"phase 32: Demo folder of {len(DEMO_SEQS)} sequences "
          f"({', '.join(f'{n} frames, {o} objects' for _, n, o in DEMO_SEQS)}"
          f") at {DEMO_SIZE[0]}x{DEMO_SIZE[1]} written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    total, outs = run_demo_modes(kernels, device, card, root, data)
    compare_demo_with_cpu(root, data, outs["fp32"][1])
    got = score.main([outs["fp32"][0], ann, "--json"])
    print(f"phase 32: python -m aot_tpu_torch.tools.score on the fp32 run: "
          f"{got} (random weights, not gated)", flush=True)
    if got["sequences"] != len(DEMO_SEQS) or not all(
            np.isfinite(got[k]) for k in ("J", "F", "J&F")):
        raise AssertionError(f"phase 32: score {got}")
    profile_demo(device, card, root, data, "local_attn_kernel",
                 outs["fp32"][2])
    for k, n in run_overfit(kernels, device, card, root).items():
        total[k] += n
    return total


# --- phases 19-22: bf16, batched and chunked serving ----------------------


# phase 19's and --profile-fwd's shapes of the bf16 forward kernels: the
# local-window kernel at the AOT head (h=8, d=dv=32, rel_v) and DeAOT's
# (h=1, d=128, dv=1024) at 30x30 with B = 1 and 4 (B = 4 is `--video_batch
# 4` serving), at the demo's 29x51 (phase 32's --amp run) and at 64x113
BF16_LOCAL_SHAPES = (("AOT head 30x30", 1, 30, 30, 8, 32, 32, True),
                     ("AOT head 30x30", 4, 30, 30, 8, 32, 32, True),
                     ("DeAOT head 30x30", 1, 30, 30, 1, 128, 1024, False),
                     ("DeAOT head 30x30", 4, 30, 30, 1, 128, 1024, False),
                     ("DeAOT head 29x51", 1, 29, 51, 1, 128, 1024, False),
                     ("AOT head 64x113", 1, 64, 113, 8, 32, 32, True),
                     ("DeAOT head 64x113", 1, 64, 113, 1, 128, 1024, False))
# ... and the flash forward over AOTT-shaped LT rings and DeAOTL's (live
# key lists: a (B,) valid_len), over the demo's 4-frame ring of 1,479-token
# frames with 3 and 4 frames live (phase 32's --amp run reads it from 4,096
# live keys on), then at the training shapes of BF16_BWD_SHAPES (every key
# live)
BF16_FLASH_SHAPES = (
    ("AOTT ring live 900", 1, 900, 7200, 8, 32, 32, [900]),
    ("AOTT ring live 7200", 1, 900, 7200, 8, 32, 32, [7200]),
    ("AOTT ring", 4, 900, 7200, 8, 32, 32, [900, 2700, 5400, 7200]),
    ("DeAOTL LT", 1, 900, 19800, 1, 128, 1024, [19800]),
    ("DeAOTL LT", 4, 900, 19800, 1, 128, 1024, [19800, 14400, 9000, 4500]),
    ("DeAOTL demo LT", 1, 1479, 5916, 1, 128, 1024, [4437]),
    ("DeAOTL demo LT", 1, 1479, 5916, 1, 128, 1024, [5916]),
) + tuple((label, b, lq, lk, h, d, dv, None)
          for label, b, lq, lk, h, d, dv in BF16_BWD_SHAPES)


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bf16_local_case(rng, b, hgt, wid, h, d, dv, rv, device):
    """Local inputs with q, k, v in bf16 (rel_bias, rel_v fp32) and their
    fp32 originals."""
    f32 = local_inputs(rng, b, hgt, wid, h, d, dv, rv, 7, device)
    return [a.to(torch.bfloat16) if i < 3 else a
            for i, a in enumerate(f32)], f32


def check_bf16_kernels(lwa, fa, device, card: str):
    """Phase 19: the bf16 kernels against their bf16 plain versions on the
    card (gate BF16_TOL of the largest entry; lse within BF16_TOL), a
    second run bit-identical, timed beside the bf16 plain version, bf16
    F.scaled_dot_product_attention (its backend named), the fp32 kernel
    and the bound at the bf16 rate, at BF16_LOCAL_SHAPES and
    BF16_FLASH_SHAPES; the flash forward also with NaN in every dead key
    (never read: the same bits) and with an element of no live key (out 0,
    lse -1e30). Returns ({bf16 kernel: worst error}, {bf16 kernel: (ms,
    plain ms, library ms or None, (bound ms, by))} at the JSON line's
    shapes)."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 3)
    worst = {"local_window_attn_bf16": 0.0, "flash_attn_fwd_bf16": 0.0}
    times = {}
    for label, b, hgt, wid, h, d, dv, rv in BF16_LOCAL_SHAPES:
        args, f32 = bf16_local_case(rng, b, hgt, wid, h, d, dv, rv, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        kernel = lwa.local_window_attention_cuda
        want = lwa.local_window_attention_plain(*args, **kw)
        got = kernel(*args, **kw)
        again = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        if got.dtype != torch.bfloat16 or not err <= BF16_TOL:
            raise AssertionError(f"phase 19 local {label} B={b}: {got.dtype}"
                                 f", error {err} > {BF16_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"phase 19 local {label} B={b}: two runs "
                                 "differ")
        worst["local_window_attn_bf16"] = max(
            worst["local_window_attn_bf16"], err)
        e32 = (kernel(*f32, **kw) - lwa.local_window_attention_plain(
            *f32, **kw)).abs().max().item()
        if not e32 <= KERNEL_TOL:
            raise AssertionError(f"phase 19 fp32 local {label} B={b}: {e32}")
        fns = {"plain": lambda: lwa.local_window_attention_plain(*args, **kw),
               "kernel": lambda: kernel(*args, **kw),
               "fp32 kernel": lambda: kernel(*f32, **kw)}
        lib = ""
        if not rv:
            q, k, v, rel_bias, _ = args
            split = lambda x, c: x.reshape(b, -1, h, c).transpose(1, 2)
            qs, ks, vs = (split(q, d).contiguous(), split(k, d).contiguous(),
                          split(v, dv).contiguous())
            bias = dense_window_bias(rel_bias, hgt, wid, 7).to(torch.bfloat16)
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=bias)
            lib_backend = sdpa_backend(qs, ks, vs, bias)
        t = time_fns(fns, *((20, 3) if (hgt, wid) == EVAL_GRID or b > 1
                            else ()))
        if not rv:
            lib = (f", bf16 F.scaled_dot_product_attention with the dense "
                   f"window bias ({lib_backend}) {t['library']:.4f} ms")
            del bias, qs, ks, vs
        b_ms, b_by = local_bound(b, hgt, wid, h, d, dv, rv, bf16=True)
        plan = lwa.bf16_launch_plan((b, h, hgt, wid, d, dv, 7, int(rv)),
                                    fa.sm_count(device))
        rows, vt, blocks = (lwa.bf16_plan_value(plan, n) for n in
                            ("ROWS", "VALUE_TILE", "BLOCKS"))
        print(f"phase 19: local_window_attn_bf16 {label} B={b} h={h} d={d} "
              f"dv={dv} rel_v={rv} (rows {rows}, value tile {vt}, {blocks} "
              f"blocks): error {err:.3e} of the largest entry (gate "
              f"{BF16_TOL}), a second run bit-identical; kernel "
              f"{t['kernel']:.4f} ms, bf16 plain "
              f"{t['plain']:.4f} ms{lib}; bound {b_ms:.4f} ms ({b_by}); the "
              f"fp32 kernel {t['fp32 kernel']:.4f} ms (max_abs_err "
              f"{e32:.2e}, fp32 bound "
              f"{local_bound(b, hgt, wid, h, d, dv, rv)[0]:.4f} ms) ({card})",
              flush=True)
        if (b, h, hgt, wid) == (1, 8, 30, 30):   # the JSON line's shape
            times["local_window_attn_bf16"] = (
                t["kernel"], t["plain"], t.get("library"), (b_ms, b_by))
    for label, b, lq, lk, h, d, dv, valid in BF16_FLASH_SHAPES:
        q32, k32, v32, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid,
                                         device)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        out2, lse2 = fa.flash_attention_cuda(q, k, v, vl, h, d)
        want, want_lse = fa.flash_attention_plain(q, k, v, vl, h, d)
        torch.cuda.synchronize()
        err = rel_err(out, want)
        err_lse = (lse - want_lse).abs().max().item()
        if out.dtype != torch.bfloat16 or not (err <= BF16_TOL and
                                               err_lse <= BF16_TOL):
            raise AssertionError(f"phase 19 flash {label} B={b}: {out.dtype}, "
                                 f"errors {err}, {err_lse}")
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"phase 19 flash {label} B={b}: two runs "
                                 "differ")
        live = [lk] * b if vl is None else vl.tolist()
        dead = ""
        if min(live) < lk:   # NaN in every dead key: never read
            kn, vn = k.clone(), v.clone()
            for i, n in enumerate(live):
                kn[i, n:] = float("nan")
                vn[i, n:] = float("nan")
            outn, lsen = fa.flash_attention_cuda(q, kn, vn, vl, h, d)
            if not (torch.equal(outn, out) and torch.equal(lsen, lse)):
                raise AssertionError(f"phase 19 flash {label} B={b}: NaN in "
                                     "dead keys moved the output")
            dead = ", NaN in the dead keys: the same bits"
            del kn, vn, outn, lsen
        worst["flash_attn_fwd_bf16"] = max(worst["flash_attn_fwd_bf16"], err)
        del want, want_lse, out2, lse2
        e32 = max(a.sub(w).abs().max().item() for a, w in zip(
            fa.flash_attention_cuda(q32, k32, v32, vl, h, d),
            fa.flash_attention_plain(q32, k32, v32, vl, h, d)))
        if not e32 <= KERNEL_TOL:
            raise AssertionError(f"phase 19 fp32 flash {label} B={b}: {e32}")
        qs, ks, vs, mask = sdpa_args(q, k, v, vl, h, d)
        fns = {"plain": lambda: fa.flash_attention_plain(q, k, v, vl, h, d),
               "kernel": lambda: fa.flash_attention_cuda(q, k, v, vl, h, d),
               "library": lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=mask),
               "fp32 kernel": lambda: fa.flash_attention_cuda(
                   q32, k32, v32, vl, h, d)}
        t = time_fns(fns, *((20, 3) if dv > 128 or b > 1 else ()))
        b_ms, b_by = flash_fwd_bound_live(lq, live, h, d, dv, True)
        plan, _ = fa.bf16_launch_plan((b, h, lq, lk, d, dv),
                                      fa.sm_count(device))
        splits, blocks = (fa.bf16_plan_value(plan, n)
                          for n in ("SPLITS", "BLOCKS"))
        print(f"phase 19: flash_attn_fwd_bf16 {label} B={b} Lq={lq} Lk={lk} "
              f"h={h} d={d} dv={dv} live {valid} ({blocks} blocks, {splits} "
              f"key splits): error {err:.3e} of the largest entry, lse "
              f"{err_lse:.1e} (gate {BF16_TOL}), a second run bit-identical"
              f"{dead}; kernel {t['kernel']:.4f} ms, bf16 plain "
              f"{t['plain']:.4f} ms, bf16 F.scaled_dot_product_attention with "
              f"a boolean live-key mask ({sdpa_backend(qs, ks, vs, mask)}) "
              f"{t['library']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); the fp32 "
              f"kernel {t['fp32 kernel']:.4f} ms (max_abs_err {e32:.2e}, fp32 "
              f"bound {flash_fwd_bound_live(lq, live, h, d, dv)[0]:.4f} ms) "
              f"({card})", flush=True)
        if label == "DeAOTL LT" and b == 1:
            times["flash_attn_fwd_bf16"] = (t["kernel"], t["plain"],
                                            t["library"], (b_ms, b_by))
        del q, k, v, q32, k32, v32, qs, ks, vs, out, lse
        torch.cuda.empty_cache()
    # an element with no live key (and one whose live keys end mid-tile):
    # out exactly 0 and lse -1e30 for the first, at both widths
    for h, d, dv in ((8, 32, 32), (1, 128, 1024)):
        q, k, v, vl = flash_inputs(rng, 2, 300, 1000, h, d, dv, [0, 613],
                                   device)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        want, want_lse = fa.flash_attention_plain(q, k, v, vl, h, d)
        torch.cuda.synchronize()
        if not (torch.all(out[0] == 0) and torch.all(lse[:h] == fa.NEG_INF)
                and rel_err(out[1], want[1]) <= BF16_TOL
                and (lse[h:] - want_lse[h:]).abs().max().item() <= BF16_TOL):
            raise AssertionError(f"phase 19 flash empty row h={h} d={d} "
                                 f"dv={dv}: {out[0].abs().max().item()}, "
                                 f"{lse[:h].max().item()}")
        print(f"phase 19: flash_attn_fwd_bf16 B=2 Lq=300 Lk=1000 h={h} d={d} "
              f"dv={dv} live [0, 613]: the empty element's out exactly 0 and "
              f"lse -1e30, the other's error {rel_err(out[1], want[1]):.3e} "
              f"({card})", flush=True)
    return worst, times


def mask_agreement(got, want):
    """Per-frame share of equal mask pixels of two lists of masks."""
    return np.asarray([(a == b).float().mean().item()
                       for a, b in zip(got, want)])


def run_bf16_serving(kernels, device, card: str, video, mask, fp32):
    """Phase 20: AOTT and DeAOTL at bf16 as phases 4 and 6 (the same clip,
    seed and loop), against their fp32 runs of this call (`fp32`: name ->
    (cfg, masks, (median, p90) ms)): ms/frame beside fp32, mask agreement
    with fp32 (mean >= 99.5%, worst frame >= 99.0%), launches from the bf16
    rule (flash from FLASH_MIN_KEYS_BF16 live keys: DeAOTL from step 21;
    AOTT, whose LT gap of 9999 keeps one 900-key frame live, never).
    Returns the launches by kernel name."""
    from aot_tpu_torch.configs import build_config

    total = {name: 0 for name in kernels}
    for name, (cfg, want, ms32) in fp32.items():
        cfg = build_config(stage="pre_ytb_dav", model=cfg.MODEL_NAME.lower(),
                           TEST_DTYPE="bfloat16",
                           TEST_LONG_TERM_MEM_CAP=cfg.TEST_LONG_TERM_MEM_CAP)
        preds = []
        launches, ms16 = drive(f"{name} bf16", cfg, device, video, mask,
                               kernels, card, 20, preds=preds,
                               cpu_check=False)
        agree = mask_agreement(preds, want)
        print(f"phase 20: {name} bf16 vs fp32 (this call): median "
              f"{ms16[0]:.3f} vs {ms32[0]:.3f} ms/frame, p90 {ms16[1]:.3f} vs "
              f"{ms32[1]:.3f}; masks agree on {agree.mean():.6f} of the "
              f"pixels (worst frame {agree.min():.6f}, gates 0.995 / 0.990) "
              f"({card})", flush=True)
        if not (agree.mean() >= 0.995 and agree.min() >= 0.990):
            raise AssertionError(f"{name} bf16 masks vs fp32: mean "
                                 f"{agree.mean()}, worst {agree.min()}")
        for k in kernels:
            total[k] += launches[k]
    return total


def run_full_res_eval_bf16(kernels, device, card: str):
    """Phase 20: phase 12's clip evaluated with --amp: the local kernel's bf16
    instantiation at 64x113, and the LT read of its one 7,232-key frame on
    the flash kernel at every step (the bf16 rule: from 4,096 live keys).
    Returns the launches by kernel name."""
    from aot_tpu_torch.eval import __main__ as eval_cli
    from aot_tpu_torch.ops.attention import use_flash

    _, argv = full_res_clip("chip_smoke_eval_amp", device, "phase 20")
    reset_counts(kernels)
    ev, summary = eval_cli.run(argv + ["--amp"])
    launches = read_counts(kernels)
    stats = summary["per_sequence"][0]
    (in_h, in_w), = stats["input_sizes"]
    grid = ((in_h - 1) // 16 + 1, (in_w - 1) // 16 + 1)
    eng = ev.engine
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    flash_reads = 0
    for t in range(1, EVAL_FRAMES):
        live = shadow.count * grid[0] * grid[1]
        flash_reads += use_flash(live, live, eng.engine.top_k,
                                 eng.engine.max_mem_len_ratio, torch.bfloat16)
        shadow.update(t)
    want = expected_launches(kernels, EVAL_FRAMES, flash_reads,
                             ev.cfg.MODEL_LSTT_NUM, bf16=True)
    ms = np.asarray(stats["frame_times"][EVAL_WARMUP:]) * 1e3
    print(f"phase 20: AOTT DAVIS-2017 Full-Resolution evaluation with --amp "
          f"(bf16), grid {grid[0]}x{grid[1]}: median "
          f"{float(np.median(ms)):.3f} ms/frame, p90 "
          f"{float(np.percentile(ms, 90)):.3f}; launches {launches} "
          f"(expected {want}) ({card})", flush=True)
    if grid != EVAL_GRID or launches != want:
        raise AssertionError(f"--amp evaluation: grid {grid}, launches "
                             f"{launches} != {want}")
    return launches


def row_state(state, i: int):
    """A copy of row i of a batched EngineState (the ST rings keep their
    slot axis first)."""
    import dataclasses

    row = lambda x, axis=0: x.narrow(axis, i, 1).clone()
    return dataclasses.replace(
        state,
        lt=[{k: row(v) for k, v in layer.items()} for layer in state.lt],
        lt_count=[state.lt_count[i]],
        st=[{k: row(v, 1) for k, v in layer.items()} for layer in state.st],
        curr=[{k: row(v) for k, v in layer.items()} for layer in state.curr],
        embs=[row(e) for e in state.embs],
        shortcuts=[row(s) for s in state.shortcuts],
        obj_nums=row(state.obj_nums))


def run_batched(kernels, device, card: str):
    """Phase 21: N videos a step (VOSInferEngine.step_videos), AOTT at N =
    1, 2, 4, 8 and DeAOTL at N = 1, 2, 4 through the flash switch (step
    46), 465x465, 10 objects each, seeded clips: aggregate frames/s, ms a
    step and peak memory for each N; launches from the LT schedule (one
    local read and one flash read a block per step, whatever N). At the
    largest N, at three steps (the first, the first past the flash switch
    for DeAOTL, the last), each row stepped alone from a copy of its state
    against the batched step: logits within BATCH_TOL, masks >= 99.9%.
    Returns the launches by kernel name."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.ops.attention import use_flash

    total = {name: 0 for name in kernels}
    hw = grid_side(SIZE) ** 2
    for name, model_name, ns, steps in (("AOTT", "aott", (1, 2, 4, 8), 30),
                                        ("DeAOTL", "deaotl", (1, 2, 4), 55)):
        cfg = build_config(stage="pre_ytb_dav", model=model_name,
                           TEST_LONG_TERM_MEM_CAP=8)
        model = seeded_model(cfg, device)
        eng = build_infer_engine(model, cfg)
        clips = [synthetic_video(SEED + 10 + i, steps + 1, SIZE, OBJECTS)
                 for i in range(max(ns))]
        frames = torch.from_numpy(np.stack([c[0][:, 0] for c in clips],
                                           1)).to(device)     # (T, N, ...)
        masks = torch.from_numpy(np.concatenate([c[1] for c in clips])).to(
            device)
        for n in ns:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            state = eng.add_reference_frames_videos(frames[0, :n], masks[:n],
                                                    [OBJECTS] * n)
            shadow = eng.make_shadow()
            shadow.add_ref(0)
            seconds, flash_reads = [], 0
            check = {1, steps} | ({47} if model_name == "deaotl" else set())
            worst = [0.0, 1.0]          # logits error, mask agreement
            for t in range(1, steps + 1):
                live = shadow.count * hw
                flash_reads += use_flash(live, live, -1, -1.0)
                if shadow.will_write(t):
                    state = eng.ensure_lt_capacity(state, shadow.count + 1)
                rows = ([row_state(state, i) for i in range(n)]
                        if n == max(ns) and t in check else None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, preds, logits = eng.step_videos(
                    state, frames[t, :n], (SIZE, SIZE))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if rows is not None:
                    counts = read_counts(kernels)
                    for i, st in enumerate(rows):
                        _, pred1, logit1 = eng.step_videos(
                            st, frames[t, i:i + 1], (SIZE, SIZE))
                        diff = (logits[i:i + 1] - logit1).abs().max().item()
                        worst[0] = max(worst[0], diff)
                        worst[1] = min(worst[1], (preds[i:i + 1] == pred1)
                                       .float().mean().item())
                    restore_counts(kernels, counts)
                shadow.update(t)
            peak = torch.cuda.max_memory_allocated() / 2**20
            launches = read_counts(kernels)
            want = expected_launches(kernels, steps + 1, flash_reads,
                                     cfg.MODEL_LSTT_NUM)
            if launches != want:
                raise AssertionError(f"phase 21 {name} N={n}: launches "
                                     f"{launches} != {want}")
            for k in kernels:
                total[k] += launches[k]
            timed = np.asarray(seconds[WARMUP:]) * 1e3
            step_ms = float(np.median(timed))
            print(f"phase 21: {name} N={n} videos a step, {SIZE}x{SIZE}, "
                  f"{OBJECTS} objects each, {steps} steps ({flash_reads} on "
                  f"the flash kernel): median {step_ms:.3f} ms a step (p90 "
                  f"{np.percentile(timed, 90):.3f}), {n * 1e3 / step_ms:.1f} "
                  f"frames/s in all; peak memory {peak:.0f} MiB; launches "
                  f"{launches} ({card})", flush=True)
            if n == max(ns):
                print(f"phase 21: {name} N={n}: each row stepped alone from "
                      f"a copy of its state at steps {sorted(check)}: grid "
                      f"logits max_abs_err {worst[0]:.3e} (gate {BATCH_TOL}; "
                      f"{'bit-identical' if worst[0] == 0 else 'not bit-identical: cuDNN or cuBLAS took another algorithm or order at this batch'}"
                      f"), masks agree on {worst[1]:.6f} (gate "
                      f"{MASK_AGREE})", flush=True)
                if not (worst[0] <= BATCH_TOL and worst[1] >= MASK_AGREE):
                    raise AssertionError(f"phase 21 {name}: rows vs alone "
                                         f"{worst}")
        del model, eng, state, frames
        torch.cuda.empty_cache()
    return total


CHUNK = 8


def run_chunked(kernels, device, card: str, video, mask):
    """Phase 22: AOTT and DeAOTL stepped K = CHUNK frames at a time
    (VOSInferEngine.step_chunk, the masks read back once a chunk) against
    per-frame stepping with a readback each frame, from the reference frame
    of the same clip, 56 frames (7 chunks; DeAOTL's flash switch at step
    46): a first chunked pass under torch.cuda.set_sync_debug_mode("error")
    (any synchronisation inside a chunk raises), its masks bit-identical to
    per-frame stepping, then a second chunked pass without the debug mode,
    timed beside per-frame stepping. Returns the first pass's launches by
    kernel name."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.ops.attention import use_flash

    frames_n = 7 * CHUNK
    total = {name: 0 for name in kernels}
    hw = grid_side(SIZE) ** 2
    frames = torch.from_numpy(video[:frames_n + 1]).to(device)
    ref = torch.from_numpy(mask).to(device)
    for name, model_name in (("AOTT", "aott"), ("DeAOTL", "deaotl")):
        cfg = build_config(stage="pre_ytb_dav", model=model_name,
                           TEST_LONG_TERM_MEM_CAP=8)
        eng = build_infer_engine(seeded_model(cfg, device), cfg)

        def per_frame():
            state = eng.add_reference_frame(frames[0], ref, OBJECTS)
            shadow = eng.make_shadow()
            shadow.add_ref(0)
            masks, secs = [], []
            for t in range(1, frames_n + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, pred, _ = grow_then_step(eng, shadow, state, frames[t],
                                                t, (SIZE, SIZE))
                masks.append(pred.to(torch.uint8).cpu())
                secs.append(time.perf_counter() - t0)
            return masks, float(np.median(secs[WARMUP:]) * 1e3)

        def chunked(debug: bool):
            state = eng.add_reference_frame(frames[0], ref, OBJECTS)
            shadow = eng.make_shadow()
            shadow.add_ref(0)
            masks, secs, flash_reads = [], [], 0
            for c0 in range(1, frames_n + 1, CHUNK):
                sh = copy.copy(shadow)
                for t in range(c0, c0 + CHUNK):
                    live = sh.count * hw
                    flash_reads += use_flash(live, live, -1, -1.0)
                    sh.update(t)
                state = eng.ensure_lt_capacity(state, sh.count)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if debug:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, preds = eng.step_chunk(
                        state, frames[c0:c0 + CHUNK], (SIZE, SIZE),
                        (SIZE, SIZE))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                masks += list(preds.cpu())
                secs.append((time.perf_counter() - t0) / CHUNK)
                for t in range(c0, c0 + CHUNK):
                    shadow.update(t)
            return masks, float(np.median(secs[1:]) * 1e3), flash_reads

        want, frame_ms = per_frame()
        reset_counts(kernels)
        got, debug_ms, flash_reads = chunked(debug=True)
        launches = read_counts(kernels)
        expect = expected_launches(kernels, frames_n + 1, flash_reads,
                                   cfg.MODEL_LSTT_NUM)
        if launches != expect:
            raise AssertionError(f"phase 22 {name}: launches {launches} != "
                                 f"{expect}")
        for k in kernels:
            total[k] += launches[k]
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        _, chunk_ms, _ = chunked(debug=False)
        _, frame_ms2 = per_frame()
        print(f"phase 22: {name} {SIZE}x{SIZE}, {frames_n} frames "
              f"({flash_reads} flash reads): step_chunk K={CHUNK} under "
              f"sync_debug_mode('error') (no synchronisation inside a chunk), "
              f"masks {'bit-identical to' if same else 'DIFFERENT from'} "
              f"per-frame stepping; median ms/frame (chunks after the first; "
              f"per frame after {WARMUP}), in the order run: per frame with a "
              f"readback each frame {frame_ms:.3f}, chunked under the debug "
              f"mode {debug_ms:.3f}, chunked {chunk_ms:.3f}, per frame "
              f"{frame_ms2:.3f}; launches {launches} ({card})", flush=True)
        if not same:
            raise AssertionError(f"phase 22 {name}: chunked masks differ")
    return total


def write_davis_clips(root: str, clips: int, frames: int, size, objects: int):
    """A DAVIS-2017 480p folder of `clips` seeded clips of moving ellipses
    (every frame annotated; the evaluator reads the first)."""
    import cv2
    from PIL import Image

    from aot_tpu_torch.utils.image import vos_palette

    hgt, wid = size
    davis = os.path.join(root, "DAVIS")
    names = [f"clip{i}" for i in range(clips)]
    os.makedirs(os.path.join(davis, "ImageSets", "2017"), exist_ok=True)
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for i, seq in enumerate(names):
        video, lab = synthetic_video(SEED + 20 + i, frames, max(size),
                                     objects)
        img_dir = os.path.join(davis, "JPEGImages", "480p", seq)
        ann_dir = os.path.join(davis, "Annotations", "480p", seq)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        for t in range(frames):
            rgb = video[t, 0, :hgt, :wid]
            cv2.imwrite(os.path.join(img_dir, f"{t:05d}.jpg"), rgb[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            if t == 0:
                im = Image.fromarray(lab[0, :hgt, :wid].astype(np.uint8))
                im = im.convert("P")
                im.putpalette(vos_palette())
                im.save(os.path.join(ann_dir, f"{t:05d}.png"))
    return names


def run_eval_modes(kernels, device, card: str):
    """Phase 22: `python -m aot_tpu_torch.eval` on a written DAVIS-2017
    480p folder of 5 clips of 10 frames (480x854, 5 objects): the scalar
    run, then --video_batch 4 --frame_chunk 8 (4 clips batched, the 5th
    chunked 8 + 1), its PNGs equal to the scalar run's, then the same with
    --amp, its PNGs >= 99.5% equal. Returns the launches by kernel name."""
    import shutil

    from PIL import Image

    from aot_tpu_torch.eval import __main__ as eval_cli

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_modes")
    shutil.rmtree(root, ignore_errors=True)
    names = write_davis_clips(root, 5, 10, (480, 854), 5)
    base = ["--stage", "pre_ytb_dav", "--model", "aott", "--dataset",
            "davis2017", "--ckpt_path", "test", "--device", str(device),
            "--set", f"DIR_DATA={root}", "--set", f"DIR_ROOT={root}"]
    total = {name: 0 for name in kernels}
    results = {}
    for label, extra in (("scalar", []),
                         ("modes", ["--video_batch", "4", "--frame_chunk",
                                    "8"]),
                         ("amp", ["--video_batch", "4", "--frame_chunk", "8",
                                  "--amp"])):
        reset_counts(kernels)
        ev, summary = eval_cli.run(base + extra + ["--exp_name", label])
        launches = read_counts(kernels)
        for k in kernels:
            total[k] += launches[k]
        pngs = {}
        for seq in names:
            d = os.path.join(ev.result_root, seq)
            for f in sorted(os.listdir(d)):
                pngs[f"{seq}/{f}"] = np.array(Image.open(os.path.join(d, f)))
        results[label] = pngs
        print(f"phase 22: python -m aot_tpu_torch.eval {' '.join(extra)}: "
              f"{summary['sequences']} clips, {summary['total_frames']} "
              f"frames, {summary['fps']:.1f} frames/s; launches {launches} "
              f"({card})", flush=True)
    want = results["scalar"]
    for label in ("modes", "amp"):
        got = results[label]
        if got.keys() != want.keys() or len(want) != 5 * 9:   # no frame 0
            raise AssertionError(f"phase 22 {label}: {len(got)} PNGs")
        agree = min(float((got[f] == want[f]).mean()) for f in want)
        print(f"phase 22: {label} PNGs vs the scalar run: worst frame "
              f"{agree:.6f} of pixels equal (gate "
              f"{1.0 if label == 'modes' else 0.995})", flush=True)
        if agree < (1.0 if label == "modes" else 0.995):
            raise AssertionError(f"phase 22 {label}: PNG agreement {agree}")
    return total


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-eval", action="store_true",
                        help="profile phase 12's evaluation instead of "
                             "running the phases")
    parser.add_argument("--no-autotune", action="store_true",
                        help="with --profile-eval: cuDNN's default "
                             "convolution algorithms")
    parser.add_argument("--profile-serve", metavar="MODEL",
                        help="profile MODEL's serving path (e.g. "
                             "r50_deaotl) instead of running the phases")
    parser.add_argument("--profile-train", metavar="MODEL",
                        help="profile MODEL's training step (e.g. aott, "
                             "r50_deaotl) instead of running the phases")
    parser.add_argument("--profile-bwd", action="store_true",
                        help="profile the flash backward's kernels at the "
                             "training and long-read shapes instead of "
                             "running the phases")
    parser.add_argument("--profile-fwd", action="store_true",
                        help="profile the bf16 forward kernels (local "
                             "window and flash) at phase 19's shapes "
                             "instead of running the phases")
    parser.add_argument("--dtype", default="bfloat16",
                        help="with --profile-train: TRAIN_DTYPE")
    parser.add_argument("--trainable-bn", action="store_true",
                        help="with --profile-train: MODEL_FREEZE_BN=False")
    parser.add_argument("--bn-sensitivity", action="store_true",
                        help="print the CPU's own move of a trainable-BN "
                             "train step by size (phase 29's gate) instead "
                             "of running the phases; needs no card")
    parser.add_argument("--batch", type=int, default=None,
                        help="with --profile-serve: N videos a step "
                             "(step_videos, default 1); with "
                             "--profile-train: clips a step (default "
                             f"{TRAIN_BATCH})")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.bn_sensitivity:
        return bn_sensitivity()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the "
              "card only", file=sys.stderr)
        return 2

    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa
    from aot_tpu_torch.ops.kernels import swin_window_attn as swa

    kernels = kernel_counters()
    sources = list(dict.fromkeys(src for *_, src in KERNELS.values()))
    start = time.perf_counter()

    # phase 0
    card = card_line()
    print(card, flush=True)
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if args.profile_eval:
        return profile_full_res_eval(card, not args.no_autotune)
    if args.profile_serve:
        return profile_serving(card, args.profile_serve, args.batch or 1)
    if args.profile_bwd:
        return profile_bwd(card)
    if args.profile_fwd:
        return profile_fwd(card)
    if args.profile_train:
        return profile_training(card, args.profile_train, args.dtype,
                                args.batch or TRAIN_BATCH, args.trainable_bn)

    # phase 1
    t0 = time.perf_counter()
    sos = _build.build(*sources)
    lwa._entry(torch.float32)
    fa._entry(torch.float32)
    lwa._bf16_lib()
    fa._bf16_lib()
    fab._lib()
    swa._lib()
    print(f"phase 1: built {', '.join(os.path.relpath(s) for s in sos)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_build_logs(sources)

    # phases 2, 3, 8, 9, 19
    max_err = check_kernel_numerics(lwa, fa, device)
    times = time_kernels(lwa, fa, device, card)
    max_err["flash_attn_bwd"] = check_bwd_numerics(fa, fab, device)
    times["flash_attn_bwd"] = time_bwd(fa, fab, device, card)
    bf16_err, bf16_times = check_bf16_kernels(lwa, fa, device, card)
    max_err.update(bf16_err)
    times.update(bf16_times)
    max_err["flash_attn_bwd_bf16"] = check_bf16_bwd(fa, fab, device)
    times["flash_attn_bwd_bf16"] = time_bf16_bwd(fa, fab, device, card)
    (max_err["swin_window_attn"],
     times["swin_window_attn"]) = check_window_kernel(device, card)
    print(f"phases 1-3, 8, 9, 19, 23, 24, 34 done at "
          f"{time.perf_counter() - start:.1f} s", flush=True)

    # phases 4-7
    video, mask = synthetic_video(SEED, STEPS + 1 + CPU_STEPS, SIZE, OBJECTS)
    paths = [("AOTT", build_config(stage="pre_ytb_dav", model="aott",
                                   TEST_LONG_TERM_MEM_CAP=8)),
             ("DeAOTL", build_config(stage="pre_ytb_dav", model="deaotl"))]
    total = {name: 0 for name in kernels}
    fp32_runs = {}      # phase 20 compares its bf16 runs with these
    for i, (name, cfg) in enumerate(paths):
        preds = []
        launches, ms = drive(name, cfg, device, video, mask, kernels, card,
                             4 + 2 * i, preds=preds)
        fp32_runs[name] = (cfg, preds, ms)
        for k in kernels:
            total[k] += launches[k]
        if name == "AOTT" and launches["flash_attn_fwd"] != 0:
            raise AssertionError("AOTT reached the flash kernel")
        if name == "DeAOTL" and launches["flash_attn_fwd"] == 0:
            raise AssertionError("DeAOTL never reached the flash kernel")

    print(f"phases 4-7 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 10, 11
    for k, n in run_training(kernels, device, card)[0].items():
        total[k] += n
    compare_train_step(device)
    print(f"phases 10, 11 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 12, 13
    ev, launches = run_full_res_eval(kernels, device, card)
    for k, n in launches.items():
        total[k] += n
    compare_full_res_with_cpu(ev, device)
    print(f"phases 12, 13 done at {time.perf_counter() - start:.1f} s",
          flush=True)
    del ev

    # phases 14-17: the two DeAOT flagships, then phase 18: all 14 variants
    for i, (name, model) in enumerate((("R50_DeAOTL", "r50_deaotl"),
                                       ("SwinB_DeAOTL", "swinb_deaotl"))):
        cfg = build_config(stage="pre_ytb_dav", model=model)
        size = serving_size(cfg)
        launches, _ = drive(name, cfg, device, *crop(video, mask, size),
                            kernels, card, 14 + 2 * i, size)
        if launches["flash_attn_fwd"] == 0:
            raise AssertionError(f"{name} never reached the flash kernel")
        for k in kernels:
            total[k] += launches[k]
    print(f"phases 14-17 done at {time.perf_counter() - start:.1f} s",
          flush=True)
    for k, n in run_variants(kernels, device, card, video, mask).items():
        total[k] += n
    print(f"phase 18 done at {time.perf_counter() - start:.1f} s", flush=True)

    # phases 20-22: bf16, batched and chunked serving
    for part in (run_bf16_serving(kernels, device, card, video, mask,
                                  fp32_runs),
                 run_full_res_eval_bf16(kernels, device, card),
                 run_variants(kernels, device, card, video, mask, "bfloat16",
                              20)):
        for k, n in part.items():
            total[k] += n
    print(f"phase 20 done at {time.perf_counter() - start:.1f} s", flush=True)
    for part in (run_batched(kernels, device, card),
                 run_chunked(kernels, device, card, video, mask),
                 run_eval_modes(kernels, device, card)):
        for k, n in part.items():
            total[k] += n
    print(f"phases 21, 22 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 25-27: training at the configs' dtype, bf16, and DeAOT training
    frozen_run = None     # phase 26's (ms/step, peak GiB), beside 28's
    for part in (run_training(kernels, device, card, 25, "aott", "bfloat16"),
                 run_training(kernels, device, card, 26, "r50_deaotl",
                              "bfloat16", DEAOT_TRAIN_BATCH,
                              DEAOT_TRAIN_STEPS)):
        for k, n in part[0].items():
            total[k] += n
        frozen_run = part[1:]
    compare_train_step(device, "aott", "bfloat16", 27)
    compare_train_step(device, "deaott", "float32", 27,
                       TRAIN_LONG_TERM_MEM_GAP=1)
    compare_train_step(device, "deaott", "bfloat16", 27,
                       TRAIN_LONG_TERM_MEM_GAP=1)
    print(f"phases 25-27 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 28-30: data-parallel training with trainable BN
    launches, ms, peak = run_training(
        kernels, device, card, 28, "r50_deaotl", "bfloat16",
        DEAOT_TRAIN_BATCH, DEAOT_TRAIN_STEPS, nccl=True,
        after=lambda trainer, cfg: trainable_bn_checks(trainer, cfg,
                                                       kernels),
        MODEL_FREEZE_BN=False, TRAIN_TBLOG_STEP=5)
    for k, n in launches.items():
        total[k] += n
    print(f"phase 28: R50_DeAOTL bf16 B={DEAOT_TRAIN_BATCH} with trainable "
          f"BN (NCCL, world size 1) {ms:.1f} ms/step, peak {peak:.2f} GiB, "
          f"against phase 26's frozen BN {frozen_run[0]:.1f} ms/step, "
          f"{frozen_run[1]:.2f} GiB in this call: {ms / frozen_run[0]:.3f}x "
          f"the time, +{peak - frozen_run[1]:.2f} GiB ({card})", flush=True)
    compare_trainable_bn(device)
    compare_train_step(device, "aott", "float32", 29, deterministic=True,
                       MODEL_FREEZE_BN=False)
    for k, n in compare_dp_step(device, card).items():
        total[k] += n
    print(f"phases 28-30 done at {time.perf_counter() - start:.1f} s",
          flush=True)
    check_attn_knobs(kernels, device, card)
    print(f"phase 31 done at {time.perf_counter() - start:.1f} s",
          flush=True)
    for k, n in run_entry_points(kernels, device, card).items():
        total[k] += n
    print(f"phase 32 done at {time.perf_counter() - start:.1f} s",
          flush=True)
    unused = [name for name, n in total.items() if n == 0]
    if unused:
        raise AssertionError(f"kernels no main path launched: {unused}")

    for mod in sys.modules:
        if mod.split(".")[0] in ("jax", "flax", "aot_tpu"):
            raise AssertionError(f"{mod} was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"aot_tpu_torch/csrc/{KERNELS[name][2]}.cu",
        "replaces": KERNELS[name][1],
        "launches": total[name],
        "max_abs_err": max_err[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": times[name][3][0],
        "bound_by": times[name][3][1],
        "library_ms": times[name][2],
    } for name in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
