#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (aot_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-eval [--no-autotune]

The second form profiles phase 12's evaluation and runs nothing else
(`profile_full_res_eval`).

Phases (2, 3, 8 and 9, the kernel checks, run first, then 4 to 7, then 10
to 13); any failure raises and the exit code is non-zero:
  0. refuse to run without a card; print the card's name and power limit
     (nvidia-smi) and the torch/CUDA versions; TF32 off for matmuls and
     convolutions.
  1. build the CUDA kernels from aot_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, all at once).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it (max abs error <= 1e-4): the flat
     local-window kernel at the 465x465 grids, the wide one at the
     full-resolution grids (64x113 and 68x120 with rel_v, 43x76 at B=2,
     DeAOT's head at 64x113, a 5x3 grid narrower than the window), both at
     the TPU narrow kernel's test shapes (10x12, 9x7, 8x8, with and without
     rel_v), the flash forward at six shapes.
  3. kernel and plain times (CUDA events, median of 2 x 50 runs, in the
     order plain, kernels, kernels reversed, plain): the wide and the flat
     local-window kernels at 64x113 (AOT and DeAOT heads) and at 30x30
     (AOT), the flash kernel at DeAOTL's long-term shape with 9,000 and
     19,800 keys and, there, F.scaled_dot_product_attention with a boolean
     live-key mask (the library yardstick; the port never calls it).
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
     and 19,800, and a row with no live key.
  9. backward kernel and plain times, as 3, at AOTT's training shape and
     DeAOTL's LT shape (Lk=19,800); at AOTT's, the autograd backward of
     F.scaled_dot_product_attention as the library yardstick.
 10. the third main path, AOTT training: Trainer.sequential_training on a
     seeded clip source (TRAIN_BATCH clips of moving ellipses, 465x465,
     T=5, fixed: every step sees the same clips), stage pre_ytb_dav, fp32,
     TF32 off, per-frame recompute, TRAIN_TOTAL_STEPS = 1000 (the length of
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
     64x113 = 7,232-token grid (asserted), so every short-term read takes
     the wide kernel. Launches asserted: the wide kernel once per LSTT
     forward (each frame, the reference frame included, per block), the
     flat kernel 0, the flash forward once per LT read of >= 8,192 live
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
 14. one JSON line with the kernels (launches summed over the main paths;
     each kernel's time, plain time, bound and library time at its main
     shape), the card line, and last the result line {"ok": true,
     "device": {...}}.
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
BWD_TOL = 1e-4      # of each gradient's largest entry: fp32, summation order
TRAIN_BATCH = 16    # AOTT's training batch (configs TRAIN_BATCH_SIZE)
TRAIN_T = 5         # DATA_SEQ_LEN
TRAIN_OBJECTS = 5
TRAIN_WARMUP = 3
TRAIN_STEPS = 15    # warm-up included
TRAIN_SCHEDULE = 1000  # TRAIN_TOTAL_STEPS: the LR, aux-weight and hard-mining
                       # schedules' length; the steps run stay in its warm-up
CMP_SIZE, CMP_BATCH, CMP_T = 97, 2, 3   # phase 11
EVAL_SIZE = (1080, 1920)  # DAVIS 2017 Full-Resolution frames
EVAL_GRID = (64, 113)     # at --max_resolution 1080: 1009x1793 input
EVAL_FRAMES = 9           # the reference frame, then 8 timed by the evaluator
EVAL_OBJECTS = 5
EVAL_WARMUP = 3           # of the evaluator's timed frames

# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, and
# HBM3 bandwidth. A kernel's bound is the larger of its operations over the
# first and its bytes (each input read once, each output written once) over
# the second.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# kernel name (= its csrc/<name>.cu) -> (module under aot_tpu_torch.ops.
# kernels, the launch counter its wrapper keeps, the TPU kernel it replaces)
KERNELS = {
    "local_window_attn": ("local_window_attn", "LAUNCHES",
                          "aot_tpu/ops/pallas/local_window_attn.py:414"),
    "local_window_attn_wide": ("local_window_attn", "WIDE_LAUNCHES",
                               "aot_tpu/ops/pallas/local_window_attn.py:236"),
    "flash_attn_fwd": ("flash_attn", "LAUNCHES",
                       "aot_tpu/ops/pallas/flash_attn_vjp.py:51"),
    "flash_attn_bwd": ("flash_attn_bwd", "LAUNCHES",
                       "aot_tpu/ops/pallas/flash_attn_vjp.py:267"),
}


def reset_counts(kernels) -> None:
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)


def read_counts(kernels):
    return {name: getattr(mod, attr) for name, (mod, attr) in kernels.items()}


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


def flash_inputs(rng, b, lq, lk, h, d, dv, valid, device, ring=0):
    """q, k, v, valid_len for the flash kernel. ring > 0 hands it k and v as
    the live prefix of a longer ring (batch stride > Lk rows), as the
    engine does; valid: None, an int, or a list (a (B,) int32 tensor)."""
    q, k, v = to_device([rng.randn(b, lq, h * d), rng.randn(b, lk + ring, h * d),
                         rng.randn(b, lk + ring, h * dv)], device)
    if isinstance(valid, list):
        valid = torch.tensor(valid, dtype=torch.int32, device=device)
    return q, k[:, :lk], v[:, :lk], valid


def check_kernel_numerics(lwa, fa, device):
    """Phase 2: each kernel vs its plain version on the card. Returns the
    max error by kernel name."""
    rng = np.random.RandomState(SEED)
    # name, B, H, W, heads, d, dv, rel_v, max_dis, kernels
    flat, wide, both = ("flat",), ("wide",), ("flat", "wide")
    local_cases = [
        ("aott_st_b1", 1, 30, 30, 8, 32, 32, True, 7, flat),
        ("aott_st_b2", 2, 30, 30, 8, 32, 32, True, 7, flat),
        ("deaot_st_dv512", 1, 30, 30, 1, 128, 512, False, 7, flat),
        ("deaot_st", 1, 30, 30, 1, 128, 1024, False, 7, flat),
        ("aott_ragged_46x80", 1, 46, 80, 8, 32, 32, True, 7, both),
        ("aott_davis_1080p", 1, 64, 113, 8, 32, 32, True, 7, wide),
        ("aott_68x120", 1, 68, 120, 8, 32, 32, True, 7, wide),
        ("aott_720p_b2", 2, 43, 76, 8, 32, 32, True, 7, wide),
        ("deaot_davis_1080p", 1, 64, 113, 1, 128, 1024, False, 7, wide),
        ("aott_narrower_than_window", 1, 5, 3, 8, 32, 32, True, 7, wide),
    ]
    # the TPU narrow kernel's test shapes (tests/test_local_window_kernel.py)
    for hgt, wid in ((10, 12), (9, 7), (8, 8)):
        for rv in (True, False):
            local_cases.append((f"narrow_{hgt}x{wid}", 2, hgt, wid, 2, 8, 8,
                                rv, 2, both))
    fns = {"flat": ("local_window_attn", lwa.local_window_attention_cuda),
           "wide": ("local_window_attn_wide",
                    lwa.local_window_attention_wide_cuda)}
    worst = {"local_window_attn": 0.0, "local_window_attn_wide": 0.0}
    for name, b, hgt, wid, h, d, dv, rv, m, which in local_cases:
        args = local_inputs(rng, b, hgt, wid, h, d, dv, rv, m, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=m, d_att=d)
        want = lwa.local_window_attention_plain(*args, **kw)
        for kind in which:
            kname, fn = fns[kind]
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"phase 2: {kname} {name} B={b} {hgt}x{wid} h={h} d={d} "
                  f"dv={dv} rel_v={rv} max_dis={m}: max_abs_err {err:.3e}",
                  flush=True)
            if not err <= KERNEL_TOL:
                raise AssertionError(
                    f"{kname} {name}: kernel vs plain {err} > {KERNEL_TOL}")
            worst[kname] = max(worst[kname], err)

    flash_cases = [  # name, B, Lq, Lk, heads, d, dv, valid_len, ring
        ("deaotl_lk9000", 1, 900, 9000, 1, 128, 1024, 9000, 0),
        ("deaotl_lk14400_live9900", 1, 900, 14400, 1, 128, 1024, [9900], 0),
        ("deaotl_b2_ring", 2, 900, 14400, 1, 128, 1024, [14400, 8100], 3600),
        ("deaotl_b2_empty", 2, 900, 9000, 1, 128, 1024, [9000, 0], 0),
        ("aot_heads_lk14400", 1, 900, 14400, 8, 32, 32, None, 0),
        ("flash_mem_hw_check", 2, 900, 7200, 8, 32, 32, [7200, 4320], 0),
    ]
    worst_flash = 0.0
    for name, b, lq, lk, h, d, dv, valid, ring in flash_cases:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device,
                                   ring)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, vl, h, d)
        torch.cuda.synchronize()
        err = max((out - want_out).abs().max().item(),
                  (lse - want_lse).abs().max().item())
        if name == "deaotl_b2_empty" and not (
                bool((out[1] == 0).all()) and bool((lse[1] == fa.NEG_INF).all())):
            raise AssertionError(f"{name}: an empty row is not out 0, lse -1e30")
        print(f"phase 2: flash_attn_fwd {name} B={b} Lq={lq} Lk={lk} h={h} "
              f"d={d} dv={dv} valid={valid}: max_abs_err (out, lse) "
              f"{err:.3e}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
        worst_flash = max(worst_flash, err)
    worst["flash_attn_fwd"] = worst_flash
    return worst


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


def bound(flops: float, nbytes: float):
    """(ms, 'operations' or 'bytes'): the least time the card could take."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def local_bound(b, hgt, wid, h, d, dv, with_rv, max_dis=7):
    """Local-window attention: per head and query, 2d FLOPs of q.k and 2dv
    of p.v (2dv more for p.rel_v) for each window slot inside the image
    (slots outside are never read); q, k, v, rel_bias, rel_v read once and
    out written once, fp32."""
    r = np.arange(-max_dis, max_dis + 1)
    rows = ((np.arange(hgt)[:, None] + r) >= 0) & (
        (np.arange(hgt)[:, None] + r) < hgt)
    cols = ((np.arange(wid)[:, None] + r) >= 0) & (
        (np.arange(wid)[:, None] + r) < wid)
    slots = float(rows.sum()) * float(cols.sum())   # in-image (query, slot)
    flops = b * h * slots * (2 * d + 2 * dv * (2 if with_rv else 1))
    win2 = (2 * max_dis + 1) ** 2
    hw = hgt * wid
    nbytes = 4 * (b * hw * h * (2 * d + 2 * dv) + b * h * hw * win2
                  + (h * dv * win2 if with_rv else 0))
    return bound(flops, nbytes)


def flash_fwd_bound(b, lq, live, h, d, dv):
    """Attention over `live` keys: 2(d + dv) FLOPs per (query, live key,
    head); q, the live k and v read once, out and lse written once."""
    flops = 2.0 * b * h * lq * live * (d + dv)
    nbytes = 4 * (b * lq * h * (d + dv) + b * live * h * (d + dv) + b * h * lq)
    return bound(flops, nbytes)


def flash_bwd_bound(b, lq, live, h, d, dv):
    """Its backward: S = QK^T and dP = dO V^T recomputed, dV = P^T dO,
    dQ = dS K, dK = dS^T Q: 2(3d + 2dv) FLOPs per (query, live key, head);
    q, k, v, out, dout, lse read once, dq, dk, dv written once."""
    flops = 2.0 * b * h * lq * live * (3 * d + 2 * dv)
    nbytes = 4 * (b * lq * h * (2 * d + 2 * dv) + 2 * b * live * h * (d + dv)
                  + b * h * lq)
    return bound(flops, nbytes)


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


def time_kernels(lwa, fa, device, card: str):
    """Phase 3. Returns {name: (kernel ms, plain ms, library ms or None,
    (bound ms, what bounds it))}
    at the shapes the JSON line reports: the flat kernel at AOTT's 465x465
    ST shape, the wide one at AOTT's DAVIS 1080p ST shape, the flash
    forward at DeAOTL's longest LT read."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 1)
    times = {}
    for label, hgt, wid, h, d, dv, rv in (
            ("AOTT 465x465 ST", 30, 30, 8, 32, 32, True),
            ("DeAOT 465x465 ST", 30, 30, 1, 128, 1024, False),
            ("AOTT DAVIS 1080p ST", 64, 113, 8, 32, 32, True),
            ("DeAOT DAVIS 1080p ST", 64, 113, 1, 128, 1024, False)):
        args = local_inputs(rng, 1, hgt, wid, h, d, dv, rv, 7, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        t = time_fns({
            "plain": lambda: lwa.local_window_attention_plain(*args, **kw),
            "wide": lambda: lwa.local_window_attention_wide_cuda(*args, **kw),
            "flat": lambda: lwa.local_window_attention_cuda(*args, **kw)},
            *((20, 3) if hgt * wid > 2500 else ()))
        b_ms, b_by = local_bound(1, hgt, wid, h, d, dv, rv)
        print(f"phase 3: local window {label} {hgt}x{wid} h={h} d={d} "
              f"dv={dv} B=1: wide kernel {t['wide']:.4f} ms, flat kernel "
              f"{t['flat']:.4f} ms, plain {t['plain']:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        if label == "AOTT 465x465 ST":
            times["local_window_attn"] = (t["flat"], t["plain"], None,
                                          (b_ms, b_by))
        if label == "AOTT DAVIS 1080p ST":
            times["local_window_attn_wide"] = (t["wide"], t["plain"], None,
                                               (b_ms, b_by))
    for lk in (9000, 19800):
        q, k, v, vl = flash_inputs(rng, 1, 900, lk, 1, 128, 1024, lk, device)
        qs, ks, vs, mask = sdpa_args(q, k, v, vl, 1, 128)
        t = time_fns({
            "plain": lambda: fa.flash_attention_plain(q, k, v, vl, 1, 128),
            "kernel": lambda: fa.flash_attention_cuda(q, k, v, vl, 1, 128),
            "library": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)})
        lib_err = (F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
                   .transpose(1, 2).reshape(1, 900, 1024)
                   - fa.flash_attention_plain(q, k, v, vl, 1, 128)[0]
                   ).abs().max().item()
        b_ms, b_by = flash_fwd_bound(1, 900, lk, 1, 128, 1024)
        print(f"phase 3: flash_attn_fwd DeAOTL LT shape Lq=900 Lk={lk} h=1 "
              f"d=128 dv=1024: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, F.scaled_dot_product_attention with a "
              f"boolean live-key mask {t['library']:.4f} ms (vs plain "
              f"{lib_err:.1e}); bound {b_ms:.4f} ms ({b_by}) ({card})",
              flush=True)
        times["flash_attn_fwd"] = (t["kernel"], t["plain"], t["library"],
                                   (b_ms, b_by))
    return times


def check_step_outputs(pred, logits, size: int):
    grid = (size - 1) // 4 + 1
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


def run_main_path(cfg, device, video, mask, steps: int, kernels):
    """Phases 4 and 6. Returns (model, engine, state, shadow, per-step
    seconds, per-step flash flags, launches by kernel name)."""
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.ops.attention import use_flash

    model = build_vos_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
    eng = build_infer_engine(model, cfg)
    frames = torch.from_numpy(video[:steps + 1]).to(device)  # one upload
    ref_mask = torch.from_numpy(mask).to(device)
    hw = ((SIZE - 1) // 16 + 1) ** 2
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
                                     eng.engine.max_mem_len_ratio))
        t0 = time.perf_counter()
        state, pred, logits = grow_then_step(eng, shadow, state, frames[t], t,
                                             (SIZE, SIZE))
        sync()
        seconds.append(time.perf_counter() - t0)
        check_step_outputs(pred, logits, SIZE)   # outside the timed region
    launches = read_counts(kernels)
    return model, eng, state, shadow, seconds, flash_steps, launches


def compare_with_cpu(cfg, model, eng, state, shadow, video, label: str):
    """Phases 5 and 7: the same steps from the same state on the card and
    on the CPU (plain path). Returns (max logit error, min mask
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
            (SIZE, SIZE))
        cpu_state, cpu_pred, cpu_logits = grow_then_step(
            cpu_eng, cpu_shadow, cpu_state, frame, t, (SIZE, SIZE))
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


def drive(name, cfg, device, video, mask, kernels, card: str, phase: int):
    """One main path (phase `phase`) and its card-vs-CPU check (the next
    phase). Returns the launches by kernel name."""
    torch.cuda.reset_peak_memory_stats()
    model, eng, state, shadow, seconds, flash_steps, launches = run_main_path(
        cfg, device, video, mask, STEPS, kernels)
    peak = torch.cuda.max_memory_allocated() / 2**20
    layers = cfg.MODEL_LSTT_NUM
    want = {"local_window_attn": (STEPS + 1) * layers,
            "local_window_attn_wide": 0,
            "flash_attn_fwd": sum(flash_steps) * layers, "flash_attn_bwd": 0}
    print(f"phase {phase}: {name} kernel launches in the main path: "
          f"{launches} (expected from the LT schedule: {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} != {want}")
    timed = np.asarray(seconds[WARMUP:]) * 1e3
    flags = np.asarray(flash_steps[WARMUP:])
    frame_ms = float(np.median(timed))
    print(f"phase {phase}: {name} {SIZE}x{SIZE}, {OBJECTS} objects, fp32, "
          f"{len(timed)} steps after {WARMUP} warm-up: median "
          f"{frame_ms:.3f} ms/frame ({1e3 / frame_ms:.2f} FPS), p90 "
          f"{np.percentile(timed, 90):.3f} ms; LT frames at the end "
          f"{shadow.count}; peak memory {peak:.0f} MiB ({card})", flush=True)
    for label, sel in (("before", ~flags), ("after", flags)):
        if sel.any():
            print(f"phase {phase}: {name} {label} the flash switch: "
                  f"{int(sel.sum())} steps, median "
                  f"{float(np.median(timed[sel])):.3f} ms/frame ({card})",
                  flush=True)
    if sum(flash_steps) and shadow.count < MIN_LT_FRAMES_CPU:
        raise AssertionError(f"{name}: {shadow.count} LT frames at the end")
    compare_with_cpu(cfg, model, eng, state, shadow, video, str(phase + 1))
    return launches


def check_bwd_numerics(fa, fab, device):
    """Phase 8: the backward kernels vs their plain version, gated on the
    error relative to each gradient's largest entry. Returns the worst
    absolute error."""
    rng = np.random.RandomState(SEED + 2)
    cases = [  # name, B, Lq, Lk, heads, d, dv, valid_len
        ("aott_train", 16, 900, 900, 8, 32, 32, None),
        ("aott_train_partial", 16, 900, 900, 8, 32, 32,
         [900 - 37 * i for i in range(16)]),
        ("hw_check", 2, 900, 7200, 8, 32, 32, [7200, 4320]),
        ("deaotl_lk9000", 1, 900, 9000, 1, 128, 1024, None),
        ("deaotl_lk19800", 1, 900, 19800, 1, 128, 1024, [19800]),
        ("empty_row", 2, 130, 200, 2, 32, 32, [200, 0]),
    ]
    worst = 0.0
    for name, b, lq, lk, h, d, dv, valid in cases:
        q, k, v, vl = flash_inputs(rng, b, lq, lk, h, d, dv, valid, device)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, lq, h * dv), dtype=torch.float32,
                            device=device)
        got = fab.flash_attention_bwd_cuda(q, k, v, vl, out, lse, dout, h, d)
        want = fab.flash_attention_bwd_plain(q, k, v, vl, out, lse, dout, h,
                                             d)
        torch.cuda.synchronize()
        errs, rels = [], []
        for g, w in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: non-finite gradient")
            errs.append((g - w).abs().max().item())
            rels.append(errs[-1] / max(w.abs().max().item(), 1e-30))
        if name == "empty_row" and any(bool(g[1].any()) for g in got):
            raise AssertionError(f"{name}: a row with no live key has "
                                 "non-zero gradients")
        print(f"phase 8: flash_attn_bwd {name} B={b} Lq={lq} Lk={lk} h={h} "
              f"d={d} dv={dv}: max_abs_err (dq, dk, dv) {errs[0]:.3e} "
              f"{errs[1]:.3e} {errs[2]:.3e}; / max|grad| {rels[0]:.3e} "
              f"{rels[1]:.3e} {rels[2]:.3e} (tolerance {BWD_TOL})", flush=True)
        if not max(rels) <= BWD_TOL:
            raise AssertionError(f"{name}: kernel vs plain {rels} > {BWD_TOL}")
        worst = max(worst, max(errs))
    return worst


def time_bwd(fa, fab, device, card: str):
    """Phase 9. Returns (kernel ms, plain ms, library ms, (bound ms, what
    bounds it)) at AOTT's training shape; the library yardstick is the autograd backward of
    F.scaled_dot_product_attention with a boolean live-key mask."""
    import torch.nn.functional as F

    rng = np.random.RandomState(SEED + 3)
    result = None
    for label, b, lk, h, d, dv in (("AOTT training", 16, 900, 8, 32, 32),
                                   ("DeAOTL LT", 1, 19800, 1, 128, 1024)):
        q, k, v, vl = flash_inputs(rng, b, 900, lk, h, d, dv, None, device)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, 900, h * dv), dtype=torch.float32,
                            device=device)
        args = (q, k, v, vl, out, lse, dout, h, d)
        fns = {"plain": lambda: fab.flash_attention_bwd_plain(*args),
               "kernel": lambda: fab.flash_attention_bwd_cuda(*args)}
        if result is None:
            qs, ks, vs, mask = sdpa_args(q, k, v, vl, h, d)
            leaves = [x.requires_grad_() for x in (qs, ks, vs)]
            with torch.enable_grad():
                lib_out = F.scaled_dot_product_attention(*leaves,
                                                         attn_mask=mask)
            lib_dout = dout.reshape(b, 900, h, dv).transpose(1, 2)
            fns["library"] = lambda: torch.autograd.grad(
                lib_out, leaves, lib_dout, retain_graph=True)
        t = time_fns(fns)
        b_ms, b_by = flash_bwd_bound(b, 900, lk, h, d, dv)
        lib = (f", F.scaled_dot_product_attention backward "
               f"{t['library']:.4f} ms" if "library" in t else "")
        print(f"phase 9: flash_attn_bwd {label} shape B={b} Lq=900 Lk={lk} "
              f"h={h} d={d} dv={dv}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms{lib}; bound {b_ms:.4f} ms ({b_by}) "
              f"({card})", flush=True)
        result = result or (t["kernel"], t["plain"], t["library"],
                            (b_ms, b_by))
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


def train_cfg(root: str, **over):
    from aot_tpu_torch.configs import build_config

    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TRAIN_DTYPE="float32", PRETRAIN=False,
                       TRAIN_AUTO_RESUME=False, DATA_WORKERS=0,
                       TRAIN_REMAT=True, TRAIN_LOG_STEP=5, DIR_ROOT=root,
                       **over)
    return cfg.init_dir(make=True)


def run_training(kernels, device, card: str):
    """Phase 10. Returns the launches by kernel name."""
    import shutil

    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.train.trainer import Trainer
    from aot_tpu_torch.utils import checkpoint as ckpt_lib

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    cfg = train_cfg(root, TRAIN_BATCH_SIZE=TRAIN_BATCH, DATA_SEQ_LEN=TRAIN_T,
                    TRAIN_TOTAL_STEPS=TRAIN_SCHEDULE)
    t0 = time.perf_counter()
    data = EllipseClips(TRAIN_BATCH, TRAIN_T, SIZE, TRAIN_OBJECTS)
    print(f"phase 10: {TRAIN_BATCH} clips of {TRAIN_T} frames at {SIZE}x{SIZE} "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    trainer = Trainer(cfg, seed=SEED, device=device)
    losses, ends = [], []

    def on_step(step, stats):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        losses.append(float(stats["loss"]))
        print(f"phase 10: step {step} loss {losses[-1]:.5f} pred_loss "
              f"{float(stats['pred_loss']):.5f} iou {float(stats['iou']):.4f} "
              f"grad_norm {float(stats['grad_norm']):.4f}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    start = time.perf_counter()
    trainer.sequential_training(TRAIN_STEPS, dataset=data, on_step=on_step)
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30

    step_ms = np.diff([start] + ends)[TRAIN_WARMUP:] * 1e3
    print(f"phase 10: AOTT training {SIZE}x{SIZE}, B={TRAIN_BATCH}, T={TRAIN_T}, "
          f"{TRAIN_OBJECTS} objects, fp32, recompute on, "
          f"TRAIN_TOTAL_STEPS={TRAIN_SCHEDULE}: {len(step_ms)} steps after "
          f"{TRAIN_WARMUP} warm-up: median {float(np.median(step_ms)):.1f} "
          f"ms/step, p90 {float(np.percentile(step_ms, 90)):.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_T * 1e3 / float(np.median(step_ms)):.1f} "
          f"frames/s; peak memory {peak:.2f} GiB ({card})", flush=True)
    layers = cfg.MODEL_LSTT_NUM
    per_step = {"flash_attn_fwd": (2 * TRAIN_T + 2 * (TRAIN_T - 1)) * layers,
                "flash_attn_bwd": 2 * TRAIN_T * layers,
                "local_window_attn": 0, "local_window_attn_wide": 0}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    print(f"phase 10: kernel launches in the training path: {launches}, "
          f"per step {({k: v / TRAIN_STEPS for k, v in launches.items()})} "
          f"(expected {per_step}: two global attentions a frame, the "
          f"{TRAIN_T - 1} propagated frames' forwards run again in the "
          "backward)", flush=True)
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")

    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"phase 10: mean loss of the first 5 steps {first:.5f}, of the "
          f"last 5 {last:.5f}", flush=True)
    if not last < first:
        raise AssertionError(f"the loss did not fall: {losses}")

    raw = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint(cfg.DIR_CKPT),
                                   device)
    if raw["step"] != TRAIN_STEPS or any(
            not torch.equal(v, raw["model"][k])
            for k, v in trainer.model.state_dict().items()):
        raise AssertionError("the raw checkpoint does not hold the model")
    serving = build_vos_model(cfg, device=device)
    ema = ckpt_lib.load_checkpoint(
        ckpt_lib.latest_checkpoint(cfg.DIR_EMA_CKPT), device)
    serving.load_state_dict(ema["state_dict"], strict=True)
    print(f"phase 10: checkpoint of step {raw['step']} reloaded (raw state "
          "equal, EMA weights loaded strictly into a serving model)",
          flush=True)
    return launches


def compare_train_step(device):
    """Phase 11: one train step on the card and on the CPU from the same
    weights and batch. Returns (loss error, worst gradient error)."""
    from aot_tpu_torch.engine.train import build_train_engine
    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.train.step import create_train_state, make_train_step

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cmp")
    cfg = train_cfg(root, TRAIN_LSTT_DROPPATH=0.0, TRAIN_TOTAL_STEPS=1000)
    data = EllipseClips(CMP_BATCH, CMP_T, CMP_SIZE, 3)
    frames = np.stack([c["frames"] for c in data.clips], axis=1)
    labels = np.stack([c["labels"] for c in data.clips], axis=1)
    out = {}
    for dev in (device, torch.device("cpu")):
        model = build_vos_model(cfg, device=dev, train=True,
                                generator=torch.Generator().manual_seed(SEED))
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, build_train_engine(model, cfg))
        stats = step(state, torch.from_numpy(frames).to(dev),
                     torch.from_numpy(labels).to(dev),
                     torch.full((CMP_BATCH,), 3, device=dev),
                     torch.Generator().manual_seed(SEED), False)
        out[dev.type] = (
            {k: float(stats[k]) for k in ("loss", "grad_norm")},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().cpu() for n, p in model.named_parameters()})
    (cs, cg, cp), (hs, hg, hp) = out["cuda"], out["cpu"]
    loss_err = abs(cs["loss"] - hs["loss"]) / abs(hs["loss"])
    norm_err = abs(cs["grad_norm"] - hs["grad_norm"]) / hs["grad_norm"]
    # a gradient's error over its leaf's largest entry, with a floor of
    # 1e-3 of the model's largest gradient: at init the self-attention's q
    # and k gradients are ~1e-9 of it (its tokens are near alike) and are
    # fp32 noise on both devices
    gmax = max(float(g.abs().max()) for g in hg.values())
    floor = 1e-6 * gmax
    rel = sorted(((float((cg[n] - hg[n]).abs().max())
                   / (float(hg[n].abs().max()) + 1e-3 * gmax),
                   float(hg[n].abs().max()) / gmax, n) for n in hg),
                 reverse=True)
    grad_err = rel[0][0]
    for r, scale, n in rel[:3]:
        print(f"phase 11: gradient {n}: err / (leaf scale + 1e-3 of the "
              f"model's largest) {r:.2e}; leaf scale / model's largest "
              f"{scale:.2e}", flush=True)
    lr = cfg.TRAIN_LR_MIN
    param_err = 0.0     # in LR units, outside entries whose gradient is noise
    for n, p in hp.items():
        noise = hg[n].abs() < floor if n in hg else torch.ones_like(
            p, dtype=torch.bool)
        err = (cp[n] - p).abs() / lr
        if bool((err[noise] > 2).any()):
            raise AssertionError(f"{n}: a noise entry moved > 2 LR units")
        param_err = max(param_err, float(err[~noise].max()) if
                        bool((~noise).any()) else 0.0)
    print(f"phase 11: train step card vs CPU ({CMP_SIZE}x{CMP_SIZE}, "
          f"B={CMP_BATCH}, T={CMP_T}): loss {cs['loss']:.6f} vs "
          f"{hs['loss']:.6f} (rel err {loss_err:.2e}), grad_norm rel err "
          f"{norm_err:.2e}, worst gradient err / leaf scale {grad_err:.2e}, "
          f"worst updated-parameter err {param_err:.3f} LR units "
          f"(tolerances 1e-4, 1e-4, 1e-3, 0.25)", flush=True)
    if not (loss_err <= 1e-4 and norm_err <= 1e-4 and grad_err <= 1e-3
            and param_err <= 0.25):
        raise AssertionError("train step: card and CPU disagree")
    return loss_err, grad_err


def write_davis_full_res(root: str, seed: int, frames: int,
                         objects: int) -> str:
    """A DAVIS-2017 Full-Resolution folder under root/DAVIS: one seeded
    1080x1920 clip of `frames` JPEG frames with `objects` ellipses moving
    over a noisy gradient, and every frame's palettised annotation (as
    DAVIS val has; the evaluator reads the first, J&F all). Returns the
    annotation directory."""
    import cv2
    from PIL import Image

    from aot_tpu_torch.utils.image import vos_palette

    hgt, wid = EVAL_SIZE
    seq = "ellipses"
    davis = os.path.join(root, "DAVIS")
    img_dir = os.path.join(davis, "JPEGImages", "Full-Resolution", seq)
    ann_root = os.path.join(davis, "Annotations", "Full-Resolution")
    for d in (img_dir, os.path.join(ann_root, seq),
              os.path.join(davis, "ImageSets", "2017")):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write(seq + "\n")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hgt, 0:wid].astype(np.float32)
    base = np.stack([yy / hgt, xx / wid, (yy + xx) / (hgt + wid)], -1) * 160
    centre = rng.uniform(0.25, 0.75, (objects, 2)) * (hgt, wid)
    radius = rng.uniform(0.05, 0.1, (objects, 2)) * (hgt, wid)
    speed = rng.uniform(-6.0, 6.0, (objects, 2))
    colour = rng.uniform(40, 255, (objects, 3)).astype(np.float32)
    palette = vos_palette()
    for t in range(frames):
        img = base + rng.standard_normal((hgt, wid, 3), np.float32) * 6
        lab = np.zeros((hgt, wid), np.uint8)
        for i in range(objects):
            cy, cx = centre[i] + t * speed[i]
            inside = (((yy - cy) / radius[i, 0]) ** 2
                      + ((xx - cx) / radius[i, 1]) ** 2) <= 1
            img[inside] = colour[i]
            lab[inside] = i + 1
        rgb = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(img_dir, f"{t:05d}.jpg"), rgb[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        im = Image.fromarray(lab).convert("P")
        im.putpalette(palette)
        im.save(os.path.join(ann_root, seq, f"{t:05d}.png"))
    return ann_root


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
    layers = cfg.MODEL_LSTT_NUM
    want = {"local_window_attn": 0,
            "local_window_attn_wide": EVAL_FRAMES * layers,
            "flash_attn_fwd": flash_reads * layers, "flash_attn_bwd": 0}
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
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    launches = sum(e.count for e in kernels) / frames
    print(f"profile: a frame (of {frames}, the reference frame included): "
          f"{total:.3f} ms of kernels, {launches:.0f} kernel launches",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"profile: {e.self_device_time_total / 1e3 / frames:8.3f} "
              f"ms/frame {e.count / frames:8.1f} launches/frame  "
              f"{e.key[:100]}", flush=True)
    return 0


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-eval", action="store_true",
                        help="profile phase 12's evaluation instead of "
                             "running the phases")
    parser.add_argument("--no-autotune", action="store_true",
                        help="with --profile-eval: cuDNN's default "
                             "convolution algorithms")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib

    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa

    kernels = {name: (importlib.import_module(
        f"aot_tpu_torch.ops.kernels.{mod}"), attr)
        for name, (mod, attr, _) in KERNELS.items()}
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

    # phase 1
    t0 = time.perf_counter()
    sos = _build.build(*kernels)
    for load in (lwa._lib, lwa._wide_lib, fa._lib, fab._lib):
        load()
    print(f"phase 1: built {', '.join(os.path.relpath(s) for s in sos)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            print(f"  nvcc {name}: {line}", flush=True)

    # phases 2, 3, 8, 9
    max_err = check_kernel_numerics(lwa, fa, device)
    times = time_kernels(lwa, fa, device, card)
    max_err["flash_attn_bwd"] = check_bwd_numerics(fa, fab, device)
    times["flash_attn_bwd"] = time_bwd(fa, fab, device, card)
    print(f"phases 1-3, 8, 9 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 4-7
    video, mask = synthetic_video(SEED, STEPS + 1 + CPU_STEPS, SIZE, OBJECTS)
    paths = [("AOTT", build_config(stage="pre_ytb_dav", model="aott",
                                   TEST_LONG_TERM_MEM_CAP=8)),
             ("DeAOTL", build_config(stage="pre_ytb_dav", model="deaotl"))]
    total = {name: 0 for name in kernels}
    for i, (name, cfg) in enumerate(paths):
        launches = drive(name, cfg, device, video, mask, kernels, card,
                         4 + 2 * i)
        for k in kernels:
            total[k] += launches[k]
        if name == "AOTT" and launches["flash_attn_fwd"] != 0:
            raise AssertionError("AOTT reached the flash kernel")
        if name == "DeAOTL" and launches["flash_attn_fwd"] == 0:
            raise AssertionError("DeAOTL never reached the flash kernel")

    print(f"phases 4-7 done at {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 10, 11
    for k, n in run_training(kernels, device, card).items():
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

    for mod in sys.modules:
        if mod.split(".")[0] in ("jax", "flax", "aot_tpu"):
            raise AssertionError(f"{mod} was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"aot_tpu_torch/csrc/{name}.cu",
        "replaces": KERNELS[name][2],
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
