#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (aot_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (2, 3, 8 and 9, the kernel checks, run first, then 4 to 7, then 10
and 11); any failure raises and the exit code is non-zero:
  0. refuse to run without a card; print the card's name and power limit
     (nvidia-smi) and the torch/CUDA versions; TF32 off for matmuls and
     convolutions.
  1. build the CUDA kernels from aot_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, all at once).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it (max abs error <= 1e-4).
  3. kernel and plain times (CUDA events, median of 2 x 50 runs, in the
     order plain, kernel, kernel, plain): the local-window kernel at the
     AOTT and DeAOT short-term shapes, the flash kernel at DeAOTL's
     long-term shape with 9,000 and 19,800 keys.
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
     DeAOTL's LT shape (Lk=19,800).
 10. the third main path, AOTT training: Trainer.sequential_training on a
     seeded clip source (TRAIN_BATCH clips of moving ellipses, 465x465,
     T=5, fixed: every step sees the same clips), stage pre_ytb_dav, fp32,
     TF32 off, per-frame recompute, TRAIN_TOTAL_STEPS = 1000 (the length of
     the LR, aux-weight and hard-mining schedules: the 15 steps run stay in
     the LR warm-up, 2e-5 rising to 7.04e-5, with the loss's definition
     nearly fixed), TRAIN_WARMUP untimed steps then TRAIN_STEPS -
     TRAIN_WARMUP timed ones. Prints the loss per step, the median and p90
     ms per step (host clock, ending in torch.cuda.synchronize()), the peak
     memory and each kernel's launches per step, which must be 2 flash
     forwards per frame plus one per recomputed frame, 2 flash backwards
     per frame, and 0 local-window launches. Gates: finite losses, the mean
     of the last 5 below the mean of the first 5, the checkpoint written at
     the end reloads (raw state equal to the trained model; the EMA state
     dict loads strictly into a serving model).
 11. one train step on the card against the same step on the CPU, from
     the same weights and batch (97x97, B=2, T=3, no stochastic depth):
     loss and grad_norm within 1e-4 relative, every gradient within 1e-3
     of its leaf's largest entry (plus 1e-6 of the model's largest), every
     updated parameter within a quarter of one LR unit (two units where
     the gradient is below that floor: Adam's first step is ~lr sign(g)).
 12. one JSON line with the kernels (launches summed over the serving
     paths, and the training path's for the backward), the card line, and
     last the result line {"ok": true, "device": {...}}.
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
                       # schedules' length; 15 steps stay in its warm-up
CMP_SIZE, CMP_BATCH, CMP_T = 97, 2, 3   # phase 11


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
    local_cases = [  # name, B, H, W, heads, d, dv, rel_v
        ("aott_st_b1", 1, 30, 30, 8, 32, 32, True),
        ("aott_st_b2", 2, 30, 30, 8, 32, 32, True),
        ("deaot_st_dv512", 1, 30, 30, 1, 128, 512, False),
        ("deaot_st", 1, 30, 30, 1, 128, 1024, False),
        ("aott_ragged_46x80", 1, 46, 80, 8, 32, 32, True),
    ]
    worst_local = 0.0
    for name, b, hgt, wid, h, d, dv, rv in local_cases:
        args = local_inputs(rng, b, hgt, wid, h, d, dv, rv, 7, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        got = lwa.local_window_attention_cuda(*args, **kw)
        want = lwa.local_window_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"phase 2: local_window_attn {name} B={b} {hgt}x{wid} h={h} "
              f"d={d} dv={dv} rel_v={rv}: max_abs_err {err:.3e}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
        worst_local = max(worst_local, err)

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
    return {"local_window_attn": worst_local, "flash_attn_fwd": worst_flash}


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


def time_pair(kernel, plain):
    """Median ms of kernel and plain, run in turns."""
    samples = {"plain": [], "kernel": []}
    fns = {"plain": plain, "kernel": kernel}
    for which in ("plain", "kernel", "kernel", "plain"):
        samples[which] += cuda_times_ms(fns[which])
    return (float(np.median(samples["kernel"])),
            float(np.median(samples["plain"])))


def time_kernels(lwa, fa, device, card: str):
    """Phase 3. Returns {name: (kernel ms, plain ms)} at the shapes the JSON
    line reports: AOTT's ST shape and DeAOTL's longest LT read."""
    rng = np.random.RandomState(SEED + 1)
    times = {}
    for label, h, d, dv, rv in (("AOTT", 8, 32, 32, True),
                                ("DeAOT", 1, 128, 1024, False)):
        args = local_inputs(rng, 1, 30, 30, h, d, dv, rv, 7, device)
        kw = dict(num_heads=h, size_2d=(30, 30), max_dis=7, d_att=d)
        ms, plain_ms = time_pair(
            lambda: lwa.local_window_attention_cuda(*args, **kw),
            lambda: lwa.local_window_attention_plain(*args, **kw))
        print(f"phase 3: local_window_attn {label} ST shape 30x30 h={h} d={d} "
              f"dv={dv} B=1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({card})", flush=True)
        if label == "AOTT":
            times["local_window_attn"] = (ms, plain_ms)
    for lk in (9000, 19800):
        q, k, v, vl = flash_inputs(rng, 1, 900, lk, 1, 128, 1024, lk, device)
        ms, plain_ms = time_pair(
            lambda: fa.flash_attention_cuda(q, k, v, vl, 1, 128),
            lambda: fa.flash_attention_plain(q, k, v, vl, 1, 128))
        print(f"phase 3: flash_attn_fwd DeAOTL LT shape Lq=900 Lk={lk} h=1 "
              f"d=128 dv=1024: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"({card})", flush=True)
        times["flash_attn_fwd"] = (ms, plain_ms)
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


def grow_then_step(eng, shadow, state, frame, t, size):
    """One frame of the evaluator's loop (aot_tpu/eval/evaluator.py:
    233-256): grow the LT ring before a step that writes it, step, mirror
    the write schedule."""
    if shadow.will_write(t):
        state = eng.ensure_lt_capacity(state, shadow.count + 1)
    state, pred, logits = eng.step(state, frame, (size, size))
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

    for mod in kernels.values():
        mod.LAUNCHES = 0
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
                                             SIZE)
        sync()
        seconds.append(time.perf_counter() - t0)
        check_step_outputs(pred, logits, SIZE)   # outside the timed region
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
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
            eng, shadow, state, frame.to(state.obj_nums.device), t, SIZE)
        cpu_state, cpu_pred, cpu_logits = grow_then_step(
            cpu_eng, cpu_shadow, cpu_state, frame, t, SIZE)
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
            "flash_attn_fwd": sum(flash_steps) * layers}
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
    """Phase 9. Returns (kernel ms, plain ms) at AOTT's training shape."""
    rng = np.random.RandomState(SEED + 3)
    result = None
    for label, b, lk, h, d, dv in (("AOTT training", 16, 900, 8, 32, 32),
                                   ("DeAOTL LT", 1, 19800, 1, 128, 1024)):
        q, k, v, vl = flash_inputs(rng, b, 900, lk, h, d, dv, None, device)
        out, lse = fa.flash_attention_cuda(q, k, v, vl, h, d)
        dout = torch.tensor(rng.randn(b, 900, h * dv), dtype=torch.float32,
                            device=device)
        args = (q, k, v, vl, out, lse, dout, h, d)
        ms, plain_ms = time_pair(lambda: fab.flash_attention_bwd_cuda(*args),
                                 lambda: fab.flash_attention_bwd_plain(*args))
        print(f"phase 9: flash_attn_bwd {label} shape B={b} Lq=900 Lk={lk} "
              f"h={h} d={d} dv={dv}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})", flush=True)
        result = result or (ms, plain_ms)
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
    for mod in kernels.values():
        mod.LAUNCHES = 0
    start = time.perf_counter()
    trainer.sequential_training(TRAIN_STEPS, dataset=data, on_step=on_step)
    launches = {name: mod.LAUNCHES for name, mod in kernels.items()}
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
                "local_window_attn": 0}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa

    kernels = {"local_window_attn": lwa, "flash_attn_fwd": fa,
               "flash_attn_bwd": fab}
    serving = {"local_window_attn": lwa, "flash_attn_fwd": fa}

    # phase 0
    card = card_line()
    print(card, flush=True)
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # phase 1
    t0 = time.perf_counter()
    sos = _build.build(*kernels)
    for mod in kernels.values():
        mod._lib()
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

    # phases 4-7
    video, mask = synthetic_video(SEED, STEPS + 1 + CPU_STEPS, SIZE, OBJECTS)
    paths = [("AOTT", build_config(stage="pre_ytb_dav", model="aott",
                                   TEST_LONG_TERM_MEM_CAP=8)),
             ("DeAOTL", build_config(stage="pre_ytb_dav", model="deaotl"))]
    total = {name: 0 for name in kernels}
    for i, (name, cfg) in enumerate(paths):
        launches = drive(name, cfg, device, video, mask, serving, card,
                         4 + 2 * i)
        for k in serving:
            total[k] += launches[k]
        if name == "AOTT" and launches["flash_attn_fwd"] != 0:
            raise AssertionError("AOTT reached the flash kernel")
        if name == "DeAOTL" and launches["flash_attn_fwd"] == 0:
            raise AssertionError("DeAOTL never reached the flash kernel")

    # phases 10, 11
    for k, n in run_training(kernels, device, card).items():
        total[k] += n
    compare_train_step(device)

    for mod in ("jax", "flax"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    replaces = {"local_window_attn": "aot_tpu/ops/pallas/local_window_attn.py:414",
                "flash_attn_fwd": "aot_tpu/ops/pallas/flash_attn_vjp.py:51",
                "flash_attn_bwd": "aot_tpu/ops/pallas/flash_attn_vjp.py:267"}
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"aot_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": total[name],
        "max_abs_err": max_err[name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
    } for name in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
