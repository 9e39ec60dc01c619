#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (aot_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  0. refuse to run without a card; print the card's name and power limit
     (nvidia-smi) and the torch/CUDA versions; TF32 off for matmuls and
     convolutions.
  1. build the CUDA kernels from aot_tpu_torch/csrc/ (nvcc, sm_90a).
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it (max abs error <= 1e-4).
  3. kernel and plain times at the AOTT short-term shape (CUDA events,
     median of 2 x 50 runs, in the order plain, kernel, kernel, plain).
  4. the main path: AOTT at 465x465 with 10 objects and seeded random
     weights — VOSInferEngine.add_reference_frame, then STEPS frames of
     VOSInferEngine.step on a seeded synthetic video; output checks, the
     kernel launch count of the run, and the median time per frame.
  5. the port on the card against the port on the CPU, from the same state
     for 3 frames: grid logits within 1e-3, masks agree on >= 99.9%.
  6. one JSON line with the kernels, the card line, and last the result
     line {"ok": true, "device": {...}}.
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
STEPS = 105         # steps of the main-path run, warm-up included
CPU_STEPS = 3
KERNEL_TOL = 1e-4   # fp32, only the summation order differs
LOGIT_TOL = 1e-3    # ~20 conv layers: cuDNN vs oneDNN summation order
MASK_AGREE = 0.999  # argmax near-ties may flip a few pixels


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


def kernel_inputs(rng, b, hgt, wid, h, d, dv, with_rv, max_dis, device):
    hw, win2 = hgt * wid, (2 * max_dis + 1) ** 2
    arr = [rng.randn(b, hw, h * d), rng.randn(b, hw, h * d),
           rng.randn(b, hw, h * dv), 0.3 * rng.randn(b, h, hw, win2),
           0.3 * rng.randn(h, dv, win2) if with_rv else None]
    return [None if a is None else
            torch.tensor(a, dtype=torch.float32, device=device) for a in arr]


def check_kernel_numerics(lwa, device) -> float:
    """Phase 2: kernel vs plain on the card. Returns the max error."""
    rng = np.random.RandomState(SEED)
    cases = [  # name, B, H, W, heads, d, dv, rel_v
        ("aott_st_b1", 1, 30, 30, 8, 32, 32, True),
        ("aott_st_b2", 2, 30, 30, 8, 32, 32, True),
        ("deaot_st", 1, 30, 30, 1, 128, 512, False),
        ("aott_ragged_46x80", 1, 46, 80, 8, 32, 32, True),
    ]
    worst = 0.0
    for name, b, hgt, wid, h, d, dv, rv in cases:
        args = kernel_inputs(rng, b, hgt, wid, h, d, dv, rv, 7, device)
        kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=7, d_att=d)
        got = lwa.local_window_attention_cuda(*args, **kw)
        want = lwa.local_window_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"phase 2: local_window_attn {name} B={b} {hgt}x{wid} h={h} "
              f"d={d} dv={dv} rel_v={rv}: max_abs_err {err:.3e}", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
        worst = max(worst, err)
    return worst


def cuda_median_ms(fn, runs: int = 50, warmup: int = 10):
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


def time_kernel(lwa, device):
    """Phase 3: kernel and plain at the AOTT ST shape, B=1, in turns."""
    args = kernel_inputs(np.random.RandomState(SEED + 1), 1, 30, 30, 8, 32,
                         32, True, 7, device)
    kw = dict(num_heads=8, size_2d=(30, 30), max_dis=7, d_att=32)
    samples = {"plain": [], "kernel": []}
    fns = {"plain": lambda: lwa.local_window_attention_plain(*args, **kw),
           "kernel": lambda: lwa.local_window_attention_cuda(*args, **kw)}
    for which in ("plain", "kernel", "kernel", "plain"):
        samples[which] += cuda_median_ms(fns[which])
    return (float(np.median(samples["kernel"])),
            float(np.median(samples["plain"])))


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


def run_main_path(cfg, device, size: int, steps: int, lwa):
    """Phase 4. Returns (model, engine, state, video, per-step seconds,
    kernel launches of the run)."""
    from aot_tpu_torch.engine import build_infer_engine
    from aot_tpu_torch.models import build_vos_model

    model = build_vos_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(SEED))
    eng = build_infer_engine(model, cfg)
    video, mask = synthetic_video(SEED, steps + 1 + CPU_STEPS, size, OBJECTS)
    frames = torch.from_numpy(video).to(device)      # set-up: one upload
    ref_mask = torch.from_numpy(mask).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()

    lwa.LAUNCHES = 0
    state = eng.add_reference_frame(frames[0], ref_mask, OBJECTS)
    seconds = []
    for t in range(1, steps + 1):
        t0 = time.perf_counter()
        state, pred, logits = eng.step(state, frames[t], (size, size))
        sync()
        seconds.append(time.perf_counter() - t0)
        check_step_outputs(pred, logits, size)   # outside the timed region
    return model, eng, state, video, seconds, lwa.LAUNCHES


def compare_with_cpu(cfg, model, eng, state, video, size: int):
    """Phase 5: the same steps from the same state on the card and on the
    CPU (plain path). Returns (max logit error, min mask agreement)."""
    from aot_tpu_torch.engine import build_infer_engine

    cpu_eng = build_infer_engine(copy.deepcopy(model).to("cpu"), cfg)
    cpu_state = state.to("cpu")
    worst_err, worst_agree = 0.0, 1.0
    for t in range(len(video) - CPU_STEPS, len(video)):
        frame = torch.from_numpy(video[t])
        state, pred, logits = eng.step(state, frame.to(state.obj_nums.device),
                                       (size, size))
        cpu_state, cpu_pred, cpu_logits = cpu_eng.step(cpu_state, frame,
                                                       (size, size))
        err = (logits.cpu() - cpu_logits).abs().max().item()
        agree = (pred.cpu() == cpu_pred).float().mean().item()
        print(f"phase 5: frame {t}: card vs CPU logits max_abs_err "
              f"{err:.3e}, mask agreement {agree:.6f}", flush=True)
        worst_err, worst_agree = max(worst_err, err), min(worst_agree, agree)
    if not (worst_err <= LOGIT_TOL and worst_agree >= MASK_AGREE):
        raise AssertionError(
            f"card vs CPU: logits {worst_err} (limit {LOGIT_TOL}), masks "
            f"{worst_agree} (limit {MASK_AGREE})")
    return worst_err, worst_agree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa

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
    so = _build.build("local_window_attn")
    lwa._lib()
    print(f"phase 1: built {os.path.relpath(so)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.BUILD_LOGS.get("local_window_attn", "").splitlines():
        print(f"  nvcc: {line}", flush=True)

    # phase 2, 3
    max_err = check_kernel_numerics(lwa, device)
    ms, plain_ms = time_kernel(lwa, device)
    print(f"phase 3: local_window_attn at 30x30 h=8 d=dv=32 B=1: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({card})", flush=True)

    # phase 4
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TEST_LONG_TERM_MEM_CAP=8)
    torch.cuda.reset_peak_memory_stats()
    model, eng, state, video, seconds, launches = run_main_path(
        cfg, device, SIZE, STEPS, lwa)
    want = (STEPS + 1) * cfg.MODEL_LSTT_NUM
    print(f"phase 4: local_window_attn launches in the main path: {launches} "
          f"(expected {want})", flush=True)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    timed = np.asarray(seconds[WARMUP:]) * 1e3
    frame_ms = float(np.median(timed))
    print(f"phase 4: AOTT {SIZE}x{SIZE}, {OBJECTS} objects, fp32, "
          f"{len(timed)} steps after {WARMUP} warm-up: median "
          f"{frame_ms:.3f} ms/frame ({1e3 / frame_ms:.2f} FPS), p90 "
          f"{np.percentile(timed, 90):.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB ({card})",
          flush=True)

    # phase 5
    compare_with_cpu(cfg, model, eng, state, video, SIZE)

    for mod in ("jax", "flax"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "local_window_attn",
        "route": "cuda",
        "source": "aot_tpu_torch/csrc/local_window_attn.cu",
        "replaces": "aot_tpu/ops/pallas/local_window_attn.py:414",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
