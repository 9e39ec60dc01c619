#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (aot_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
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
  8. one JSON line with the kernels (launches summed over the two main
     paths), the card line, and last the result line
     {"ok": true, "device": {...}}.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.ops.kernels import _build
    from aot_tpu_torch.ops.kernels import flash_attn as fa
    from aot_tpu_torch.ops.kernels import local_window_attn as lwa

    kernels = {"local_window_attn": lwa, "flash_attn_fwd": fa}

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

    # phases 2, 3
    max_err = check_kernel_numerics(lwa, fa, device)
    times = time_kernels(lwa, fa, device, card)

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

    for mod in ("jax", "flax"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    replaces = {"local_window_attn": "aot_tpu/ops/pallas/local_window_attn.py:414",
                "flash_attn_fwd": "aot_tpu/ops/pallas/flash_attn_vjp.py:51"}
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
