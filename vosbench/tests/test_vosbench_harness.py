"""The harness rehearsed on the CPU at tiny sizes: each cell end to end, the
reference against the port's plain path, the control and the planted
faults failing the check, the yardstick's counts, a cell and a
configuration with a new backbone added as files only, the program's spans
read, and the import rule."""

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from vosbench import check, control, harness, traffic, work

CHECKOUT = Path(__file__).resolve().parents[2]

BENCH = CHECKOUT / "BENCHMARK.json"
CELLS = ("aott.davis480", "r50_deaotl.longstream480", "aott.davis1080")
SEED = 2 ** 31 + 977          # wider than 32 signed bits


def tiny(cell: harness.Cell) -> harness.Cell:
    """The cell at 65 x 97 frames (a 5 x 7 grid), few and short videos, a
    4-frame fifo ring filled in set-up and the flash path's plain version
    from 64 keys on, so every layer the cell names is reached."""
    wl = cell.workload
    wl.update(frame_size=[65, 97], trace_frames=3)
    wl["check"]["keep_logits_every"] = 4
    if not wl.get("fill_steps"):
        wl.update(videos=[[6, 2], [4, 1], [5, 3]], warmup_video=[3, 2])
    else:
        wl.update(fill_steps=16)
        wl["engine"].update(TEST_LONG_TERM_MEM_CAP=4,
                            ATTN_FLASH_MIN_KEYS_FP32=64)
    return cell


def rehearse(name, trace=False, program=None, seconds=1.5, root=None,
             bench=BENCH):
    kw = {} if root is None else {"root": root}
    cell = tiny(harness.load_cell(bench, name, **kw))
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            time.perf_counter(), program=program)


def well_formed(res, cell_metrics):
    line = json.loads(json.dumps(res))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == set(cell_metrics)
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def cell_metrics(name, trace):
    bench = json.loads(BENCH.read_text())
    kind = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[kind]
            if name in m.get("workloads", [name])]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal(name, trace):
    res = rehearse(name, trace)
    # the CPU runs no kernel: the rooflines find nothing and stay out
    want = [m for m in cell_metrics(name, trace)
            if not (trace and m.startswith("kernels."))]
    well_formed(res, want)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps", "stages",
                                         "idle_by_span", "counters"}


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_port_plain_path(name):
    """The reference against the port's plain path on the same frames and
    weights: fp32 on both sides, only the order of sums differs."""
    res = rehearse(name)
    assert res["checks"]["logit_err"]["value"] < 1e-5
    assert res["checks"]["mask_gap"]["value"] < 1e-5
    assert res["checks"]["logit_frames_compared"]["value"] >= 2


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in the program's place at TF32 (weights rounded to
    TF32's mantissa: the CPU has no TF32) is not correct."""
    res = rehearse(name, program=control.reference_program(emulate=True))
    assert not res["correct"], res["checks"]


def _state_unchanged(monkeypatch):
    from aot_tpu_torch.engine.engine import VOSEngine

    monkeypatch.setattr(VOSEngine, "update_memory",
                        lambda self, state, *a, **k: state)


def _answer_altered(monkeypatch):
    from aot_tpu_torch.engine import infer

    real = infer.upsample_argmax

    def altered(logits, size, align_corners=True):
        pred = real(logits, size, align_corners).clone()
        pred[..., :8, :8] = (pred[..., :8, :8] + 1) % 2
        return pred

    monkeypatch.setattr(infer, "upsample_argmax", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch):
    """The timed path broken underneath: a step that leaves the memory
    unchanged, or a mask altered where it is produced."""
    fault(monkeypatch)
    res = rehearse(name)
    assert not res["correct"], res["checks"]


def test_checked_videos_drawn_from_first_pass():
    """The checked videos are drawn before the window from the stream's
    first pass, the longest always among them, and the stream then plays
    that pass unchanged."""
    cell = tiny(harness.load_cell(BENCH, "aott.davis480"))
    tr = traffic.Traffic(cell.workload, SEED, "cpu")
    tr.warmup()
    first, stream = tr.first_pass(tr.videos())
    assert [next(stream) for _ in first] == first
    assert len({v.frames for v in first}) == len(cell.workload["videos"])
    picked = check.sample_videos(first, SEED, 2)
    assert picked[0] == max(first, key=lambda v: v.frames).index
    assert len(set(picked)) == 2
    assert check.sample_videos(first, SEED, 2) == picked


def test_local_work_hand_count():
    # a 3 x 4 grid, radius 7: every query sees the whole 12-token image
    assert work.window_slots(3, 4) == 144.0
    # radius 1 on 3 x 4: rows 2+3+2, cols 2+3+3+2 in-image offsets
    assert work.window_slots(3, 4, max_dis=1) == 7 * 10
    flops, nbytes = work.local_work(1, 3, 4, 8, 32, 32, with_rv=True)
    assert flops == 8 * 144 * (2 * 32 + 4 * 32)
    assert nbytes == 4 * 12 * 8 * 128 + 4 * (8 * 12 * 225 + 8 * 32 * 225)


def test_lt_read_hand_count():
    # DeAOT's LT read at cell 2's size: 1,674 queries over 64 frames
    flops, nbytes = work.global_work(1674, 64 * 1674, 1, 128, 1024)
    assert flops == 2 * 1674 * 107136 * 1152
    assert nbytes == 4 * (1674 * 1152 + 107136 * 1152) + 4 * 1674
    assert math.isclose(work.bound_s(flops, nbytes), flops / (495e12 / 3))


def test_frame_work_reads():
    cell = harness.load_cell(BENCH, "r50_deaotl.longstream480")
    layout = tuple(harness.weight_layout(cell).items())
    key = work.model_key(cell.config)
    flops, reads = work.frame_work(key, layout, (481, 849), "step", 64,
                                   cell.root)
    lt = [r for r in reads if r[1] == "lt"]
    assert [r[4] for r in lt] == [64 * 1674] * 3
    assert len([r for r in reads if r[1] == "st"]) == 3
    assert flops > 3 * work.global_work(1674, 64 * 1674, 1, 128, 1024)[0]


def test_workload_added_as_files(tmp_path):
    """A new cell needs a workload file and its BENCHMARK.json entry only:
    the harness finds it by name and runs it."""
    root = tmp_path / "vosbench"
    shutil.copytree(CHECKOUT / "vosbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((root / "workloads" / "aott.davis480.json").read_text())
    wl.update(traffic="short3", videos=[[5, 3]])
    (root / "workloads" / "aott.short3.json").write_text(json.dumps(wl))
    bench = json.loads(BENCH.read_text())
    bench["workloads"].append({"name": "aott.short3", "config": "aott",
                               "traffic": "short3", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = rehearse("aott.short3", root=root, bench=tmp_path / "BENCHMARK.json")
    assert res["correct"] and res["attempted"] > 0


def test_forbidden_modules():
    names = ["aot_tpu", "aot_tpu.ops", "jax", "jaxlib.xla_client",
             "flax.linen", "aot_tpu_torch", "aot_tpu_torch.ops", "jaxtyping",
             "numpy"]
    assert harness.forbidden_modules(names) == [
        "aot_tpu", "aot_tpu.ops", "flax.linen", "jax", "jaxlib.xla_client"]


def test_rehearsal_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(CHECKOUT)!r})\n"
            "import torch; torch.set_num_threads(2)\n"
            "from vosbench.tests import test_vosbench_harness as t\n"
            "from vosbench import harness\n"
            "assert t.rehearse('aott.davis480')['correct']\n"
            "print(harness.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "vosbench/run.py", "--workload", "aott.davis480",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name,frame,edge", [
    ("aott.davis480", (480, 854), 480 * 1.3),
    ("r50_deaotl.longstream480", (480, 854), 480 * 1.3),
    ("aott.davis1080", (1080, 1920), 1080)])
def test_snapped_size_is_the_evaluators(name, frame, edge):
    """The workload files' frame_size is the size at which the eval CLI
    hands a DAVIS frame to the engine: 480 x 854 frames at its default
    --max_resolution, and 1080 x 1920 frames at --max_resolution 1080 with
    TEST_DATASET_FULL_RESOLUTION=True (the full-resolution frames)."""
    import numpy as np

    from aot_tpu_torch.data.video_aug import multi_restrict_size

    v = multi_restrict_size(np.zeros(frame + (3,), np.uint8), None,
                            multi_scale=[1.0], flip=False,
                            max_short_edge=edge,
                            max_long_edge=edge * 800 / 480,
                            align_corners=True)
    wl = json.loads((CHECKOUT / "vosbench" / "workloads" /
                     f"{name}.json").read_text())
    assert tuple(v[0]["image"].shape[:2]) == tuple(wl["frame_size"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(name, card):
    """The control at the cell's own size on the card: not correct."""
    cell = harness.load_cell(BENCH, name)
    res = harness.run_cell(cell, SEED, 5.0, False, card, time.perf_counter(),
                           program=control.reference_program())
    assert not res["correct"], res["checks"]
