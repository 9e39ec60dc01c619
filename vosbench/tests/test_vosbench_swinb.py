"""The `swinb_deaotl.davis480` cell on the CPU at a tiny frame size: the
harness runs it end to end through the program's plain paths and checks it
correct, the control and the planted faults fail, the traced run reads the
cell's per-layer metrics (the window kernel's roofline from a stand-in
trace), and the yardstick counts Swin-B's window reads by hand at 480x848.
"""

import json
import math
import time

import numpy as np
import pytest

from vosbench import control, harness, work
from vosbench.tests.test_vosbench_harness import (BENCH, CHECKOUT, SEED,
                                                  _answer_altered,
                                                  _state_unchanged,
                                                  cell_metrics, well_formed)
from vosbench.trace import Trace

CELL = "swinb_deaotl.davis480"


def tiny(cell: harness.Cell) -> harness.Cell:
    """The cell at 80 x 112 frames (16k sizes, as the cell's own: Swin-B's
    stage maps 20x28, 10x14 and 5x7, the window grid padded at every
    stage, the last one smaller than a window), few and short videos, the
    flash path's plain version from 64 keys on so that the LT read crosses
    the dense-to-flash switch inside the 12-frame video."""
    wl = cell.workload
    wl.update(frame_size=[80, 112], trace_frames=3,
              videos=[[6, 2], [4, 1], [12, 3]], warmup_video=[3, 2])
    wl["check"]["keep_logits_every"] = 4
    wl["engine"].update(ATTN_FLASH_MIN_KEYS_FP32=64)
    return cell


def rehearse(trace=False, program=None, seconds=1.5):
    cell = tiny(harness.load_cell(BENCH, CELL))
    return harness.run_cell(cell, SEED, seconds, trace, "cpu",
                            time.perf_counter(), program=program)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsal(trace, monkeypatch):
    """The cell end to end: correct, every frame served, the metrics the
    cell names (in the traced run the window kernel's roofline too, from a
    trace that gives the named kernels a millisecond: the CPU runs none),
    and the counters of the Swin blocks' plain route."""
    if trace:
        monkeypatch.setattr(Trace, "matched_seconds",
                            lambda self, patterns: 1e-3)
    res = rehearse(trace)
    well_formed(res, cell_metrics(CELL, trace))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["logit_err"]["value"] < 1e-5
    if trace:
        got = res["metrics"]["kernels.swin_window_roofline"]["value"]
        assert 0 < got and math.isfinite(got)
        assert res["metrics"]["model.window_attn_device_ms"]["value"] == 0
        counters = dict(res["breakdown"]["counters"])
        assert counters["attn.window.plain"] == 22
        # 20x28, 10x14 and 5x7 tokens: 3x4, 2x2 and 1x1 windows of 7x7
        assert counters["attn.window.plain.windows"] == (
            2 * 12 * 4 + 2 * 4 * 8 + 18 * 1 * 16)


def test_control_fails():
    res = rehearse(program=control.reference_program(emulate=True))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered])
def test_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    res = rehearse()
    assert not res["correct"], res["checks"]


def test_window_reads_hand_count():
    """work.frame_work records Swin-B's 22 window reads a frame at 480x848
    (stages of 120x212, 60x106 and 30x53 tokens, 4, 8 and 16 heads of 32
    channels, 2, 2 and 18 blocks, every second one shifted) and counts each
    by hand: 4 * 49 * 32 FLOPs a head and in-image query; the in-image
    tokens' q, k, v and out (16 bytes a channel) and the 169 x heads
    table."""
    cell = harness.load_cell(BENCH, CELL)
    layout = tuple(harness.weight_layout(cell).items())
    _, reads = work.frame_work(work.model_key(cell.config), layout,
                               (480, 848), "step", 6, cell.root)
    win = [r for r in reads if r[1] == "enc_window"]
    stages = [(120, 212, 4)] * 2 + [(60, 106, 8)] * 2 + [(30, 53, 16)] * 18
    assert len(win) == 22
    bound = 0.0
    for i, (r, (hgt, wid, heads)) in enumerate(zip(win, stages)):
        name, _, shapes, fn = r
        windows = math.ceil(hgt / 7) * math.ceil(wid / 7)
        assert name == "swin_window"
        assert shapes[0] == (windows, heads, 49, 32)
        assert (shapes[4] is None) == (i % 2 == 0)     # the shift mask
        flops, nbytes = fn(*shapes)
        assert flops == 4 * 49 * 32 * heads * hgt * wid
        assert nbytes == 16 * hgt * wid * heads * 32 + 4 * 169 * heads
        bound += work.bound_s(flops, nbytes)
    assert math.isclose(work.op_bound_s(reads, "enc_window"), bound)
    fn = harness.load_work(cell.root, cell.ops["swin_window"]["work"])
    assert math.isclose(fn(reads), bound)
    # bytes bound every read: ~117 us a frame at 3.35 TB/s
    assert math.isclose(bound, (2 * 52103824 + 2 * 26055968 + 18 * 13036096)
                        / work.PEAK_BYTES_PER_S)


def test_snapped_size_is_the_evaluators():
    """480 x 854 DAVIS frames at the eval CLI's default --max_resolution,
    snapped for MODEL_ALIGN_CORNERS=False (16k sizes): 480 x 848."""
    from aot_tpu_torch.data.video_aug import multi_restrict_size

    v = multi_restrict_size(np.zeros((480, 854, 3), np.uint8), None,
                            multi_scale=[1.0], flip=False,
                            max_short_edge=480 * 1.3,
                            max_long_edge=480 * 1.3 * 800 / 480,
                            align_corners=False)
    wl = json.loads((CHECKOUT / "vosbench" / "workloads" /
                     f"{CELL}.json").read_text())
    assert tuple(v[0]["image"].shape[:2]) == tuple(wl["frame_size"])
    cell = harness.load_cell(BENCH, CELL)
    assert cell.config["MODEL_ALIGN_CORNERS"] is False


@pytest.mark.card
def test_control_fails_on_card(card):
    """The control at the cell's own size on the card: not correct."""
    cell = harness.load_cell(BENCH, CELL)
    res = harness.run_cell(cell, SEED, 5.0, False, card, time.perf_counter(),
                           program=control.reference_program())
    assert not res["correct"], res["checks"]
