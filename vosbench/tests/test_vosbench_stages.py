"""vosbench/stages.py: device operations placed under the program's spans.

On a synthetic trace (kernels, their `cuda_runtime` launches joined by
`args.correlation`, the program's spans and the harness's phases) a
kernel goes to the span that launched it, not to the one open when it
ran; one with no launch event goes by its start; the stages' own device
time and the time under no span add up to the busy time; nothing is read
where no span was recorded. Then the measurement rehearsed on the CPU at
a tiny size."""

import time

import pytest

from aot_tpu_torch.utils import tracing
from vosbench import harness, stages
from vosbench.tests.test_vosbench_harness import BENCH, SEED, tiny
from vosbench.trace import Trace

BASE_US = 1_000_000.0        # the trace's origin on the wall clock


def rec(name, start_us, end_us, parent):
    return tracing.SpanRecord(name, int((BASE_US + start_us) * 1e3),
                              int((BASE_US + end_us) * 1e3), parent, 1, 1)


def kernel(name, start, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
            "args": {"correlation": corr}}


def launch(at, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": at, "dur": 1.0, "args": {"correlation": corr}}


# one frame: the host runs infer.step over 0..100 us with encode (5..30),
# lstt (30..70) holding lt_read (40..60), then decode (70..90); the device
# runs behind it
SPANS = [rec("infer.step", 0, 100, -1), rec("encode", 5, 30, 0),
         rec("lstt", 30, 70, 0), rec("lt_read", 40, 60, 2),
         rec("decode", 70, 90, 0)]
PHASES = [("upload", BASE_US - 10, BASE_US - 1),
          ("step", BASE_US - 1, BASE_US + 100),
          ("readback", BASE_US + 100, BASE_US + 200)]
WINDOW = (BASE_US - 10, BASE_US + 200)


def events():
    return [
        # launched in encode, run while the host is in lstt
        launch(10, 1), kernel("conv", 35, 10, 1),
        # launched in lt_read, run while the host is in decode
        launch(45, 2), kernel("flash", 72, 20, 2),
        # launched in decode, run after the step returned (readback)
        launch(80, 3), kernel("head", 110, 5, 3),
        # a copy launched in readback, outside every span
        launch(150, 4), kernel("copy", 151, 4, 4, cat="gpu_memcpy"),
        # a kernel that overlaps `flash`: counted once in the busy time
        launch(46, 5), kernel("cat", 80, 20, 5),
        # a host operation: not the device's
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12,
         "dur": 3, "args": {}},
    ]


def placed(evs, spans=SPANS, frames=1):
    return stages.Stages(Trace(evs, BASE_US, WINDOW, PHASES), spans, frames)


def test_kernels_go_to_the_span_that_launched_them():
    st = placed(events())
    assert (st.by_launch, st.by_start) == (5, 0)
    table = st.table()
    assert table["encode"]["launches"] == 1
    assert table["encode"]["device_ms"] == pytest.approx(10e-3)
    # flash (20 us) and the part of `cat` that flash does not cover (8 us)
    assert table["lt_read"]["device_ms"] == pytest.approx(28e-3)
    assert table["lt_read"]["launches"] == 2
    # lstt holds its child; infer.step holds everything the step launched
    assert table["lstt"]["device_ms"] == pytest.approx(28e-3)
    assert table["lstt"]["self_device_ms"] == 0
    assert table["decode"]["device_ms"] == pytest.approx(5e-3)
    assert table["infer.step"]["launches"] == 4
    assert table["infer.step"]["device_ms"] == pytest.approx(43e-3)
    assert table["infer.step"]["self_device_ms"] == 0
    # host self time: duration less children
    assert table["infer.step"]["host_self_ms"] == pytest.approx(
        (100 - 25 - 40 - 20) * 1e-3)
    assert table["lstt"]["host_self_ms"] == pytest.approx(20e-3)
    assert st.outside_spans() == {"readback": pytest.approx(4e-6)}
    assert st.kernel_share() == 1.0
    assert "update_memory" not in table


def test_operations_by_span():
    st = placed(events())
    ops = st.ops_by_span()
    assert ops["lt_read"] == [["flash", pytest.approx(20e-3), 1],
                              ["cat", pytest.approx(8e-3), 1]]
    assert ops["phase:readback"] == [["copy", pytest.approx(4e-3), 1]]
    assert set(ops) == {"encode", "lt_read", "decode", "phase:readback"}


def test_device_time_adds_up_to_busy():
    st = placed(events(), frames=2)
    table = st.table()
    own = sum(r["self_device_ms"] for r in table.values()) * 2 / 1e3
    outside = sum(st.outside_spans().values())
    assert own + outside == pytest.approx(st.trace.busy_s)
    # and the idle time splits between the spans and the phases
    idle = sum(st.idle_by_span().values())
    assert idle == pytest.approx(st.trace.window_s - st.trace.busy_s)


def test_idle_gaps_by_innermost_span_or_phase():
    """A gap goes whole to what the host was in when it began."""
    st = placed(events())
    idle = st.idle_by_span()
    # -10..35 us in upload, 45..72 in lt_read, and 100..110, 115..151 and
    # 155..200 in readback
    assert idle == {"phase:upload": pytest.approx(45e-6),
                    "lt_read": pytest.approx(27e-6),
                    "phase:readback": pytest.approx(91e-6)}
    table = st.table()
    assert table["lt_read"]["idle_ms"] == pytest.approx(27e-3)
    assert table["encode"]["idle_ms"] == 0


def test_without_launch_events_kernels_go_by_their_start():
    evs = [e for e in events() if e["cat"] != "cuda_runtime"]
    st = placed(evs)
    assert (st.by_launch, st.by_start) == (0, 5)
    table = st.table()
    # conv ran while the host was in lstt, flash in decode
    assert "encode" not in table or table["encode"]["launches"] == 0
    assert table["lstt"]["launches"] == 1
    assert table["decode"]["launches"] == 2
    assert st.outside_spans()["readback"] == pytest.approx(9e-6)


def test_self_time_is_less_children():
    own = stages.self_ns(SPANS)
    assert [o / 1e3 for o in own] == pytest.approx([15, 25, 20, 20, 20])


def test_nothing_read_without_spans():
    st = placed(events(), spans=[])
    assert st.table() is None
    assert st.kernel_share() < 1.0


def test_measure_rehearsed_on_the_cpu():
    """The whole measurement at the tiny size: the CPU launches nothing,
    so the stages hold host time only; the counters of the traced frames
    count the plain routes."""
    cell = tiny(harness.load_cell(BENCH, "aott.davis480"))
    prev = tracing.spans_on()
    out = stages.measure(cell, SEED, "cpu", cost_frames=20)
    assert tracing.spans_on() == prev
    assert tracing.take_spans() == []
    assert out["frames"] == 3 and out["launches_per_frame"] == 0
    want = {"infer.step", "encode", "lstt", "lstt.block0", "lt_read",
            "st_read", "decode", "upsample_argmax", "update_memory"}
    assert want <= set(out["stages"])
    assert all(r["host_self_ms"] >= 0 for r in out["stages"].values())
    assert out["counters"]["attn.local.plain"] > 0
    assert out["counters"]["attn.global.dense"] > 0
    cost = out["cost"]
    assert cost["frames_each"][0] > 0 and cost["frames_each"][1] > 0
    assert cost["spans_a_frame"] >= len(want)
    assert cost["span_ns"]["off"] < cost["span_ns"]["on"]


def test_cli_refuses_without_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t0 = time.perf_counter()
    assert stages.main(["--workload", "aott.davis480", "--seed", "1"]) == 2
    assert time.perf_counter() - t0 < 30
