"""What a later configuration or metric adds as files only, and what the
harness reads of the program's own spans: a configuration whose encoder
the shipped reference lacks (its encoder file, an op with its own work
function, a reader), an encoder's own attention read counted by its
declaration, the yardstick's counts unchanged for the shipped
configurations, and the span readers and `breakdown` keys of a traced
rehearsal, with and without the program's tracing module."""

import hashlib
import json
import math
import shutil
import sys
from pathlib import Path

import pytest

from vosbench import check, harness, reference, work
from vosbench.tests.test_vosbench_harness import (BENCH, CELLS, CHECKOUT,
                                                  rehearse, tiny)
from vosbench.trace import Trace
from vosbench.traffic import Video

SPAN_METRICS = ("model.encode_launches_per_frame", "model.encode_device_ms",
                "model.lstt_device_ms", "model.lt_read_device_ms",
                "infer.update_memory_device_ms")

# work.frame_work of the shipped configurations, as the harness before
# reference encoders became files counted them: (config, size, kind, live
# frames) -> (flops, reads)
AOTT_READS = {
    (65, 97): [("global", "self", 1, 35, 35, 8, 32, 32),
               ("global", "lt", 1, 35, 35, 8, 32, 32),
               ("local", "st", 1, (5, 7), 8, 32, 32, True)],
    (481, 849): [("global", "self", 1, 1674, 1674, 8, 32, 32),
                 ("global", "lt", 1, 1674, 1674, 8, 32, 32),
                 ("local", "st", 1, (31, 54), 8, 32, 32, True)],
}


def r50_reads(tokens, size_2d, live):
    return [("global", "lt", 1, tokens, live * tokens, 1, 128, 1024),
            ("local", "st", 1, size_2d, 1, 128, 1024, False),
            ("global", "self", 1, tokens, tokens, 1, 128, 1024)] * 3


FRAME_WORK = {
    ("aott", (65, 97), "ref", 1): (406625280.0, AOTT_READS[65, 97]),
    ("aott", (65, 97), "step", 1): (597325056.0, AOTT_READS[65, 97]),
    ("aott", (481, 849), "ref", 1): (25847792960.0, AOTT_READS[481, 849]),
    ("aott", (481, 849), "step", 1): (37187948608.0, AOTT_READS[481, 849]),
    ("r50_deaotl", (65, 97), "ref", 1):
        (1838366592.0, r50_reads(35, (5, 7), 1)),
    ("r50_deaotl", (65, 97), "step", 4):
        (2083805568.0, r50_reads(35, (5, 7), 4)),
    ("r50_deaotl", (481, 849), "ref", 1):
        (133171233152.0, r50_reads(1674, (31, 54), 1)),
    ("r50_deaotl", (481, 849), "step", 64):
        (1366734719104.0, r50_reads(1674, (31, 54), 64)),
}
CONFIG_CELL = {"aott": "aott.davis480",
               "r50_deaotl": "r50_deaotl.longstream480"}


@pytest.mark.parametrize("key", sorted(FRAME_WORK), ids=str)
def test_frame_work_as_before(key):
    config, size, kind, live = key
    cell = harness.load_cell(BENCH, CONFIG_CELL[config])
    layout = tuple(harness.weight_layout(cell).items())
    flops, reads = work.frame_work(work.model_key(cell.config), layout, size,
                                   kind, live, cell.root)
    want_flops, want_reads = FRAME_WORK[key]
    assert flops == want_flops
    assert reads == want_reads


def test_checked_videos_within_frames():
    """A cell whose window serves less than a pass draws its checked
    videos from those that start within its first `within_frames`."""
    first = [Video(i, n, 1, 0) for i, n in enumerate([50, 60, 104, 40, 90])]
    assert check.sample_videos(first, 7, 2, within_frames=110) == [1, 0]
    assert check.sample_videos(first, 7, 3, within_frames=1000)[0] == 2
    assert check.sample_videos(first, 7, 1, within_frames=1) == [0]


def copy_bench(tmp_path) -> Path:
    root = tmp_path / "vosbench"
    shutil.copytree(CHECKOUT / "vosbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


RESNET101 = '''"""ResNet-101 at output stride 16: resnet50.py's bottleneck
stages, 23 blocks in the third."""

from .resnet50 import resnet

RESNET101_LAYERS = ((64, 3, 1), (128, 4, 2), (256, 23, 2))


def encode(P, x, ops):
    return resnet(P, x, RESNET101_LAYERS)
'''

ST_WORK = '''from vosbench import work


def st_least_s(reads):
    return work.op_bound_s(reads, "st")
'''


def test_configuration_added_as_files(tmp_path, monkeypatch):
    """R101_AOTL, whose encoder the shipped reference lacks, joins a copy
    of the benchmark as new files only: its configuration, its reference
    encoder, an op whose work function lies in a file of ops/, a reader of
    that op's roofline, and a cell. The harness runs it, checks it and
    reads the roofline, and no file the copy had changes."""
    with pytest.raises(ValueError, match="resnet101"):
        reference.load(harness.ROOT).model.encoder("resnet101")
    root = copy_bench(tmp_path)
    before = digests(root)
    config = json.loads((root / "configs" / "aott.json").read_text())
    config.update(
        name="r101_aotl", model="r101_aotl", MODEL_ENCODER="resnet101",
        MODEL_ENCODER_DIM=[256, 512, 1024, 1024], MODEL_LSTT_NUM=3,
        TEST_LONG_TERM_MEM_GAP=5,
        source="https://github.com/yoxu515/aot-benchmark/blob/main/"
               "configs/models/r101_aotl.py")
    (root / "configs" / "r101_aotl.json").write_text(json.dumps(config))
    (root / "reference" / "encoders" / "resnet101.py").write_text(RESNET101)
    (root / "ops" / "r101_st.py").write_text(ST_WORK)
    (root / "ops" / "st_read.fp32.json").write_text(json.dumps(
        {"op": "st_read", "work": "r101_st.py:st_least_s",
         "kernels": ["::local_attn_kernel"]}))
    (root / "metrics" / "kernels.st_read_roofline.py").write_text(
        "def read(run):\n    return run.op_roofline('st_read')\n")
    wl = json.loads((root / "workloads" / "aott.davis480.json").read_text())
    wl.update(traffic="short3", videos=[[6, 2]])
    (root / "workloads" / "r101_aotl.short3.json").write_text(json.dumps(wl))
    bench = json.loads(BENCH.read_text())
    bench["configs"].append({"name": "r101_aotl", "source": config["source"],
                             "file": "vosbench/configs/r101_aotl.json",
                             "reduced": [], "why": "a test configuration"})
    cell = "r101_aotl.short3"
    bench["workloads"].append({"name": cell, "config": "r101_aotl",
                               "traffic": "short3", "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        if m["name"] != "kernels.lt_read_roofline":
            m["workloads"] = m["workloads"] + [cell]
    bench["per_layer"].append({
        "name": "kernels.st_read_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels (ops/kernels/, csrc/)",
        "moves": "frames_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # the CPU runs no kernel: a trace that gives the named kernels a
    # millisecond makes both rooflines readable
    monkeypatch.setattr(Trace, "matched_seconds",
                        lambda self, patterns: 1e-3)
    res = rehearse(cell, trace=True, root=root,
                   bench=tmp_path / "BENCHMARK.json")
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_err"]["value"] < 1e-5
    got = res["metrics"]["kernels.st_read_roofline"]["value"]
    assert got > 0 and math.isfinite(got)
    assert got == res["metrics"]["kernels.local_window_roofline"]["value"]
    assert set(SPAN_METRICS) <= set(res["metrics"])
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


WINDOWED = '''"""MobileNetV2 with its stride-16 map read by windowed
self-attention, declared as a read of its own."""

from ..model import Read
from .mobilenetv2 import encode as mobilenetv2


def window_plain(q, k, v, win):
    b, n, c = q.shape
    qw = q.reshape(b * n // win, win, c)
    kw = k.reshape(b * n // win, win, c)
    vw = v.reshape(b * n // win, win, c)
    out = (qw @ kw.transpose(1, 2)).softmax(-1) @ vw
    return out.reshape(b, n, c)


def window_work(q, k, v, win):
    b, n, c = q
    return 4.0 * b * n * win * c, 4.0 * 4 * b * n * c


WINDOW = Read("window", "enc_window", window_plain, window_work)


def encode(P, x, ops):
    xs = mobilenetv2(P, x, ops)
    b, c, h, w = xs[-1].shape
    t = xs[-1].flatten(2).transpose(1, 2)
    t = ops.read(WINDOW, t, t, t, h * w)
    xs[-1] = t.transpose(1, 2).reshape(b, c, h, w)
    return xs
'''


def test_declared_read_counted_once(tmp_path):
    """An encoder's own read, declared with its plain version, role and
    work function: frame_work records it by name, role and shapes and
    counts its work once, by its own function, not by the plain version's
    operations."""
    root = copy_bench(tmp_path)
    (root / "reference" / "encoders" / "mobilenetv2_window.py").write_text(
        WINDOWED)
    cell = harness.load_cell(BENCH, "aott.davis480")
    layout = tuple(harness.weight_layout(cell).items())
    key = work.model_key(cell.config)
    windowed = tuple((k, "mobilenetv2_window" if k == "MODEL_ENCODER" else v)
                     for k, v in key)
    for kind, live in (("ref", 1), ("step", 2)):
        base, base_reads = work.frame_work(key, layout, (65, 97), kind, live,
                                           root)
        flops, reads = work.frame_work(windowed, layout, (65, 97), kind,
                                       live, root)
        declared = [r for r in reads if r[0] == "window"]
        assert len(declared) == 1
        name, role, shapes, fn = declared[0]
        assert (role, shapes) == ("enc_window", ((1, 35, 1280),) * 3 + (35,))
        assert flops == base + fn(*shapes)[0] == base + 4.0 * 35 * 35 * 1280
        assert [r for r in reads if r[0] != "window"] == base_reads
        assert work.op_bound_s(reads, "enc_window") == work.bound_s(
            *fn(*shapes))


@pytest.mark.parametrize("name", ["aott.davis480",
                                  "r50_deaotl.longstream480"])
def test_span_readers_and_breakdown(name):
    """A traced rehearsal reads the five span metrics from the stage table
    (the CPU launches no kernel: zero device time and launches) and gives
    the stages, the idle time by span and the counters in `breakdown`. The
    counters count what the yardstick mirrors: R50_DeAOTL's three LT reads
    a frame over every live key of its ring."""
    res = rehearse(name, trace=True)
    assert res["correct"], res["checks"]
    for m in SPAN_METRICS:
        assert res["metrics"][m]["value"] == 0
    bd = res["breakdown"]
    spans = {"infer.step", "encode", "lstt", "lt_read", "st_read", "decode",
             "upsample_argmax", "update_memory", "lt_write", "lstt.block0",
             "lstt.block1", "lstt.block2", "infer.add_reference_frame",
             "grow_lt"}
    stages = {n for n, _ in bd["stages"]}
    assert {"infer.step", "encode", "lstt"} <= stages <= spans
    assert all(len(e) == 2 for k in bd for e in bd[k])
    assert all(len(bd[k]) <= 10 for k in bd)
    counters = dict(bd["counters"])
    if name.startswith("r50"):
        cell = tiny(harness.load_cell(BENCH, name))
        wl = cell.workload
        tokens = math.prod((n - 1) // 16 + 1 for n in wl["frame_size"])
        live = work.live_frames_of(wl["engine"],
                                   wl["engine"]["TEST_LONG_TERM_MEM_CAP"])
        assert counters["attn.global.flash"] == 3
        assert counters["attn.global.flash.keys"] == live * tokens * 3
    else:
        assert counters["attn.global.dense"] == 2


@pytest.mark.parametrize("name", CELLS)
def test_without_program_tracing(name, monkeypatch):
    """A program without aot_tpu_torch.utils.tracing runs every cell as
    before: the harness's import of it finds nothing, the span readers
    return None and `breakdown` keeps its two lists. (The port's own
    modules import it, so the run itself is given the harness's answer.)"""
    import aot_tpu_torch.utils as utils

    with monkeypatch.context() as hidden:
        hidden.setitem(sys.modules, "aot_tpu_torch.utils.tracing", None)
        hidden.delattr(utils, "tracing", raising=False)
        assert harness.program_tracing() is None
    monkeypatch.setattr(harness, "program_tracing", lambda: None)
    res = rehearse(name, trace=True)
    assert res["correct"], res["checks"]
    assert not set(SPAN_METRICS) & set(res["metrics"])
    assert "infer.launches_per_frame" in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_work_function_names_a_file_of_ops(tmp_path):
    root = copy_bench(tmp_path)
    (root / "ops" / "mine.py").write_text(ST_WORK)
    fn = harness.load_work(root, "mine.py:st_least_s")
    assert fn([("local", "st", 1, (5, 7), 8, 32, 32, True)]) > 0
    assert harness.load_work(root, "lt_read") is work.lt_read
    with pytest.raises(SystemExit):
        harness.load_work(root, "../mine.py:st_least_s")
