"""The port's spans and counters (aot_tpu_torch/utils/tracing.py).

The recorder alone: nothing is recorded while spans are off, counters
count either way, and a region's counts can be kept apart and added back;
nesting, parent indices, frame ids and host self time;
one stack of open spans per thread; `take_spans` clears; the Chrome trace
events. Then a tiny AOTT and a tiny DeAOTL serving step on the CPU: the
span tree each frame makes, outputs bit-identical with spans on and off,
and the route and key counters against the live prefix of the LT ring."""

import threading

import numpy as np
import pytest
import torch

from aot_tpu_torch.configs import build_config
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.utils import tracing

SIZE = (65, 97)              # a 5 x 7 token grid
HW = 5 * 7


@pytest.fixture(autouse=True)
def clean_recorder():
    """Each test starts with spans off, no records and no counts, and
    leaves the process as it found it."""
    prev = tracing.enable_spans(False)
    tracing.take_spans()
    tracing.reset_counters()
    yield
    tracing.enable_spans(prev)
    tracing.take_spans()
    tracing.reset_counters()


def tree(spans, frame):
    """(name, parent's name) of each record of one frame."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans if s.frame == frame]


# --- the recorder ---------------------------------------------------------------


def test_spans_off_record_nothing_and_counters_still_count():
    assert not tracing.spans_on()
    with tracing.span("a"):
        with tracing.span("b"):
            tracing.count("x")
            tracing.count("x", 4)
            tracing.count("y", 0.5)
    assert tracing.take_spans() == []
    assert tracing.counters() == {"x": 5, "y": 0.5}
    snap = tracing.counters()
    tracing.count("x")
    assert snap["x"] == 5                       # a snapshot, not a view
    tracing.reset_counters()
    assert tracing.counters() == {}


def test_counted_apart_and_count_all():
    tracing.count("x")
    with tracing.counted_apart() as apart:
        tracing.count("x", 2)
        tracing.count("y")
    assert apart == {"x": 2, "y": 1}
    assert tracing.counters() == {"x": 1}
    tracing.count_all(apart)
    tracing.count_all(apart)
    assert tracing.counters() == {"x": 5, "y": 2}


def test_nesting_parents_frames_and_self_time():
    assert tracing.enable_spans(True) is False
    for _ in range(2):                          # two frames
        with tracing.span("root"):
            with tracing.span("a"):
                with tracing.span("a1"):
                    pass
            with tracing.span("b"):
                pass
    assert tracing.enable_spans(False) is True
    spans = tracing.take_spans()
    assert [s.name for s in spans] == ["root", "a", "a1", "b"] * 2
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1, 4, 5, 4]
    f0, f1 = spans[0].frame, spans[4].frame
    assert f1 == f0 + 1
    assert [s.frame for s in spans] == [f0] * 4 + [f1] * 4
    for s in spans:
        assert s.end_ns >= s.start_ns
        assert s.thread == threading.get_native_id()
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns

    # self time: the duration less what the children cover
    def rec(name, start, end, parent):
        return tracing.SpanRecord(name, start, end, parent, 1, 1)
    made = [rec("root", 0, 100, -1), rec("a", 10, 40, 0),
            rec("a1", 20, 25, 1), rec("b", 50, 90, 0)]
    assert tracing.self_ns(made) == [30, 25, 5, 40]


def test_each_thread_has_its_own_stack():
    tracing.enable_spans(True)
    seen = {}

    def worker():
        with tracing.span("other"):
            seen["thread"] = threading.get_native_id()

    with tracing.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.span("child"):
            pass
    got = tracing.take_spans()
    spans = {s.name: s for s in got}
    assert spans["other"].parent == -1          # a root on its own thread
    assert spans["other"].thread == seen["thread"]
    assert spans["other"].frame != spans["main"].frame
    assert got[spans["child"].parent].name == "main"
    assert spans["child"].frame == spans["main"].frame


def test_take_spans_clears():
    tracing.enable_spans(True)
    with tracing.span("a"):
        pass
    assert [s.name for s in tracing.take_spans()] == ["a"]
    assert tracing.take_spans() == []
    with tracing.span("b"):
        pass
    got = tracing.take_spans()
    assert [s.name for s in got] == ["b"] and got[0].parent == -1


def test_chrome_events_put_spans_on_their_own_track():
    tracing.enable_spans(True)
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    spans = tracing.take_spans()
    base = spans[0].start_ns - 1000
    events = tracing.chrome_events(spans, base)
    meta, outer, inner = events
    assert meta["ph"] == "M" and meta["args"]["name"] == "program spans"
    assert outer["name"] == "outer" and outer["ts"] == pytest.approx(1.0)
    assert inner["args"]["parent"] == 0
    for e in (outer, inner):
        assert e["ph"] == "X" and e["pid"] == meta["pid"]
        assert e["dur"] >= 0


# --- a serving step -------------------------------------------------------------


def serving(model_name, **over):
    cfg = build_config(stage="pre_ytb_dav", model=model_name, **over)
    model = build_vos_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3)).eval()
    return cfg, build_infer_engine(model, cfg)


def clip(frames, objects=2, seed=0):
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (frames, 1) + SIZE + (3,),
                                        dtype=np.uint8))
    mask = torch.zeros((1,) + SIZE, dtype=torch.long)
    for o in range(1, objects + 1):
        mask[0, 10 * o:10 * o + 20, 15 * o:15 * o + 30] = o
    return imgs, mask


def serve(eng, imgs, mask, objects=2):
    """The reference frame, then a step a frame as the evaluator drives it;
    returns each step's (pred, logits)."""
    state = eng.add_reference_frame(imgs[0], mask, objects)
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    outs = []
    for t in range(1, len(imgs)):
        if shadow.will_write(t):
            state = eng.ensure_lt_capacity(state, shadow.count + 1)
        state, pred, logits = eng.step(state, imgs[t], SIZE)
        shadow.update(t)
        outs.append((pred, logits))
    return outs


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def blocks_of(layers):
    out = []
    for i in range(layers):
        out += [(f"lstt.block{i}", "lstt"), ("lt_read", f"lstt.block{i}"),
                ("st_read", f"lstt.block{i}")]
    return out


@pytest.mark.parametrize("model_name, layers", [("aott", 1), ("deaotl", 3)])
def test_serving_step_span_tree_and_bit_identical_outputs(model_name, layers):
    """Every frame is one tree under its root; spans change no output."""
    # gap 2 and a grow ring of 1 frame: step 2 grows the ring and writes it
    over = dict(TEST_LONG_TERM_MEM_GAP=2, TEST_LONG_TERM_MEM_CAP=1,
                TEST_LONG_TERM_MEM_POLICY="grow")
    imgs, mask = clip(4)
    _, eng = serving(model_name, **over)
    off = serve(eng, imgs, mask)
    assert tracing.take_spans() == []
    tracing.enable_spans(True)
    on = serve(eng, imgs, mask)
    tracing.enable_spans(False)
    for (p0, l0), (p1, l1) in zip(off, on):
        torch.testing.assert_close(p1, p0, rtol=0, atol=0)
        torch.testing.assert_close(l1, l0, rtol=0, atol=0)

    spans = tracing.take_spans()
    frames = {}
    for s in spans:
        frames.setdefault(s.frame, []).append(s)
    roots = [[s for s in fr if s.parent == -1] for fr in frames.values()]
    assert [[r.name for r in rs] for rs in roots] == (
        [["infer.add_reference_frame"], ["infer.step"], ["grow_lt"],
         ["infer.step"], ["infer.step"]])
    by_frame = [tree(spans, f) for f in frames]
    ref = by_frame[0]
    assert ref == ([("infer.add_reference_frame", None),
                    ("encode", "infer.add_reference_frame"),
                    ("lstt", "infer.add_reference_frame")]
                   + blocks_of(layers))
    step = ([("infer.step", None), ("encode", "infer.step"),
             ("lstt", "infer.step")] + blocks_of(layers)
            + [("decode", "infer.step"), ("upsample_argmax", "infer.step"),
               ("update_memory", "infer.step")])
    assert by_frame[1] == step
    assert by_frame[2] == [("grow_lt", None)]
    # step 2 writes the LT ring (gap 2), steps 1 and 3 do not
    assert by_frame[3] == step + [("lt_write", "update_memory")]
    assert by_frame[4] == step
    own = tracing.self_ns(spans)
    assert all(v >= 0 for v in own)


@pytest.mark.parametrize("model_name, layers", [("aott", 1), ("deaotl", 3)])
def test_serving_step_counts_routes_and_live_keys(model_name, layers):
    """On the CPU every global read is dense and every local read plain;
    each block reads its self-attention's HW keys and the live prefix of
    the LT ring; the ring's writes and grows are counted, each frame's
    encode as eager, and no kernel."""
    over = dict(TEST_LONG_TERM_MEM_GAP=2, TEST_LONG_TERM_MEM_CAP=1,
                TEST_LONG_TERM_MEM_POLICY="grow")
    cfg, eng = serving(model_name, **over)
    imgs, mask = clip(5)
    state = eng.add_reference_frame(imgs[0], mask, 2)
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    # the reference frame: self-attention and the frame's own memory; the
    # CPU encodes eagerly
    assert tracing.counters() == {
        "attn.global.dense": 2 * layers,
        "attn.global.dense.keys": 2 * layers * HW,
        "attn.local.plain": layers, "encode.graph.eager": 1}
    for t in range(1, len(imgs)):
        tracing.reset_counters()
        grown = False
        if shadow.will_write(t):
            before = eng.lt_cap(state)
            state = eng.ensure_lt_capacity(state, shadow.count + 1)
            grown = eng.lt_cap(state) > before
        live = shadow.count * HW                # LT frames before the write
        state, _, _ = eng.step(state, imgs[t], SIZE)
        writes = shadow.update(t) - (live // HW)
        got = tracing.counters()
        want = {"attn.global.dense": 2 * layers,
                "attn.global.dense.keys": layers * (HW + live),
                "attn.local.plain": layers, "encode.graph.eager": 1}
        if writes:
            want["engine.lt_write"] = 1
        if grown:
            # the grown ring is every buffer the grow allocated
            want["engine.lt_grow"] = 1
            want["engine.lt_grow_bytes"] = sum(
                v.numel() * v.element_size()
                for layer in state.lt for v in layer.values())
        assert got == want, (t, got, want)
        assert not any(k.startswith("launch.") for k in got)
