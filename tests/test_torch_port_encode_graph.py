"""The image encoder replayed from a CUDA graph (engine/graphs.py,
VOSEngine.encode_image).

On the CPU: a call the graph may not take (a CPU input, a gradient asked
for, the model in training mode) runs today's eager encode, bit for bit,
and counts `encode.graph.eager`; which calls get a key, and what the key
holds; the cache's keys, its least-recently-used cap and its counters,
driven through a stand-in for the graph object.

On a card (marked `card`, skipped without one): the graph path's encoder
maps bit-identical to eager for MobileNetV2 at 481x849 and 1009x1793,
ResNet-50 at 481x849 and Swin-B at 480x848; a 20-frame serving sequence
per configuration with the same masks, logits, rings and counters on both
paths; and a state kept from one frame left whole by the next encode:

    python -m pytest --noconftest -m card tests/test_torch_port_encode_graph.py

(`--noconftest`: the suite's conftest imports JAX, which a machine with a
card need not have; this file imports none of it.)
"""

import numpy as np
import pytest
import torch

from aot_tpu_torch.configs import build_config
from aot_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from aot_tpu_torch.engine import build_infer_engine, graphs
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.ops import attention
from aot_tpu_torch.utils import tracing

SIZE = (65, 97)
GRAPH_COUNTERS = ("encode.graph.replay", "encode.graph.capture",
                  "encode.graph.eager", "encode.graph.pool_bytes")


@pytest.fixture(autouse=True)
def clean_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def serving(model_name, device="cpu", **over):
    cfg = build_config(stage="pre_ytb_dav", model=model_name, **over)
    model = build_vos_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(3)).eval()
    return cfg, build_infer_engine(model, cfg)


def frames(count, size, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (count, 1) + tuple(size)
                                        + (3,), dtype=np.uint8))


def todays_encode(model, img):
    """The encode as the engine ran it before the graphs: the uint8
    normalisation, the permute and the model's encoder and projector."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    x = (img.float() / 255.0 - mean) / std
    return model.encode_image(x.permute(0, 3, 1, 2).contiguous())


def graph_free(counts):
    return {k: v for k, v in counts.items() if k not in GRAPH_COUNTERS}


# --- the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["inference", "grad", "training"])
def test_ineligible_calls_run_eagerly_bit_identical(mode, one_torch_thread):
    """On the CPU, with a gradient and with the model in training mode the
    encode runs eagerly: today's maps to the bit, one eager count."""
    _, eng = serving("aott")
    model = eng.engine.model
    img = frames(1, SIZE)[0]
    if mode == "training":
        model.train()
    if mode == "inference":
        with torch.inference_mode():
            want = todays_encode(model, img)
            tracing.reset_counters()
            got = eng.engine.encode_image(img)
    else:
        with torch.no_grad():
            want = todays_encode(model, img)
        tracing.reset_counters()
        got = eng.engine.encode_image(img)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    assert tracing.counters() == {"encode.graph.eager": 1}
    assert eng.engine._encoder_graphs.keys() == []


class CardImage:
    """What `_graph_key` reads of an image on a card."""
    is_cuda = True
    shape = (1, 481, 849, 3)
    dtype = torch.uint8
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["eligible", "grad", "training", "cpu"])
def test_graph_key_by_what_the_call_observes(case):
    """A key only for a card input with no gradient and the model in eval
    mode; it holds the input's shape, dtype and device and the settings
    that pick the captured kernels."""
    _, eng = serving("aott")
    engine = eng.engine
    img = frames(1, SIZE)[0] if case == "cpu" else CardImage()
    if case == "training":
        engine.model.train()
    with torch.set_grad_enabled(case == "grad"):
        key = engine._graph_key(img)
    if case != "eligible":
        assert key is None
        return
    assert key == ((1, 481, 849, 3), torch.uint8, torch.device("cuda", 0),
                   attention.attn_impl(),
                   torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    prev = attention.set_attn_impl("reference")
    try:
        with torch.no_grad():
            assert engine._graph_key(img)[3] == "reference"
    finally:
        attention.set_attn_impl(prev)


class StandInGraph:
    """A graph's part: replay() writes the captured function of the static
    input into the static output, and counts nothing (a replay launches
    no wrapper)."""

    def __init__(self, static_in, out):
        self.static_in, self.out = static_in, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(self.static_in * 2 + 1)


def counted_fn(x):
    """A stand-in encoder: what it launches counts, as a kernel wrapper's
    and a route's counters do."""
    tracing.count("launch.stand_in")
    tracing.count("attn.stand_in.windows", 7)
    return x * 2 + 1


class StandInCapture:
    """capture(fn, x), as graphs.CudaCapture: fn run once (warm-up) and
    once more under 'capture', both counting; a graph over a static copy
    of x, and what the captured call counted. `reserved` gives the pool's
    bytes after each capture."""

    def __init__(self, reserved=()):
        self.graphs = []
        self.reserved = iter(reserved)

    def __call__(self, fn, x):
        fn(x)
        static_in = x.clone()
        with tracing.counted_apart() as counts:
            out = fn(static_in)
        graph = StandInGraph(static_in, out)
        self.graphs.append(graph)
        return graph, static_in, out, dict(counts)

    def reserved_bytes(self):
        return next(self.reserved, 0)


def test_cache_keys_and_least_recently_used_cap():
    cap = StandInCapture()
    cache = graphs.GraphCache("encode.graph", cap)
    for key in "abcd":
        cache.run(key, torch.zeros(2), counted_fn)
    assert cache.keys() == list("abcd")
    cache.run("a", torch.zeros(2), counted_fn)        # a: most recent
    cache.run("e", torch.zeros(2), counted_fn)        # b: dropped
    assert cache.keys() == list("cdae")
    assert len(cache.keys()) == graphs.MAX_GRAPHS
    cache.run("b", torch.zeros(2), counted_fn)        # captured again
    assert cache.keys() == list("daeb")
    got = tracing.counters()
    assert got["encode.graph.capture"] == 6
    assert got["encode.graph.replay"] == 1
    assert "encode.graph.eager" not in got
    assert len(cap.graphs) == 6
    # every call replays its graph once, the capturing call included
    assert [g.replays for g in cap.graphs] == [2, 1, 1, 1, 1, 1]


def test_replays_return_the_function_of_each_input():
    """The static input takes each call's input: the outputs are the
    function's of it, from the one static output."""
    cache = graphs.GraphCache("encode.graph", StandInCapture())
    first = cache.run("k", torch.tensor([1.0, 2.0]), counted_fn)
    assert torch.equal(first, torch.tensor([3.0, 5.0]))
    again = cache.run("k", torch.tensor([-1.0, 0.5]), counted_fn)
    assert again is first                       # the graph's static output
    assert torch.equal(again, torch.tensor([-1.0, 2.0]))


def test_replayed_counters_equal_eager_counts(monkeypatch):
    """The warm-up's and the capture's counts are kept apart, and each
    replay adds the captured call's: the counters read as under eager."""
    x = torch.ones(3)
    for _ in range(5):
        graphs.GraphCache("encode.graph", StandInCapture()).run(
            None, x, counted_fn)
    eager = tracing.counters()
    assert eager["encode.graph.eager"] == 5
    tracing.reset_counters()
    cache = graphs.GraphCache("encode.graph", StandInCapture())
    for key in ("a", "a", "b", "a", "b"):
        cache.run(key, x, counted_fn)
    replayed = tracing.counters()
    assert graph_free(replayed) == graph_free(eager) == {
        "launch.stand_in": 5, "attn.stand_in.windows": 35}
    assert replayed["encode.graph.capture"] == 2
    assert replayed["encode.graph.replay"] == 3
    # a cache that keeps no graph runs every call eagerly
    tracing.reset_counters()
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 0)
    cache.run("a", x, counted_fn)
    assert tracing.counters() == {"encode.graph.eager": 1,
                                  "launch.stand_in": 1,
                                  "attn.stand_in.windows": 7}


def test_pool_bytes_count_the_pool_growth():
    cache = graphs.GraphCache("encode.graph",
                              StandInCapture(reserved=[100, 250, 250]))
    for key in ("a", "b", "a", "c"):
        cache.run(key, torch.zeros(1), counted_fn)
    assert tracing.counters()["encode.graph.pool_bytes"] == 250


# --- the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder graphs capture there")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = prev


@pytest.mark.card
@pytest.mark.parametrize("model_name, size", [
    ("aott", (481, 849)), ("aott", (1009, 1793)),
    ("r50_deaotl", (481, 849)), ("swinb_deaotl", (480, 848))])
def test_graph_maps_bit_identical_to_eager_on_card(model_name, size, card,
                                                   monkeypatch):
    cfg, eng = serving(model_name, card)
    imgs = frames(3, size).to(card)
    with torch.inference_mode():
        with monkeypatch.context() as m:
            m.setattr(graphs, "MAX_GRAPHS", 0)
            want = [[x.clone() for x in eng.engine.encode_image(img)]
                    for img in imgs]
        assert tracing.counters()["encode.graph.eager"] == 3
        for i, img in enumerate(imgs):        # capture, then two replays
            got = eng.engine.encode_image(img)
            assert all(torch.equal(g, w) for g, w in zip(got, want[i])), i
    counts = tracing.counters()
    assert counts["encode.graph.capture"] == 1
    assert counts["encode.graph.replay"] == 2
    assert counts["encode.graph.pool_bytes"] > 0


def serve_card(eng, imgs, mask, size):
    """The reference frame, then a step a frame as the evaluator drives
    it; returns the state and each step's (pred, logits)."""
    state = eng.add_reference_frame(imgs[0], mask, 3)
    shadow = eng.make_shadow()
    shadow.add_ref(0)
    outs = []
    for t in range(1, len(imgs)):
        if shadow.will_write(t):
            state = eng.ensure_lt_capacity(state, shadow.count + 1)
        state, pred, logits = eng.step(state, imgs[t], size)
        shadow.update(t)
        outs.append((pred.clone(), logits.clone()))
    return state, outs


def ellipse_mask(size, device):
    hgt, wid = size
    yy, xx = np.mgrid[:hgt, :wid]
    mask = np.zeros(size, np.int64)
    for o in range(1, 4):
        cy, cx = hgt * o / 4, wid * (4 - o) / 4
        mask[((yy - cy) / (hgt / 6)) ** 2 + ((xx - cx) / (wid / 8)) ** 2
             <= 1] = o
    return torch.from_numpy(mask)[None].to(device)


@pytest.mark.card
@pytest.mark.parametrize("model_name, size", [
    ("aott", (481, 849)), ("r50_deaotl", (481, 849)),
    ("swinb_deaotl", (480, 848))])
def test_twenty_frames_same_on_both_paths_on_card(model_name, size, card,
                                                  monkeypatch):
    """Masks, logits, the LT and ST rings and every counter but the
    graphs' own, the same to the bit with the encoder replayed and
    eager (LT gap 5, a grow ring: writes at steps 5, 10 and 15)."""
    over = dict(TEST_LONG_TERM_MEM_GAP=5, TEST_LONG_TERM_MEM_CAP=2,
                TEST_LONG_TERM_MEM_POLICY="grow")
    cfg, graph_eng = serving(model_name, card, **over)
    eager_eng = build_infer_engine(graph_eng.engine.model, cfg)
    imgs = frames(20, size, seed=1).to(card)
    mask = ellipse_mask(size, card)

    runs = {}
    for name, eng in (("eager", eager_eng), ("graph", graph_eng)):
        tracing.reset_counters()
        with monkeypatch.context() as m:
            if name == "eager":
                m.setattr(graphs, "MAX_GRAPHS", 0)
            state, outs = serve_card(eng, imgs, mask, size)
        torch.cuda.synchronize()
        runs[name] = (state, outs, tracing.counters())
    (se, oe, ce), (sg, og, cg) = runs["eager"], runs["graph"]
    for t, ((pe, le), (pg, lg)) in enumerate(zip(oe, og)):
        assert torch.equal(pe, pg) and torch.equal(le, lg), t
    for ring_e, ring_g in ((se.lt, sg.lt), (se.st, sg.st)):
        for layer_e, layer_g in zip(ring_e, ring_g):
            assert layer_e.keys() == layer_g.keys()
            assert all(torch.equal(layer_e[k], layer_g[k]) for k in layer_e)
    assert se.lt_count == sg.lt_count
    assert graph_free(ce) == graph_free(cg)
    assert ce["encode.graph.eager"] == 20
    assert cg["encode.graph.capture"] == 1
    assert cg["encode.graph.replay"] == 19
    assert "encode.graph.eager" not in cg


@pytest.mark.card
def test_next_encode_leaves_a_kept_state_whole_on_card(card):
    """A frame's state, mask and logits hold their values through the next
    frame's encode, which overwrites the graph's outputs: the rings,
    current memories and LSTT outputs are copies or new tensors."""
    size = (481, 849)
    cfg, eng = serving("aott", card)
    imgs = frames(3, size, seed=2).to(card)
    state = eng.add_reference_frame(imgs[0], ellipse_mask(size, card), 3)
    state, pred, logits = eng.step(state, imgs[1], size)
    kept = [t.clone() for t in (pred, logits)]
    rings = [{k: v.clone() for k, v in layer.items()}
             for layer in state.lt + state.st + state.curr]
    embs = [e.clone() for e in state.embs]
    with torch.inference_mode():
        eng.engine.encode_image(imgs[2])
    torch.cuda.synchronize()
    assert torch.equal(pred, kept[0]) and torch.equal(logits, kept[1])
    for layer, saved in zip(state.lt + state.st + state.curr, rings):
        assert all(torch.equal(layer[k], saved[k]) for k in saved)
    assert all(torch.equal(e, s) for e, s in zip(state.embs, embs))
    assert tracing.counters()["encode.graph.replay"] == 2
