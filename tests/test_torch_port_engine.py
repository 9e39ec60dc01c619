"""The port's online inference engine against aot_tpu's on the CPU, with the
same weights, free-running over a seeded synthetic clip at 257x257.

Per frame the predicted masks must agree on >= 99.9% of pixels (argmax
near-ties may flip a few; each side feeds back its own mask) and the
grid-resolution logits to <= 1e-3. Also: the ring and aggregation unit
tests of tests/test_engine.py, held against the JAX functions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine import build_infer_engine as jax_build_infer_engine
from aot_tpu.engine import infer as jinfer
from aot_tpu.engine import state as jstate_mod
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.engine import infer as pinfer
from aot_tpu_torch.engine import state as S
from test_torch_port_model import jax_aott, port_aott

SIZE = 257
LOGIT_TOL = 1e-3
MASK_AGREE = 0.999


def port_state(js) -> S.EngineState:
    """A port EngineState built from the numpy leaves of a JAX one
    (encoder maps NHWC -> NCHW, counters to host ints)."""
    t = lambda x: torch.tensor(np.asarray(x))
    mem = lambda layers: [{k: t(v) for k, v in layer.items()}
                          for layer in layers]
    return S.EngineState(
        lt=mem(js.lt), lt_count=[int(c) for c in np.asarray(js.lt_count)],
        st=mem(js.st), st_ptr=int(js.st_ptr), st_count=int(js.st_count),
        curr=mem(js.curr), embs=[t(e) for e in js.embs],
        shortcuts=[t(np.asarray(s).transpose(0, 3, 1, 2))
                   for s in js.shortcuts],
        frame_step=int(js.frame_step), last_mem_step=int(js.last_mem_step),
        obj_nums=t(js.obj_nums).long())


def clip(seed: int, frames: int):
    """Noise frames and masks with 12 square objects (ids 1..12)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(frames, 1, SIZE, SIZE, 3).astype(np.float32)
    mask = np.zeros((1, SIZE, SIZE), np.int32)
    for i in range(1, 13):
        y, x = rng.randint(0, SIZE - 50, 2)
        mask[0, y:y + 50, x:x + 50] = i
    return imgs, mask


@pytest.fixture(scope="module")
def weights():
    cfg = build_config(stage="pre_ytb_dav", model="aott")
    jmodel, params = jax_aott(cfg)
    return jmodel, params, port_aott(cfg, params)


SCENARIOS = {
    # the slice's own config (grow ring of 8, gap 9999), 10 objects
    "main": (dict(TEST_LONG_TERM_MEM_CAP=8),
             [("ref", 10), "step", "step", "step", "step"]),
    # gap 2, fifo ring of 3: 5 objects, then 12 arrive mid-video (a second
    # group with a shorter LT memory, soft aggregation); the ring wraps at
    # frame 5
    "rings": (dict(TEST_LONG_TERM_MEM_CAP=3, TEST_LONG_TERM_MEM_GAP=2,
                   TEST_LONG_TERM_MEM_POLICY="fifo"),
              [("ref", 5), "step", "step", ("ref", 12), "step", "step",
               "step"]),
    # gap 1, 'stop' ring of 2: writes stop once the ring is full
    "stop": (dict(TEST_LONG_TERM_MEM_CAP=2, TEST_LONG_TERM_MEM_GAP=1,
                  TEST_LONG_TERM_MEM_POLICY="stop"),
             [("ref", 3), "step", "step", "step"]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_jax_free_running(weights, scenario):
    jmodel, params, model = weights
    overrides, events = SCENARIOS[scenario]
    cfg = build_config(stage="pre_ytb_dav", model="aott", **overrides)
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    shadow = eng.make_shadow()
    imgs, full_mask = clip(1, len(events))
    jstep = jax.jit(lambda p, s, i: jeng.step(p, s, i, output_size=(SIZE, SIZE)))

    js = ps = None
    for t, ev in enumerate(events):
        img = imgs[t]
        if ev == "step":
            js, jpred, jlog = jstep(params, js, jnp.asarray(img))
            ps, pred, logits = eng.step(ps, torch.from_numpy(img), (SIZE, SIZE))
            shadow.update(ps.frame_step)
            err = np.abs(logits.numpy() - np.asarray(jlog)).max()
            agree = (pred.numpy() == np.asarray(jpred)).mean()
            assert err <= LOGIT_TOL, (scenario, t, err)
            assert agree >= MASK_AGREE, (scenario, t, agree)
        else:
            n = ev[1]
            mask = np.where(full_mask <= n, full_mask, 0)
            jadd = jax.jit(lambda p, i, m, s, n=n, t=t: jeng.add_reference_frame(
                p, i, m, obj_num=n, state=s, frame_step=t))
            js = jadd(params, jnp.asarray(img), jnp.asarray(mask), js)
            ps = eng.add_reference_frame(torch.from_numpy(img),
                                         torch.from_numpy(mask), n, state=ps,
                                         frame_step=t)
            shadow.add_ref(t)
        assert ps.lt_count == [int(c) for c in np.asarray(js.lt_count)]
        assert (ps.frame_step, ps.last_mem_step, ps.st_ptr, ps.st_count) == (
            int(js.frame_step), int(js.last_mem_step), int(js.st_ptr),
            int(js.st_count))
        if cfg.TEST_LONG_TERM_MEM_POLICY != "stop":  # the shadow ignores 'stop'
            assert shadow.count == max(ps.lt_count)
    if scenario == "rings":
        assert ps.batch == 2 and ps.lt_count == [4, 2]
    if scenario == "stop":
        assert ps.lt_count == [2]


@pytest.mark.parametrize("skip_lt", [False, True])
def test_update_memory_from_prob(weights, skip_lt):
    """VOSEngine.update_memory with a soft mask (prob) and the LT-skip
    flag, from the same state on both sides."""
    jmodel, params, model = weights
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TEST_LONG_TERM_MEM_CAP=3, TEST_LONG_TERM_MEM_GAP=1)
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    imgs, mask = clip(3, 2)
    js = jax.jit(lambda p, i, m: jeng.add_reference_frame(p, i, m, obj_num=8))(
        params, jnp.asarray(imgs[0]), jnp.asarray(np.where(mask <= 8, mask, 0)))
    js = jax.jit(jeng.propagate)(params, js, jnp.asarray(imgs[1]))
    logits = np.random.RandomState(4).randn(1, SIZE, SIZE, 11)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    prob = prob.astype(np.float32)
    ps = port_state(js)
    js = jax.jit(lambda p, s, q: jeng.engine.update_memory(
        p, s, prob=q, skip_long_term_update=skip_lt))(params, js,
                                                       jnp.asarray(prob))
    with torch.inference_mode():
        ps = eng.engine.update_memory(ps, prob=torch.from_numpy(prob),
                                      skip_long_term_update=skip_lt)
    assert ps.lt_count == [int(c) for c in np.asarray(js.lt_count)]
    assert ps.lt_count == ([1] if skip_lt else [2])
    assert ps.last_mem_step == int(js.last_mem_step) == 1
    for got, want in ((ps.lt, js.lt), (ps.st, js.st)):
        for key in ("k", "v"):
            np.testing.assert_allclose(got[0][key].numpy(),
                                       np.asarray(want[0][key]),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_step_from_converted_state_and_lt_growth(weights):
    """One step from a port state built from the JAX state's leaves, and
    the 'grow' policy's re-bucketing against the JAX engine's."""
    jmodel, params, model = weights
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TEST_LONG_TERM_MEM_CAP=2)
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    imgs, mask = clip(2, 2)
    js = jax.jit(lambda p, i, m: jeng.add_reference_frame(p, i, m, obj_num=12))(
        params, jnp.asarray(imgs[0]), jnp.asarray(mask))

    ps = port_state(js)
    copy = ps.to("cpu")
    assert copy.lt[0]["k"] is not ps.lt[0]["k"]
    _, jpred, jlog = jax.jit(
        lambda p, s, i: jeng.step(p, s, i, output_size=(SIZE, SIZE)))(
            params, js, jnp.asarray(imgs[1]))
    ps, pred, logits = eng.step(ps, torch.from_numpy(imgs[1]), (SIZE, SIZE))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert (pred.numpy() == np.asarray(jpred)).mean() >= MASK_AGREE
    # the step did not write the LT ring (gap 9999): the copy still equals
    np.testing.assert_array_equal(copy.lt[0]["v"].numpy(),
                                  ps.lt[0]["v"].numpy())

    grown_j = jeng.ensure_lt_capacity(js, 5)
    grown_p = eng.ensure_lt_capacity(port_state(js), 5)
    assert eng.lt_cap(grown_p) == jeng.lt_cap(grown_j) == 8
    for key in ("k", "v"):
        np.testing.assert_array_equal(grown_p.lt[0][key].numpy(),
                                      np.asarray(grown_j.lt[0][key]))


# --- ring and aggregation units (tests/test_engine.py:81-124) ---------------


@pytest.mark.parametrize("policy", ["fifo", "grow", "stop"])
@pytest.mark.parametrize("cap", [1, 3, 4])
def test_lt_write_slot(policy, cap):
    counts = list(range(10))
    want = np.asarray(jstate_mod.lt_write_slot(jnp.asarray(counts), cap,
                                               policy))
    assert [S.lt_write_slot(c, cap, policy) for c in counts] == want.tolist()
    if policy == "fifo" and cap == 4:
        # fills 0..3 then cycles 1,2,3 (slot 0 = reference frame pinned)
        assert want.tolist() == [0, 1, 2, 3, 1, 2, 3, 1, 2, 3]


def test_st_oldest_slot():
    for skip in (1, 2, 3):
        for ptr in range(skip):
            for count in range(1, skip + 1):
                want = int(jstate_mod.st_oldest_slot(
                    jnp.asarray(ptr), jnp.asarray(count), skip))
                assert S.st_oldest_slot(ptr, count, skip) == want
    assert S.st_oldest_slot(2, 3, 3) == 0
    assert S.st_oldest_slot(1, 1, 3) == 1


def test_separate_mask_roundtrip():
    m = np.zeros((1, 8, 8), np.int64)
    m[0, 0, 0], m[0, 1, 1], m[0, 2, 2], m[0, 3, 3] = 1, 10, 11, 15
    sep = pinfer.separate_mask(torch.from_numpy(m), 2, 10).numpy()
    assert sep.shape == (2, 8, 8)
    assert sep[0, 0, 0] == 1 and sep[0, 1, 1] == 10
    assert sep[0, 2, 2] == 0 and sep[1, 2, 2] == 1 and sep[1, 3, 3] == 5
    np.testing.assert_array_equal(
        sep, np.asarray(jinfer.separate_mask(jnp.asarray(m), 2, 10)))
    assert pinfer.separated_obj_nums(15, 2, 10) == [10, 5]
    assert pinfer.separated_obj_nums(20, 2, 10) == [10, 10]


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_aggregation_matches_jax_and_reference_formula(groups):
    logits = np.random.RandomState(0).randn(groups, 4, 4, 11).astype(np.float32)
    soft = pinfer.soft_aggregate_logits(torch.from_numpy(logits), 10).numpy()
    np.testing.assert_allclose(
        soft, np.asarray(jinfer.soft_aggregate_logits(jnp.asarray(logits), 10)),
        rtol=1e-5, atol=1e-5)
    low = pinfer.min_aggregate_logits(torch.from_numpy(logits), 10).numpy()
    np.testing.assert_array_equal(
        low, np.asarray(jinfer.min_aggregate_logits(jnp.asarray(logits), 10)))
    if groups == 2:
        assert soft.shape == (1, 4, 4, 21)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        bg = (probs[0, ..., 0] * probs[1, ..., 0])[None, ..., None]
        fg = np.concatenate([probs[0:1, ..., 1:], probs[1:2, ..., 1:]], -1)
        merged = np.clip(np.concatenate([bg, fg], -1), 1e-5, 1 - 1e-5)
        np.testing.assert_allclose(soft, np.log(merged / (1 - merged)),
                                   rtol=1e-4, atol=1e-4)
