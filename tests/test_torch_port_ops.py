"""aot_tpu_torch ops against their aot_tpu counterparts on the CPU: position
embedding, resizes, one-hot, relative key bias, global attention.

Inputs are seeded numpy and go through both sides; the JAX side runs its
jnp formulation (the CPU dispatch). Tolerance atol = rtol = 1e-5 (fp32,
summation order only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.ops import attention as jatt
from aot_tpu.ops import image as jimg
from aot_tpu.ops import position as jpos
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops import image as img
from aot_tpu_torch.ops import position as pos

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("h,w,feats", [(5, 7, 128), (17, 17, 128), (30, 30, 16)])
def test_sine_position_embedding(h, w, feats):
    # The JAX side runs op by op: a jitted call of these static shapes is
    # looked up in the persistent compilation cache that every test worker
    # shares (aot_tpu/utils/runtime.py), and this case once disagreed there
    # while passing alone; eager primitives compile in this process.
    with jax.disable_jit():
        want = np.asarray(jpos.sine_position_embedding(h, w,
                                                       num_pos_feats=feats))
        want_seq = np.asarray(jpos.sine_position_embedding_seq(h, w,
                                                               2 * feats))
    got = pos.sine_position_embedding(h, w, num_pos_feats=feats).numpy()
    assert got.shape == (1, h, w, 2 * feats)
    np.testing.assert_allclose(got, want, **TOL)
    seq = pos.sine_position_embedding_seq(h, w, 2 * feats).numpy()
    np.testing.assert_allclose(seq, want_seq, **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(33, 41), (65, 65), (5, 4)])
def test_interpolate_bilinear(size, align_corners):
    x = np.random.RandomState(0).randn(2, 9, 11, 5).astype(np.float32)
    want = jimg.interpolate_bilinear(_j(x), size, align_corners=align_corners)
    got = img.interpolate_bilinear(_t(x), size, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [(20, 31), (5, 4), (117, 117)])
def test_interpolate_nearest(size):
    x = np.random.RandomState(1).randn(2, 30, 29, 3).astype(np.float32)
    want = jimg.interpolate_nearest(_j(x), size)
    got = img.interpolate_nearest(_t(x), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample_argmax(align_corners):
    logits = np.random.RandomState(2).randn(2, 17, 17, 11).astype(np.float32)
    want = np.asarray(jimg.upsample_argmax(_j(logits), (65, 65),
                                           align_corners=align_corners))
    got = img.upsample_argmax(_t(logits), (65, 65),
                              align_corners=align_corners).numpy()
    assert got.shape == (2, 65, 65)
    np.testing.assert_array_equal(got, want)


def test_one_hot_mask():
    m = np.random.RandomState(3).randint(0, 11, (2, 9, 7)).astype(np.int32)
    want = np.asarray(jimg.one_hot_mask(_j(m), 10))
    got = img.one_hot_mask(_t(m), 10).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,d", [(8, 32), (2, 8), (1, 128)])
def test_relative_emb_from_q(h, d):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 50, h * d).astype(np.float32)
    w = (0.1 * rng.randn(h, 225, d)).astype(np.float32)
    b = rng.randn(h, 225).astype(np.float32)
    want = jatt.relative_emb_from_q(_j(q), _j(w), _j(b), h)
    got = att.relative_emb_from_q(_t(q), _t(w), _t(b), h)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


GLOBAL_CASES = {
    # name: (B, Lq, Lk, h, d, dv, valid_len, top_k, max_mem_len_ratio)
    "all_valid": (2, 40, 96, 4, 8, 8, None, -1, -1.0),
    "per_sample_valid": (2, 40, 96, 4, 8, 16, [96, 58], -1, -1.0),
    "scalar_valid": (2, 40, 96, 4, 8, 8, 64, -1, -1.0),
    "top_k": (2, 40, 96, 4, 8, 8, [96, 70], 16, -1.0),
    "mem_len_rescale": (2, 20, 96, 2, 8, 8, [96, 30], -1, 2.0),
    "rescale_scalar": (1, 20, 96, 2, 8, 8, 90, -1, 2.0),
}


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_attention(case):
    b, lq, lk, h, d, dv, vl, top_k, ratio = GLOBAL_CASES[case]
    rng = np.random.RandomState(5)
    q = rng.randn(b, lq, h * d).astype(np.float32)
    k = rng.randn(b, lk, h * d).astype(np.float32)
    v = rng.randn(b, lk, h * dv).astype(np.float32)
    kw = dict(top_k=top_k, max_mem_len_ratio=ratio)
    jvl = None if vl is None else jnp.asarray(vl, jnp.int32)
    tvl = vl if vl is None or isinstance(vl, int) else torch.tensor(vl)
    want = jatt.global_attention(_j(q), _j(k), _j(v), h, d, valid_len=jvl,
                                 **kw)
    got = att.global_attention(_t(q), _t(k), _t(v), h, d, valid_len=tvl, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_global_attention_query_chunking(monkeypatch):
    """Both sides chunk the queries once the score tensor passes the
    budget; shrink the budget so a small case takes the chunked path."""
    monkeypatch.setattr(jatt, "_SCORE_BUDGET", 4096)
    monkeypatch.setattr(att, "_SCORE_BUDGET", 4096)
    rng = np.random.RandomState(6)
    q = rng.randn(1, 300, 16).astype(np.float32)
    k = rng.randn(1, 64, 16).astype(np.float32)
    v = rng.randn(1, 64, 16).astype(np.float32)
    want = jatt.global_attention(_j(q), _j(k), _j(v), 2, 8,
                                 valid_len=jnp.asarray([40], jnp.int32))
    got = att.global_attention(_t(q), _t(k), _t(v), 2, 8,
                               valid_len=torch.tensor([40]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
