"""The port's local-window attention (plain version, the CPU path of
ops/kernels/local_window_attn.py) against aot_tpu's dense oracle and its
flat, wide and narrow Pallas kernels in interpret mode, and against the
JAX dispatch above its 2,500-token crossover (the banded form on the CPU),
on seeded numpy inputs; and the port's route rule (`local_route`).

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against this plain version there. Tolerance 2e-5 against the flat kernel
and the dense oracle, as the JAX package's own kernel tests use; 1e-5
against the wide and narrow kernels and the banded dispatch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aot_tpu.ops import attention as jax_att
from aot_tpu.ops.attention import _local_attention_dense
from aot_tpu.ops.pallas.local_window_attn import (local_window_attention,
                                                   local_window_attention_flat,
                                                   local_window_attention_wide)
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops.kernels import local_window_attn as lwa
from aot_tpu_torch.utils import tracing

TOL = dict(atol=2e-5, rtol=2e-5)
TIGHT = dict(atol=1e-5, rtol=1e-5)


def _mk(b, hgt, wid, h, d, dv, max_dis, with_rv, seed=0):
    rng = np.random.RandomState(seed)
    hw, win2 = hgt * wid, (2 * max_dis + 1) ** 2
    q = rng.randn(b, hw, h * d).astype(np.float32)
    k = rng.randn(b, hw, h * d).astype(np.float32)
    v = rng.randn(b, hw, h * dv).astype(np.float32)
    rb = (0.3 * rng.randn(b, h, hw, win2)).astype(np.float32)
    rv = (0.3 * rng.randn(h, dv, win2)).astype(np.float32) if with_rv else None
    return q, k, v, rb, rv


def _both(args):
    j = [None if a is None else jnp.asarray(a) for a in args]
    t = [None if a is None else torch.from_numpy(a) for a in args]
    return j, t


CASES = [  # (hgt, wid, heads, d, dv, max_dis); the small grids are those of
    # tests/test_local_window_kernel.py, 17x17 is an AOT-head case with
    # interior positions for the 15x15 window
    (10, 12, 2, 8, 8, 2), (9, 7, 2, 8, 8, 2), (8, 8, 2, 8, 8, 2),
    (17, 17, 8, 32, 32, 7),
]


@pytest.mark.parametrize("with_rv", [True, False])
@pytest.mark.parametrize("hgt,wid,h,d,dv,m", CASES)
def test_plain_matches_dense_oracle_and_flat_kernel(hgt, wid, h, d, dv, m,
                                                    with_rv):
    args = _mk(2, hgt, wid, h, d, dv, m, with_rv)
    j, t = _both(args)
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=m, d_att=d)
    got = lwa.local_window_attention_plain(*t, **kw).numpy()
    dense = np.asarray(_local_attention_dense(*j, **kw))
    flat = np.asarray(local_window_attention_flat(*j, **kw, interpret=True))
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, flat, **TOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_dispatch_on_cpu_takes_plain_path(dilation):
    """ops.attention.local_attention sends a CPU tensor to the plain
    version (any dilation), counted as a 'plain' read, and no kernel launch
    is counted."""
    args = _mk(1, 10, 12, 2, 8, 8, 2, True, seed=1)
    j, t = _both(args)
    kw = dict(num_heads=2, size_2d=(10, 12), max_dis=2, d_att=8,
              dilation=dilation)
    before = tracing.counters()
    got = att.local_attention(*t, **kw).numpy()
    entry = lwa.local_window_attention(*t, num_heads=2, size_2d=(10, 12),
                                       max_dis=2, d_att=8).numpy()
    after = tracing.counters()
    assert {k: v for k, v in after.items() if k.startswith("launch.")} == {
        k: v for k, v in before.items() if k.startswith("launch.")}
    assert (after["attn.local.plain"]
            == before.get("attn.local.plain", 0) + 1)
    np.testing.assert_allclose(got, np.asarray(_local_attention_dense(*j, **kw)),
                               **TOL)
    if dilation == 1:
        np.testing.assert_array_equal(got, entry)


def test_kernel_wrapper_refuses_non_cuda_tensors():
    """No fallback: the CUDA wrapper raises for a tensor not on a CUDA
    device, and the dispatcher raises where no path exists (a non-CPU
    tensor at dilation 2)."""
    _, t = _both(_mk(1, 8, 8, 2, 8, 8, 2, True))
    kw = dict(num_heads=2, size_2d=(8, 8), max_dis=2, d_att=8)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError):
        lwa.local_window_attention_cuda(*t, **kw)
    with pytest.raises(ValueError):
        att.local_attention(*meta, **kw)
    with pytest.raises(NotImplementedError):
        att.local_attention(*meta, **kw, dilation=2)


HEADS = {"aot": (2, 8, 8), "deaot": (1, 16, 64)}   # (heads, d, dv)


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("with_rv", [True, False])
@pytest.mark.parametrize("hgt,wid,rq", [(10, 12, 4), (9, 7, 8), (8, 8, 8)])
def test_plain_matches_wide_and_narrow_kernels(hgt, wid, rq, with_rv, head):
    """The TPU wide kernel (#2, ported into csrc/local_window_attn_tc.cu)
    and narrow kernel (#3) in interpret mode, at the narrow kernel's test
    grids (tests/test_local_window_kernel.py), an AOT-like and a DeAOT-like
    head."""
    h, d, dv = HEADS[head]
    args = _mk(2, hgt, wid, h, d, dv, 2, with_rv, seed=hgt * wid)
    j, t = _both(args)
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=2, d_att=d)
    got = lwa.local_window_attention_plain(*t, **kw).numpy()
    for fn in (local_window_attention_wide, local_window_attention):
        want = fn(*j, **kw, rows_per_band=rq, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **TIGHT)


def test_plain_matches_jax_dispatch_above_the_threshold():
    """52x52 = 2,704 query tokens, above aot_tpu's _DENSE_LOCAL_MAX_TOKENS:
    the JAX dispatch takes its banded form on the CPU (the wide kernel on a
    TPU), the port its plain version on the CPU (its one kernel on the
    card)."""
    hgt = wid = 52
    assert hgt * wid > jax_att._DENSE_LOCAL_MAX_TOKENS
    args = _mk(1, hgt, wid, 2, 8, 8, 7, True, seed=5)
    j, t = _both(args)
    kw = dict(num_heads=2, size_2d=(hgt, wid), max_dis=7, d_att=8)
    got = att.local_attention(*t, **kw).numpy()
    want = np.asarray(jax_att.local_attention(*j, **kw))
    np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("tokens", [2500, 2501])
def test_route(tokens, device, training):
    """The JAX rule (aot_tpu/ops/attention.py:351-383) with its two TPU
    kernels read as the port's one: at dilation 1 a card tensor takes the
    kernel on either side of aot_tpu's 2,500-token crossover; training on
    any device the window form; any other CPU tensor the plain version; a
    card tensor at another dilation has no kernel."""
    route = att.local_route(tokens, device, 1, training)
    if training:
        assert route == "window"
    elif device == "cpu":
        assert route == "plain"
    else:
        assert route == "kernel"
    want_dil2 = ("window" if training else "plain" if device == "cpu"
                 else "none")
    assert att.local_route(tokens, device, 2, training) == want_dil2


@pytest.mark.parametrize("hgt,wid", [(31, 54), (30, 53), (64, 113), (50, 50),
                                     (41, 61)])
def test_every_card_read_takes_the_one_kernel(hgt, wid, monkeypatch):
    """Under a card route forced on CPU tensors, a counting stand-in for
    the kernel's wrapper sees every dilation-1 read: the benchmark cells'
    grids (31x54, 30x53, DAVIS 1080p's 64x113) and 2,500 and 2,501 tokens
    on either side of aot_tpu's crossover, each counted once as
    `attn.local.kernel` and once as `launch.local_window_attn`."""
    route = att.local_route
    seen = []

    def stand_in(*args, **kw):
        seen.append(kw["size_2d"])
        tracing.count("launch.local_window_attn")
        return lwa.local_window_attention_plain(*args, **kw)

    monkeypatch.setattr(att, "local_route",
                        lambda tokens, _, dilation, training: route(
                            tokens, "cuda", dilation, training))
    monkeypatch.setattr(lwa, "local_window_attention_cuda", stand_in)
    _, t = _both(_mk(1, hgt, wid, 1, 4, 4, 7, True, seed=hgt * wid))
    kw = dict(num_heads=1, size_2d=(hgt, wid), max_dis=7, d_att=4)
    tracing.reset_counters()
    got = att.local_attention(*t, **kw)
    reads = {k: v for k, v in tracing.counters().items()
             if k.startswith(("attn.local.", "launch."))}
    assert seen == [(hgt, wid)]
    assert reads == {"attn.local.kernel": 1, "launch.local_window_attn": 1}
    torch.testing.assert_close(
        got, lwa.local_window_attention_plain(*t, **kw), rtol=0, atol=0)
