"""The port's flash-attention forward (plain version, the CPU path of
ops/kernels/flash_attn.py) against aot_tpu's flash kernel in interpret mode
(out and log-sum-exp, as tests/test_flash_vjp.py runs it) and against the
dense global_attention oracle, on seeded numpy inputs; the dispatch rule
that sends a long live memory to it; and the shape rules of both kernel
wrappers.

The CUDA kernels run only on the card; chip_smoke.py holds them against
these plain versions there. Tolerance 1e-5: fp32, only the summation order
differs."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aot_tpu.ops.attention import global_attention as jax_global_attention
from aot_tpu.ops.attention import set_attn_impl
from aot_tpu.ops.pallas.flash_attn_vjp import _flash_fwd_raw
from aot_tpu.ops.pallas.flash_attn_vjp import flash_attention as jax_flash
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import local_window_attn as lwa

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 128


@pytest.fixture(autouse=True)
def _jax_dense_oracle():
    set_attn_impl("xla")
    yield
    set_attn_impl("auto")


def _mk(b, lq, lk, h, d, dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h * d).astype(np.float32),
            rng.randn(b, lk, h * d).astype(np.float32),
            rng.randn(b, lk, h * dv).astype(np.float32))


def _jax_kernel_lse(q, k, v, valid, h, d):
    """aot_tpu's forward kernel (interpret mode) on head-major, padded
    copies of the inputs; returns its (B*h, Lq) log-sum-exp."""
    b, lq, _ = q.shape
    lk = k.shape[1]

    def heads(x, blk):
        l, dd = x.shape[1], x.shape[2] // h
        x = x.reshape(b, l, h, dd).transpose(0, 2, 1, 3).reshape(b * h, l, dd)
        return np.pad(x, ((0, 0), (0, (-l) % blk), (0, 0)))

    vl = np.full((b,), lk) if valid is None else np.broadcast_to(
        np.asarray(valid).reshape(-1), (b,))
    _, lse = _flash_fwd_raw(
        jnp.asarray(heads(q, BLOCK)), jnp.asarray(heads(k, BLOCK)),
        jnp.asarray(heads(v, BLOCK)),
        jnp.asarray(np.repeat(vl, h).astype(np.int32)),
        scale=1.0 / math.sqrt(d), block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    return np.asarray(lse)[:, :lq, 0]


CASES = {  # b, lq, lk, heads, d, dv, valid_len
    "ragged_per_sample": (2, 130, 260, 2, 16, 16, [260, 87]),
    "valid_none": (2, 130, 260, 2, 16, 16, None),
    "valid_int": (1, 70, 300, 2, 16, 16, 129),
    "h1_dv_8d": (2, 70, 200, 1, 16, 128, [200, 140]),
    "h2_ragged": (1, 257, 129, 2, 8, 24, [100]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_kernel_and_dense_oracle(case):
    b, lq, lk, h, d, dv, valid = CASES[case]
    q, k, v = _mk(b, lq, lk, h, d, dv)
    vl_t = torch.tensor(valid, dtype=torch.int32) if isinstance(
        valid, list) else valid
    vl_j = jnp.asarray(valid, jnp.int32) if isinstance(valid, list) else valid
    out, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vl_t,
        h, d)
    assert tuple(out.shape) == (b, lq, h * dv)
    assert tuple(lse.shape) == (b * h, lq)
    kernel = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), vl_j,
                       h, d, block_q=BLOCK, block_k=BLOCK, interpret=True)
    dense = jax_global_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), h, d, valid_len=vl_j)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_kernel_lse(q, k, v, valid, h, d), **TOL)


def test_empty_row_is_zero_as_in_the_kernel():
    """valid_len 0: the plain version gives out 0 and lse -1e30, as
    aot_tpu's kernel does; the dense jnp oracle gives the mean of the values
    there instead (all keys score -1e30), a case the engine never reaches."""
    b, lq, lk, h, d, dv = 2, 40, 150, 2, 8, 8
    q, k, v = _mk(b, lq, lk, h, d, dv, seed=2)
    valid = [lk, 0]
    out, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(valid, dtype=torch.int32), h, d)
    kernel = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid), h, d,
                                  block_q=BLOCK, block_k=BLOCK,
                                  interpret=True))
    np.testing.assert_array_equal(out[1].numpy(), 0.0)
    np.testing.assert_array_equal(lse[h:].numpy(), np.float32(fa.NEG_INF))
    np.testing.assert_allclose(out.numpy(), kernel, **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_kernel_lse(q, k, v, valid, h, d), **TOL)
    dense = np.asarray(jax_global_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, d,
        valid_len=jnp.asarray(valid)))
    np.testing.assert_allclose(dense[1], np.broadcast_to(
        v[1].mean(0), (lq, h * dv)), **TOL)


@pytest.mark.parametrize("lk,valid,top_k,ratio,want", [
    (8192, 8192, -1, -1.0, True),
    (8191, 8191, -1, -1.0, False),
    (19800, torch.tensor([19800, 9000]), -1, -1.0, True),
    (19800, None, -1, -1.0, False),
    (19800, 19800, 5, -1.0, False),
    (19800, 19800, -1, 1.4, False),
])
def test_use_flash_rule(lk, valid, top_k, ratio, want):
    assert att.use_flash(lk, valid, top_k, ratio) is want


@pytest.mark.parametrize("lk", [att.FLASH_MIN_KEYS - 1, att.FLASH_MIN_KEYS])
def test_global_attention_routes_long_memories_to_flash(lk):
    """On a CPU tensor global_attention takes the flash path's plain version
    from FLASH_MIN_KEYS keys on (bit for bit) and the dense path below;
    both agree, and no kernel is launched."""
    b, lq, h, d, dv = 2, 6, 1, 8, 16
    q, k, v = (torch.from_numpy(x) for x in _mk(b, lq, lk, h, d, dv, 3))
    valid = torch.tensor([lk, lk - 700], dtype=torch.int32)
    before = fa.LAUNCHES
    got = att.global_attention(q, k, v, h, d, valid_len=valid)
    flash, _ = fa.flash_attention(q, k, v, valid, h, d)
    assert fa.LAUNCHES == before
    if lk >= att.FLASH_MIN_KEYS:
        torch.testing.assert_close(got, flash, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, flash, **TOL)


def test_flash_wrapper_refuses_non_cuda_tensors():
    """No fallback: the kernel wrapper raises for a tensor not on a CUDA
    device, and so does the entry point for a non-CPU tensor."""
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 8, 16, 1, 8, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v, None, 1, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(*(x.to("meta") for x in (q, k, v)), None, 1, 8)


@pytest.mark.parametrize("d,dv,max_dis,ok", [
    (128, 1024, 7, True),     # DeAOT's short-term attention at h=1
    (32, 32, 7, True),        # AOT's
    (512, 1024, 7, True),
    (513, 32, 7, False),
    (128, 1025, 7, False),
    (32, 32, 8, False),
])
def test_local_kernel_shape_rule(d, dv, max_dis, ok):
    assert (lwa.shape_error(d, dv, max_dis) is None) is ok


@pytest.mark.parametrize("d,dv,ok", [
    (128, 1024, True),        # DeAOTL's long-term attention at h=1
    (32, 32, True),           # the AOT heads
    (256, 4, True),
    (260, 32, False),
    (30, 32, False),
    (32, 30, False),
])
def test_flash_kernel_shape_rule(d, dv, ok):
    assert (fa.shape_error(d, dv) is None) is ok
