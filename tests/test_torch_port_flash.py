"""The port's flash-attention forward (plain version, the CPU path of
ops/kernels/flash_attn.py) against aot_tpu's flash kernel in interpret mode
(out and log-sum-exp, as tests/test_flash_vjp.py runs it) and against the
dense global_attention oracle, on seeded numpy inputs; the dispatch rule
that sends a long live memory to it; and the shape rules of both kernel
wrappers.

The CUDA kernels run only on the card; chip_smoke.py holds them against
these plain versions there. Tolerance 1e-5: fp32, only the summation order
differs."""

import ctypes
import ctypes.util
import math

import numpy as np
import pytest
import torch

import jax
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


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))


def _process_state() -> str:
    """The process-wide settings that could move these comparisons, for a
    failure's message: this thread's rounding mode (fegetround; 0 is to
    nearest) and its MXCSR (byte 28 of x86-64 glibc's fenv_t; FTZ 0x8000,
    DAZ 0x40), JAX's default matmul precision and torch's intra-op
    threads."""
    env = (ctypes.c_uint32 * 8)()
    _LIBM.fegetenv(env)
    return (f"rounding mode {_LIBM.fegetround()}, mxcsr {env[7]:#06x}, "
            f"jax_default_matmul_precision "
            f"{jax.config.jax_default_matmul_precision}, torch threads "
            f"{torch.get_num_threads()}")


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
    try:
        np.testing.assert_allclose(out.numpy(), np.asarray(kernel),
                                   err_msg="out vs the JAX kernel", **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(dense),
                                   err_msg="out vs the dense oracle", **TOL)
        np.testing.assert_allclose(
            lse.numpy(), _jax_kernel_lse(q, k, v, valid, h, d),
            err_msg="lse vs the JAX kernel", **TOL)
    except AssertionError as e:
        raise AssertionError(f"{e}\nprocess state: {_process_state()}"
                             ) from None


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the float32 bits: 10 mantissa bits, to nearest,
    ties away from zero (add half of the 13 dropped bits' range to the
    magnitude, then clear them), as csrc/tf32x3.cuh rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, rounded toward zero: how the tensor core writes its
    fp32 accumulator after each mma.sync."""
    x32 = x.float()
    over = x32.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def _mma(a, b, acc=None, products=3, small=None):
    """acc + a @ b as a chain of m16n8k8 mma.sync steps, as the flash kernels
    issue them: each operand split into TF32 hi and lo, and for every 8-wide
    slice of the summation index the products a_lo b_hi, a_hi b_lo, a_hi b_hi
    (products=3; a_hi b_hi alone for products=1) each added exactly to the
    accumulator, which is then rounded toward zero to fp32. With `small`
    (an accumulator), the two small products go there (tf32x3::mma3_apart);
    returns (acc, small)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    if acc is None:
        acc = torch.zeros(a.shape[0], b.shape[1])
    terms = ([(a_lo, b_hi, True), (a_hi, b_lo, True)] if products == 3
             else []) + [(a_hi, b_hi, False)]
    for k0 in range(0, a.shape[1], 8):
        for x, y, is_small in terms:
            xy = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
            if is_small and small is not None:
                small = _round_toward_zero(small.double() + xy)
            else:
                acc = _round_toward_zero(acc.double() + xy)
    return acc, small


def _mm_3xtf32(a, b):
    """a @ b in 3xTF32 with the large term apart, as the kernels compute
    the scores at d > 32: big + small added once in fp32."""
    big, small = _mma(a, b, small=torch.zeros(a.shape[0], b.shape[1]))
    return big + small


def _mm_tf32(a, b):
    return _mma(a, b, products=1)[0]


def _tiled_forward(q, k, v, mm, tile=64):
    """The kernel's forward for one head: online softmax over key tiles,
    each tile's P V (its own mma accumulator) and row sum folded once in
    fp32, acc = acc * alpha + pv."""
    scale = 1.0 / math.sqrt(q.shape[1])
    m = torch.full((q.shape[0], 1), fa.NEG_INF)
    l = torch.zeros(q.shape[0], 1)
    acc = torch.zeros(q.shape[0], v.shape[1])
    for k0 in range(0, k.shape[0], tile):
        s = mm(q, k[k0:k0 + tile].T) * scale
        m_new = torch.maximum(m, s.amax(1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        acc = acc * alpha + mm(p, v[k0:k0 + tile])
        m = m_new
    return acc / l, (m + torch.log(l))[:, 0]


@pytest.mark.parametrize("q_scale,one_pass_holds", [
    (1e-3, True),   # near-flat: every weight ~1/Lk
    (2.0, False),   # sharp: a few keys carry each row
])
def test_three_tf32_products_hold_the_fp32_gate(q_scale, one_pass_holds):
    """Why the flash kernels take three TF32 products a product: against an
    fp64 reference (Lq=64, Lk=4,096, d=128, dv=64), 3xTF32 with per-tile
    folding, the accumulator rounded toward zero after every mma, stays 10x
    inside the 1e-4 gate of chip_smoke.py phase 2 (1.0e-6 near-flat,
    2.6e-6 sharp), as an fp32 forward does. One TF32 pass keeps ~3 digits
    of each score: on a near-flat softmax its error (1.5e-5) still holds
    the gate, though over 10 times the three-product error; where the
    softmax is sharp its score errors move the weights and it fails the
    gate (8.8e-4)."""
    rng = np.random.RandomState(7)
    q = torch.tensor(q_scale * rng.randn(64, 128), dtype=torch.float32)
    k = torch.tensor(rng.randn(4096, 128), dtype=torch.float32)
    v = torch.tensor(rng.randn(4096, 64), dtype=torch.float32)
    s = q.double() @ k.double().T / math.sqrt(128)
    want_out, want_lse = torch.softmax(s, 1) @ v.double(), torch.logsumexp(s, 1)

    def err(mm):
        out, lse = _tiled_forward(q, k, v, mm)
        return max((out.double() - want_out).abs().max().item(),
                   (lse.double() - want_lse).abs().max().item())

    three, one = err(_mm_3xtf32), err(_mm_tf32)
    assert three <= 1e-5
    assert one > 10 * three
    assert (one <= 1e-4) is one_pass_holds


def test_long_sums_are_folded_per_tile():
    """Why the backward folds dQ once per key tile: dQ = dS K sums over
    every live key (here 19,800, DeAOTL's longest memory). Straight into
    one mma accumulator that is ~7,400 roundings toward zero, all one way:
    2.0e-4 of the largest entry, twice the 1e-4 gate of chip_smoke.py
    phase 8. Each 32-key tile summed in its own accumulator and added in
    fp32 (csrc/flash_attn_bwd.cu): 9.2e-7."""
    rng = np.random.RandomState(3)
    lk, tile = 19800, 32
    ds = torch.tensor(rng.randn(16, lk) / lk, dtype=torch.float32)
    k = torch.tensor(rng.randn(lk, 128), dtype=torch.float32)
    want = ds.double() @ k.double()
    straight = _mma(ds, k)[0]
    folded = torch.zeros(16, 128)
    for k0 in range(0, lk, tile):
        folded = folded + _mma(ds[:, k0:k0 + tile], k[k0:k0 + tile])[0]
    scale = want.abs().max().item()
    err_straight = (straight.double() - want).abs().max().item() / scale
    err_folded = (folded.double() - want).abs().max().item() / scale
    assert err_folded <= 1e-5
    assert err_straight > 1e-4


@pytest.mark.parametrize("b,lq,lk,h,dv,splits,score_splits,slab", [
    (1, 900, 19800, 1, 1024, 2, 17, 960),  # one DeAOTL video: two passes
    (2, 900, 14400, 1, 1024, 1, 8, 960),   # 240 output blocks
    (4, 900, 19800, 1, 1024, 1, 5, 832),   # 285 MB of scores: two slabs
    (1, 7232, 14464, 1, 1024, 1, 3, 4608),  # DAVIS 1080p: two slabs
    (1, 900, 4000, 1, 32, 17, 0, 0),       # 15 blocks
    (1, 100, 64, 1, 32, 1, 0, 0),          # one key tile
    (16, 900, 900, 8, 32, 1, 0, 0),        # AOTT training: 1,920 blocks
])
def test_forward_plan(b, lq, lk, h, dv, splits, score_splits, slab):
    """The forward's key splits, query slabs and scratch on a card of 132
    multiprocessors: the splits bring a small grid toward the blocks the
    card holds at once, never past them; two passes keep a slab's scores,
    at most 256 MB."""
    got = fa.fwd_plan(b, lq, lk, h, dv, 132)
    assert got[:3] == (splits, score_splits, slab)
    lds = -(-lk // 32) * 32
    if score_splits:
        assert b * h * slab * lds <= fa.SLAB_FLOATS
        assert got[3] == (b * h * slab * lds + 2 * score_splits * b * h * lq
                          + (splits * b * lq * h * dv if splits > 1 else 0))
    else:
        assert got[3] == (splits * (b * lq * h * dv + b * h * lq)
                          if splits > 1 else 0)


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
