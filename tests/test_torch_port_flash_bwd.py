"""The port's flash-attention backward on the CPU: the plain version
(ops/kernels/flash_attn_bwd.py) and the autograd Function around both plain
versions (ops/kernels/flash_attn.py `flash_attention_train`), held

  - against the gradients of aot_tpu's flash_attention custom VJP in
    interpret mode, as tests/test_flash_vjp.py runs it (rtol = atol = 5e-4,
    that test's tolerance);
  - against torch autograd through the plain forward (1e-4: fp32, the two
    sum in another order, over up to 260 keys).

Seeded numpy inputs; ragged tiles (no length a multiple of 64), a partial
(B,) and an int live length, and a row with no live key. The CUDA kernels
run only on the card, where chip_smoke.py holds them against this plain
version. Also: the forward-only CUDA local-window wrapper refuses inputs
that require grad, and training dispatch sends every global attention to
the Function and local attention to the window form."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.ops.attention import set_attn_impl
from aot_tpu.ops.pallas.flash_attn_vjp import flash_attention as jax_flash
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
from aot_tpu_torch.ops.kernels import local_window_attn as lwa
from test_torch_port_flash_bwd_plan import c_plan

JAX_TOL = dict(rtol=5e-4, atol=5e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_dense_oracle():
    set_attn_impl("xla")
    yield
    set_attn_impl("auto")


def _mk(b, lq, lk, h, d, dv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h * d).astype(np.float32),
            rng.randn(b, lk, h * d).astype(np.float32),
            rng.randn(b, lk, h * dv).astype(np.float32),
            rng.randn(b, lq, h * dv).astype(np.float32))


def _torch_valid(valid):
    if valid is None or isinstance(valid, int):
        return valid
    return torch.tensor(valid, dtype=torch.int32)


def _port_grads(q, k, v, w, valid, h, d):
    """Gradients of sum(out * w) through flash_attention_train."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention_train(tq, tk, tv, _torch_valid(valid), h, d)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("valid", [None, "partial"])
def test_grads_match_jax_flash_vjp(valid):
    b, lq, lk, h, d, dv = 2, 130, 260, 2, 16, 16
    q, k, v, w = _mk(b, lq, lk, h, d, dv)
    vl = None if valid is None else [lk, lk // 3]
    jvl = None if vl is None else jnp.asarray(vl, jnp.int32)

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, jvl, h, d, block_q=128, block_k=128,
                        interpret=True)
        return (out * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, got = _port_grads(q, k, v, w, vl, h, d)
    for name, a, b_ in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b_), **JAX_TOL,
                                   err_msg=f"d{name}")


CASES = {
    # name: (B, Lq, Lk, h, d, dv, valid)
    "all_live": (2, 70, 75, 2, 16, 8, None),
    "partial_b": (2, 70, 150, 2, 16, 24, [150, 61]),
    "int_valid": (1, 33, 90, 4, 8, 8, 50),
    "aot_heads": (1, 65, 65, 8, 32, 32, None),
    "deaot_widths": (1, 40, 70, 1, 128, 96, [44]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_autograd(case):
    b, lq, lk, h, d, dv, valid = CASES[case]
    q, k, v, w = _mk(b, lq, lk, h, d, dv, seed=1)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fa.flash_attention_plain(tq, tk, tv, _torch_valid(valid), h, d)
    (out * torch.from_numpy(w)).sum().backward()
    with torch.no_grad():
        got = fab.flash_attention_bwd_plain(
            tq, tk, tv, _torch_valid(valid), out, lse, torch.from_numpy(w), h,
            d)
    for name, a, t in zip("qkv", got, (tq, tk, tv)):
        assert a.shape == t.shape
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), **TOL,
                                   err_msg=f"d{name}")
    if valid is not None:   # dead keys: exact zeros
        live = valid if isinstance(valid, int) else valid[0]
        assert not got[1][0, live:].any() and not got[2][0, live:].any()


def test_empty_row_gives_zero_grads():
    b, lq, lk, h, d, dv = 2, 70, 75, 2, 16, 16
    q, k, v, w = _mk(b, lq, lk, h, d, dv, seed=2)
    out, grads = _port_grads(q, k, v, w, [75, 0], h, d)
    assert not out[1].any()
    for g in grads:
        assert np.isfinite(g).all()
        assert not g[1].any()
    assert np.abs(grads[0][0]).max() > 0


def test_training_dispatch_routes():
    """In the training context a short memory still takes the Function
    (backward counted by neither kernel on the CPU), and local attention
    gives gradients through the window form."""
    q, k, v, w = _mk(1, 17 * 17, 17 * 17, 8, 4, 4, seed=3)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = (fa.LAUNCHES, fab.LAUNCHES, lwa.LAUNCHES)
    assert not att.use_flash(289, None, -1, -1.0)
    with att.attn_training_context():
        assert att.use_flash(289, None, -1, -1.0)
        out = att.global_attention(tq, tk, tv, 8, 4)
        assert out.grad_fn.name().endswith("FlashAttentionBackward")
        rel = torch.zeros(1, 8, 289, 225, requires_grad=True)
        loc = att.local_attention(tq, tk, tv, rel, None, num_heads=8,
                                  size_2d=(17, 17), max_dis=7, d_att=4)
        ((out + loc) * torch.from_numpy(w)).sum().backward()
    assert not att.in_training()
    assert (fa.LAUNCHES, fab.LAUNCHES, lwa.LAUNCHES) == before
    assert rel.grad is not None and tq.grad is not None


def test_local_kernel_refuses_inputs_that_require_grad():
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(1, 25, 8).astype(np.float32))
               for _ in range(3))
    rel = torch.zeros(1, 1, 25, 225, requires_grad=True)
    kw = dict(num_heads=1, size_2d=(5, 5), max_dis=7)
    with pytest.raises(RuntimeError, match="requires grad"):
        lwa.local_window_attention_cuda(q, k, v, rel, None, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="is on cpu"):
        lwa.local_window_attention_cuda(q, k, v, rel, None, **kw)


def test_bwd_wrapper_refuses_non_cuda_tensors():
    q, k, v, w = _mk(1, 8, 8, 1, 8, 8)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = fa.flash_attention_plain(*t, None, 1, 8)
    with pytest.raises(ValueError, match="is on cpu"):
        fab.flash_attention_bwd_cuda(*t, None, out, lse,
                                     torch.from_numpy(w), 1, 8)


@pytest.mark.parametrize("b,lq,lk,h,dv,slab", [
    (1, 900, 19800, 1, 1024, 1024),   # DeAOTL's LT read: one slab
    (2, 900, 14400, 1, 1024, 1024),
    (4, 900, 19800, 1, 1024, 768),    # a kept array above 256 MB: two slabs
    (1, 7232, 14464, 1, 1024, 4608),  # DAVIS 1080p: two slabs
    (2, 300, 1000, 2, 64, 384),       # any dv above 32
    (1, 100, 7, 1, 256, 128),
    (16, 900, 900, 8, 32, 0),         # AOTT training: the one-pass form
])
def test_backward_scratch_rule(b, lq, lk, h, dv, slab):
    """The backward keeps P^T, dS^T and dS of a slab of query rows (a
    multiple of 128) for every value width above 32, each within the slab
    budget, rows of keys padded to 128; at d, dv <= 32 it keeps nothing
    (the plan csrc/flash_attn_bwd_plan.h fills, built here alone)."""
    lkp = -(-lk // 128) * 128
    plan = c_plan(b, lq, lk, h, min(dv, 128), dv)
    assert plan["SLAB"] == slab
    kept = b * h * slab * lkp
    for name in ("PT", "DST", "DS"):
        hi, lo, rows, cols = plan[name]
        assert rows * cols * b * h == kept and lo - hi == 4 * kept
    assert kept <= fa.SLAB_FLOATS
    if dv <= 32:   # the one-pass form needs d <= 32 too
        assert c_plan(b, lq, lk, h, 64, dv)["SLAB"] > 0
