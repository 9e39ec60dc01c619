"""bf16 training (TRAIN_DTYPE='bfloat16', the configs' default) in the port
against aot_tpu's on the CPU: the flash backward's bf16 plain version
against aot_tpu's flash_attention VJP in interpret mode at bf16 (as
tests/test_torch_port_flash_bwd.py runs it at fp32), the training window
form of local attention against aot_tpu's local_attention_window, and one
training step of AOTT at bf16 from the same weights (the helpers and setup
of tests/test_torch_port_train_deaot.py, which holds DeAOTT's bf16 step to
the same tolerances: 49x49, B = 2, T = 3, an LT write every frame, dropout
off): the engine forward, every gradient leaf, the grad norm, the updated
parameters and the EMA. Also the CLI training 2 steps at its default
dtype, bf16.

Tolerances, relative to the largest entry of the JAX result: 2e-2 for the
backward's gradients and 1e-2 for the window form's output (bf16 keeps 8
significand bits; the plain backward rounds P and dS where the kernel does,
the JAX-CPU oracle's dense path where XLA's autodiff does). For a step:
loss and grad norm within 2e-2 relative, masks equal on >= 99% of the
pixels, parameters and EMA after the step within 1e-2 of the leaf's
largest entry plus two LR units (Adam's first update is ~lr sign(g): an
entry whose gradient's sign bf16 decides otherwise moves 2 lr apart, the
whole leaf's scale where it was initialised to zero). Each gradient leaf: its largest error within 5e-2 of its
largest entry, or within twice aot_tpu's own bf16 rounding error on that
leaf (the largest distance of aot_tpu's bf16 gradient from the fp32
gradient of the same weights, which the port's fp32 step gives to 2e-4),
whichever is larger. Measured on DeAOTT: aot_tpu's bf16 gradients lie up
to 21% of a leaf's largest entry from its fp32 ones (17% in L2), and the
port's up to 9.6% from aot_tpu's bf16 ones on 44 of 117 leaves above 5%,
never more than 1.61 times aot_tpu's own error on the leaf: a random-weight
model's gradients pass through ~40 layers rounded at other places in the
two frameworks, and no single tolerance below bf16's own error can hold. A
wrong term moves a leaf by its own size."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.ops import attention as jax_att
from aot_tpu.ops.attention import set_attn_impl
from aot_tpu.ops.pallas.flash_attn_vjp import flash_attention as jax_flash
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab
from test_torch_port_encoders import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_flash_bwd_plan import c_plan
from test_torch_port_train_deaot import (assert_step_close, check_forward,
                                         check_grads, cli_base, run_both)

BF16 = torch.bfloat16
BWD_REL = 2e-2
WINDOW_REL = 1e-2


@pytest.fixture(autouse=True)
def _jax_dense_oracle():
    set_attn_impl("xla")
    yield
    set_attn_impl("auto")


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (both as fp32 numpy)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def bf16_pair(x: np.ndarray):
    """The same bf16 values as a JAX array and a torch leaf."""
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j, np.float32)).to(BF16)
    return j, t.requires_grad_()


# --- the flash backward at bf16 -------------------------------------------


BWD_CASES = {
    # name: (B, Lq, Lk, h, d, dv, valid)
    "aot_heads_partial": (2, 130, 260, 2, 16, 16, [260, 87]),
    "deaot_widths": (1, 70, 150, 1, 128, 96, None),
    "empty_element": (2, 65, 130, 2, 32, 32, [130, 0]),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bf16_plain_bwd_matches_jax_flash_vjp(case):
    """flash_attention_train at bf16 (the plain forward and backward on the
    CPU) against aot_tpu's flash_attention VJP at bf16 in interpret mode:
    out and each of dq, dk, dv (bf16) within BWD_REL of its largest entry;
    dead keys exact zeros."""
    b, lq, lk, h, d, dv, valid = BWD_CASES[case]
    rng = np.random.RandomState(0)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = (
        bf16_pair(rng.randn(b, n, h * c).astype(np.float32))
        for n, c in ((lq, d), (lk, d), (lk, dv), (lq, dv)))
    jvl = None if valid is None else jnp.asarray(valid, jnp.int32)
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, jvl, h, d, block_q=128, block_k=128, interpret=True),
        jq, jk, jv)
    want = vjp(jw)
    tvl = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    got = fa.flash_attention_train(tq, tk, tv, tvl, h, d)
    got.backward(tw.detach())
    assert got.dtype == BF16
    assert rel_err(got, out) <= BWD_REL
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        assert t.grad.dtype == BF16
        err = rel_err(t.grad, w)
        assert err <= BWD_REL, (f"d{name}", err)
    if valid is not None:                   # dead keys: exact zeros
        for i, n in enumerate(valid):
            assert not tk.grad[i, n:].any() and not tv.grad[i, n:].any()


@pytest.mark.parametrize("b,lq,lk,h,d,dv,slab,sums", [
    (16, 900, 2700, 1, 128, 1024, 1024, False),  # DeAOT's LT read: one slab
    (16, 900, 900, 1, 128, 1024, 1024, False),   # the GPM self-attention
    (1, 7232, 14464, 1, 128, 1024, 4608, True),  # 1080p: two slabs
    (16, 900, 900, 8, 32, 32, 0, False),         # AOTT: nothing kept
])
def test_bf16_backward_scratch_rule(b, lq, lk, h, d, dv, slab, sums):
    """At bf16 the backward keeps P^T, dS^T and dS in bf16 (one copy each,
    the fp32 form a hi and a lo copy; the same slabs), and over more than
    one slab the fp32 sums of dV and dK (csrc/flash_attn_bwd.cu)."""
    kept = b * h * slab * (-(-lk // 128) * 128)
    plan = c_plan(b, lq, lk, h, d, dv, BF16)
    assert c_plan(b, lq, lk, h, d, dv)["SLAB"] == plan["SLAB"] == slab
    assert (plan["ACC"] >= 0) == sums
    for name in ("PT", "DST", "DS"):
        hi, lo, rows, cols = plan[name]
        assert lo == -1 and rows * cols * b * h == kept
    if slab:
        assert plan["PT"][2:] == (-(-lk // 128) * 128, slab)


# --- the training window form of local attention --------------------------


@pytest.mark.parametrize("dtype,rel_v,dilation", [
    ("float32", True, 1), ("bfloat16", True, 1), ("bfloat16", False, 2)])
def test_window_form_matches_jax(dtype, rel_v, dilation):
    """ops.attention.local_attention_window against aot_tpu's
    local_attention_window (the training formulation) on the same inputs:
    the output at fp32 within 1e-5 and its gradients within 1e-4 of their
    largest entry, at bf16 within WINDOW_REL (fp32 scores and softmax, P in
    bf16, fp32 sums, bf16 out on both sides)."""
    b, hgt, wid, h, d, dv, md = 2, 7, 9, 2, 8, 16, 3
    win2 = (2 * md + 1) ** 2
    rng = np.random.RandomState(1)
    x = [rng.randn(b, hgt * wid, h * c).astype(np.float32) for c in (d, d, dv)]
    rb = (0.3 * rng.randn(b, h, hgt * wid, win2)).astype(np.float32)
    rv = (0.3 * rng.randn(h, dv, win2)).astype(np.float32) if rel_v else None
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=md, dilation=dilation,
              d_att=d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jfn(q, k, v):
        out = jax_att.local_attention_window(
            q, k, v, jnp.asarray(rb), None if rv is None else jnp.asarray(rv),
            **kw)
        return out, out.astype(jnp.float32).sum()

    jx = [jnp.asarray(a, jdt) for a in x]
    want = jfn(*jx)[0]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          .requires_grad_() for a in jx]
    got = att.local_attention_window(
        *tx, torch.from_numpy(rb), None if rv is None else torch.from_numpy(rv),
        **kw)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        assert rel_err(got, want) <= WINDOW_REL
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    jgrads = jax.grad(lambda *a: jfn(*a)[1], argnums=(0, 1, 2))(*jx)
    got.sum().backward()
    for t, w in zip(tx, jgrads):
        assert rel_err(t.grad, w) <= 1e-4


# --- AOTT: one bf16 step against aot_tpu -----------------------------------


@pytest.fixture(scope="module")
def bf16_step():
    return run_both("aott", "bfloat16", TRAIN_LONG_TERM_MEM_GAP=1)


def test_bf16_train_engine_forward_matches_jax(bf16_step):
    cfg, want, got, _, _ = bf16_step
    check_forward(cfg, want, got, bf16=True)


def test_bf16_gradients_match_jax_leaf_by_leaf(bf16_step):
    _, want, got, _, exact = bf16_step
    check_grads(want, got, exact)


def test_bf16_train_step_matches_jax(bf16_step):
    cfg, want, got, init, _ = bf16_step
    assert_step_close(cfg, want, got, init, bf16=True)


def test_cli_trains_at_the_default_bf16(tmp_path, capsys):
    """`python -m aot_tpu_torch.train` without --fp32 trains AOTT 2 steps
    in the config's TRAIN_DTYPE, bfloat16, on the synthetic fixture."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.train.__main__ import main
    from aot_tpu_torch.utils import checkpoint as ckpt

    main(cli_base(tmp_path) + ["--model", "aott", "--exp_name", "cli"])
    out = capsys.readouterr().out
    assert "AOTT on cpu, bfloat16" in out and "step 2/2" in out
    cfg = build_config(stage="pre_ytb_dav", model="aott", exp_name="cli",
                       DIR_ROOT=str(tmp_path))
    raw = ckpt.load_checkpoint(ckpt.latest_checkpoint(cfg.DIR_CKPT))
    assert raw["step"] == 2
    assert all(v.dtype == torch.float32 for k, v in raw["model"].items()
               if v.is_floating_point())
