"""bf16 serving (TEST_DTYPE='bfloat16', the evaluator's --amp) on the CPU:
each primitive of the compute-dtype policy against its aot_tpu function at
bf16, the plain versions of the two kernels against the Pallas kernels in
interpret mode at bf16, every encoder at reduced depth against its flax
encoder at bf16, and AOTT and DeAOTL through both engines at bf16 from the
same state; plus the dtype-aware flash switch and the refusals.

Inputs and weights are seeded numpy (the weights through export_state_dict
or each module's reference layout). Tolerances, measured against the
largest entry of the JAX result: 1e-2 for a primitive or a kernel's plain
version (bf16 keeps 8 significand bits: each rounding is up to 2^-9
relative, and the two frameworks round at other places: torch adds a
Linear's or a convolution's bias before its output is rounded, XLA after);
2e-2 for an encoder, a stack of 20-60 such layers (measured: 0.4-1.4e-2,
the largest Swin's); for a whole model over two steps, grid logits within
3e-2 of the largest live logit, and masks equal on >= 99% of the pixels
whose decision bf16 cannot flip: those where aot_tpu's own top-2 logit
margin exceeds twice that tolerance (a bilinear upsample keeps the bound).
At the seeded weights of these tests aot_tpu's bf16 masks agree with its
own fp32 masks on only 97.4% of DeAOTL's pixels at the second step (median
top-2 margin 0.17 on logits of 2.4): near ties that bf16 rounding decides
either way, in either package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine import build_infer_engine as jax_build_infer_engine
from aot_tpu.models import layers as JL
from aot_tpu.models.encoders import common as jcommon
from aot_tpu.models.encoders import mobilenetv2 as jmnv2
from aot_tpu.ops import attention as jax_att
from aot_tpu.ops.pallas.flash_attn_vjp import flash_attention as jax_flash
from aot_tpu.ops.pallas.local_window_attn import local_window_attention_flat
from aot_tpu.utils import torch_import as TI
from aot_tpu_torch.configs import build_config as port_build_config
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.engine import state as S
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.models import layers as L
from aot_tpu_torch.models.encoders import common, mobilenetv2
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import local_window_attn as lwa
from test_torch_port_encoders import (  # noqa: F401 (autouse)
    ENCODERS, jax_encoder_params, one_torch_thread, to_reference)
from test_torch_port_variants import jax_variant, port_variant

BF16 = torch.bfloat16
PRIM_REL = 1e-2
ENCODER_REL = 2e-2
MODEL_REL = 3e-2
MASK_AGREE = 0.99
SIZE = 129                # a 9 x 9 token grid


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (both as fp32 numpy)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def bf16_pair(x: np.ndarray):
    """The same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(BF16)


# --- primitives ------------------------------------------------------------


def test_linear_bf16():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 50, 96).astype(np.float32)
    jx, tx = bf16_pair(x)
    mod = JL.Linear(64, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(0), jx)["params"]
    want = mod.apply({"params": params}, jx)
    lin = L.Linear(96, 64)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        lin.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    got = lin(tx)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert lin.weight.dtype == torch.float32
    assert rel_err(got, want) <= PRIM_REL


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_norms_compute_in_fp32_bf16(norm):
    rng = np.random.RandomState(1)
    x = (3 + 2 * rng.randn(2, 40, 64)).astype(np.float32)
    jx, tx = bf16_pair(x)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    if norm == "group":
        mod, tmod = JL.GroupNorm(8), L.GroupNorm(8, 64)
    else:
        mod, tmod = JL.LayerNorm(), L.LayerNorm(64)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w))
        tmod.bias.copy_(torch.from_numpy(b))
        got = L.group_norm_seq(tmod, tx) if norm == "group" else tmod(tx)
    params = {f"{type(mod).__name__}_0": {"scale": w, "bias": b}}
    want = mod.apply({"params": params}, jx)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert rel_err(got, want) <= PRIM_REL


def test_frozen_bn_bf16():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 9, 16).astype(np.float32)
    jx, _ = bf16_pair(x)
    stats = {"weight": rng.uniform(0.5, 1.5, 16), "bias": rng.randn(16),
             "running_mean": rng.randn(16),
             "running_var": rng.uniform(0.5, 1.5, 16)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    want = jcommon.FrozenBatchNorm(16, dtype=jnp.bfloat16).apply(
        {"params": stats}, jx)
    bn = common.FrozenBatchNorm2d(16)
    for k, v in stats.items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    got = bn(bf16_pair(x.transpose(0, 3, 1, 2))[1]).permute(0, 2, 3, 1)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert rel_err(got, want) <= PRIM_REL


@pytest.mark.parametrize("valid", [None, 300, "rows"])
def test_dense_global_attention_bf16(valid):
    """The dense path (below the flash switch): fp32 scores and softmax, P
    in bf16, fp32 sums, bf16 out."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, n, 64).astype(np.float32)
               for n in (50, 400, 400))
    (jq, tq), (jk, tk), (jv, tv) = bf16_pair(q), bf16_pair(k), bf16_pair(v)
    vl = {None: (None, None), 300: (300, 300),
          "rows": (jnp.asarray([400, 250]), torch.tensor([400, 250]))}[valid]
    want = jax_att.global_attention(jq, jk, jv, 4, valid_len=vl[0])
    got = att.global_attention(tq, tk, tv, 4, valid_len=vl[1])
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert rel_err(got, want) <= PRIM_REL


@pytest.mark.parametrize("head", ["aot", "deaot"])
def test_local_plain_matches_flat_kernel_bf16(head):
    """The plain local version against local_window_attention_flat in
    interpret mode at bf16: q, k, v widened, fp32 inside, bf16 out; the
    AOT head with rel_v, a DeAOT-like head (d = 16, dv = 64) without."""
    h, d, dv, rv = (2, 8, 8, True) if head == "aot" else (1, 16, 64, False)
    hgt, wid, m = 9, 11, 3
    rng = np.random.RandomState(4)
    hw, win2 = hgt * wid, (2 * m + 1) ** 2
    q, k = (rng.randn(2, hw, h * d).astype(np.float32) for _ in range(2))
    v = rng.randn(2, hw, h * dv).astype(np.float32)
    rb = (0.3 * rng.randn(2, h, hw, win2)).astype(np.float32)
    rel_v = (0.3 * rng.randn(h, dv, win2)).astype(np.float32) if rv else None
    (jq, tq), (jk, tk), (jv, tv) = bf16_pair(q), bf16_pair(k), bf16_pair(v)
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=m, d_att=d)
    want = local_window_attention_flat(
        jq, jk, jv, jnp.asarray(rb), None if rel_v is None
        else jnp.asarray(rel_v), **kw, interpret=True)
    got = lwa.local_window_attention_plain(
        tq, tk, tv, torch.from_numpy(rb),
        None if rel_v is None else torch.from_numpy(rel_v), **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert rel_err(got, want) <= PRIM_REL


@pytest.mark.parametrize("dv", [32, 160])
def test_flash_plain_matches_pallas_bf16(dv):
    """The plain flash version against flash_attention in interpret mode at
    bf16 (tests/test_flash_vjp.py:60-75), over live-length masked keys:
    fp32 scores, P in bf16, fp32 sums; dv = 160 is a two-pass width on the
    card."""
    rng = np.random.RandomState(5)
    h, d = 2, 16
    q = rng.randn(2, 100, h * d).astype(np.float32)
    k = rng.randn(2, 300, h * d).astype(np.float32)
    v = rng.randn(2, 300, h * dv).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = bf16_pair(q), bf16_pair(k), bf16_pair(v)
    want = jax_flash(jq, jk, jv, jnp.asarray([300, 170]), h, d, block_q=128,
                     block_k=128, interpret=True)
    got, lse = fa.flash_attention_plain(tq, tk, tv, torch.tensor([300, 170]),
                                        h, d)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert lse.dtype == torch.float32
    assert rel_err(got, want) <= PRIM_REL


# --- the flash switch and the refusals ------------------------------------------


def test_use_flash_threshold_follows_dtype():
    """An 8-frame LT ring of 900-token frames (7,200 live keys): flash at
    bf16 (the JAX package's 4,096), dense at fp32 (8,192)."""
    assert att.use_flash(7200, 7200, -1, -1.0, BF16)
    assert not att.use_flash(7200, 7200, -1, -1.0, torch.float32)
    assert not att.use_flash(4095, 4095, -1, -1.0, BF16)
    assert att.use_flash(8192, 8192, -1, -1.0, torch.float32)
    assert not att.use_flash(7200, None, -1, -1.0, BF16)
    assert (att.FLASH_MIN_KEYS_BF16, att.FLASH_MIN_KEYS) == (
        jax_att._FLASH_MIN_KEYS_BF16, jax_att._FLASH_MIN_KEYS_FP32)


def test_bf16_training_refused():
    """What the training dtypes take and refuse: the flash path trains at
    bf16 (bf16 out, bf16 gradients), TRAIN_DTYPE bfloat16 builds a bf16
    model with fp32 parameters, and a dtype that is neither float32 nor
    bfloat16 is refused."""
    q = torch.randn(1, 4, 8, dtype=BF16, requires_grad=True)
    out = fa.flash_attention_train(q, q, q, None, 1)
    out.float().sum().backward()
    assert out.dtype == BF16 and q.grad.dtype == BF16
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            TRAIN_DTYPE="bfloat16")
    model = build_vos_model(cfg, device="cpu", train=True)
    assert model.compute_dtype == BF16 and model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            TRAIN_DTYPE="float16")
    with pytest.raises(NotImplementedError, match="TRAIN_DTYPE"):
        build_vos_model(cfg, device="cpu", train=True)
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            TEST_DTYPE="bfloat16")
    model = build_vos_model(cfg, device="cpu")
    assert model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())


# --- encoders -------------------------------------------------------------------

BF16_ENCODERS = dict(ENCODERS, mobilenetv2=(
    jmnv2.MobileNetV2, mobilenetv2.MobileNetV2, TI._mobilenetv2_rules, 65))


@pytest.mark.parametrize("name", list(BF16_ENCODERS))
@torch.inference_mode()
def test_encoder_matches_flax_bf16(name):
    """Each encoder at reduced depth (tests/test_torch_port_encoders.py's
    shapes; MobileNetV2 whole) at bf16 against its flax encoder at bf16."""
    make_j, make_p, rules, size = BF16_ENCODERS[name]
    jmodel = make_j().clone(dtype=jnp.bfloat16)
    model = make_p()
    flat, params = jax_encoder_params(make_j(), size)
    sd = to_reference(flat, rules())
    model.load_state_dict({k[len("encoder."):]: torch.from_numpy(v)
                           for k, v in sd.items()}, strict=True)
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    jx, tx = bf16_pair(x)
    want = jax.jit(jmodel.apply)({"params": params}, jx)
    got = model(tx.permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        assert rel_err(g.permute(0, 2, 3, 1), w) <= ENCODER_REL, name


# --- whole models ----------------------------------------------------------------


def _port_state(js) -> S.EngineState:
    """The port's EngineState of a JAX one, bf16 leaves kept bf16."""
    def t(x):
        a = np.asarray(x)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(BF16)
        return torch.from_numpy(np.array(a))

    mem = lambda layers: [{k: t(v) for k, v in layer.items()
                           if v is not None} for layer in layers]
    return S.EngineState(
        lt=mem(js.lt), lt_count=[int(c) for c in np.asarray(js.lt_count)],
        st=mem(js.st), st_ptr=int(js.st_ptr), st_count=int(js.st_count),
        curr=mem(js.curr), embs=[t(e) for e in js.embs],
        shortcuts=[t(np.asarray(s).transpose(0, 3, 1, 2))
                   for s in js.shortcuts],
        frame_step=int(js.frame_step), last_mem_step=int(js.last_mem_step),
        obj_nums=t(js.obj_nums).long())


@pytest.mark.parametrize("variant", ["aott", "deaotl"])
def test_model_matches_jax_bf16(variant):
    """The reference frame through aot_tpu at bf16, its state into the
    port, then two steps on each side (LT gap 1: the second step reads two
    LT frames): grid logits within 3e-2 of the largest live logit, masks
    >= 99%."""
    objects = 6
    cfg = build_config(stage="pre_ytb_dav", model=variant,
                       TEST_DTYPE="bfloat16", TEST_LONG_TERM_MEM_GAP=1,
                       TEST_LONG_TERM_MEM_CAP=4)
    jmodel, params = jax_variant(cfg)
    model, _ = port_variant(cfg, params)
    assert model.compute_dtype == BF16
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    rng = np.random.RandomState(9)
    imgs = rng.randn(3, 1, SIZE, SIZE, 3).astype(np.float32)
    mask = np.zeros((1, SIZE, SIZE), np.int32)
    for i in range(1, objects + 1):
        y, x = rng.randint(0, SIZE - 30, 2)
        mask[0, y:y + 30, x:x + 30] = i
    js = jax.jit(lambda p, i, m: jeng.add_reference_frame(
        p, i, m, obj_num=objects))(params, jnp.asarray(imgs[0]),
                                   jnp.asarray(mask))
    assert js.lt[0]["k"].dtype == jnp.bfloat16
    ps = _port_state(js)
    jstep = jax.jit(lambda p, s, i: jeng.step(p, s, i,
                                              output_size=(SIZE, SIZE)))
    for t in (1, 2):
        js = jeng.ensure_lt_capacity(js, t + 1)
        ps = eng.ensure_lt_capacity(ps, t + 1)
        js, jpred, jlog = jstep(params, js, jnp.asarray(imgs[t]))
        ps, pred, logits = eng.step(ps, torch.from_numpy(imgs[t]),
                                    (SIZE, SIZE))
        assert logits.dtype == torch.float32
        assert ps.lt[0]["k"].dtype == BF16
        want = np.asarray(jlog)[..., :objects + 1]
        err = rel_err(logits[..., :objects + 1], want)
        assert err <= MODEL_REL, (variant, t, err)
        # the pixels whose argmax a logit error within the tolerance
        # cannot flip
        up = torch.nn.functional.interpolate(
            torch.from_numpy(want).permute(0, 3, 1, 2), size=(SIZE, SIZE),
            mode="bilinear", align_corners=True)
        top2 = up.topk(2, dim=1).values
        decided = ((top2[:, 0] - top2[:, 1])
                   > 2 * MODEL_REL * np.abs(want).max()).numpy()
        same = pred.numpy() == np.asarray(jpred)
        assert decided.mean() >= 0.25, (variant, t, decided.mean())
        assert same[decided].mean() >= MASK_AGREE, (
            variant, t, same[decided].mean(), same.mean())
    assert ps.lt_count == [3]
