"""The port's DeAOT (DeAOTL: MobileNetV2, three gated-propagation blocks,
h=1, d_att=128, value width 1024) against aot_tpu's on the CPU, with the
same weights: the JAX parameters go through
aot_tpu.utils.torch_import.export_state_dict and load strictly into the
port. Each module is held against its JAX counterpart on the same seeded
numpy inputs, then the model's logits, then the online engine over a clip
with objects arriving mid-video.

257x257 input (17x17 grid) as in tests/test_torch_port_model.py. Modules:
max abs error <= 1e-4 (fp32, only the summation order differs); logits
<= 1e-3 and masks >= 99.9% (about 20 conv layers sum in another order in
XLA-CPU and oneDNN; argmax near-ties may flip a few pixels)."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine import build_infer_engine as jax_build_infer_engine
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.models import layers as JL
from aot_tpu.models import lstt as JT
from aot_tpu.ops.position import sine_position_embedding_seq
from aot_tpu.utils.torch_import import export_state_dict
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.utils.weights import load_reference_state_dict
from test_torch_port_engine import clip
from test_torch_port_model import close, jax_apply, nchw

SIZE = 257
GRID = (17, 17)
HW = 17 * 17
MODULE_TOL = 1e-4
LOGIT_TOL = 1e-3
MASK_AGREE = 0.999
N_KEYS = 399       # DeAOTL's reference state dict


@pytest.fixture(scope="module")
def deaotl():
    cfg = build_config(stage="pre_ytb_dav", model="deaotl")
    jmodel = jax_build_vos_model(cfg, eval_mode=True)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, 11)).at[..., 0].set(1.0)
    params = jax.jit(partial(jmodel.init, deterministic=True))(
        jax.random.PRNGKey(0), img, oh)["params"]
    sd, unmapped = export_state_dict(params, cfg)
    assert not unmapped
    model = build_vos_model(cfg, device="cpu")
    load_reference_state_dict(model, sd)
    return cfg, jmodel, params, model, sd


def test_reference_state_dict_loads_strictly(deaotl):
    _, _, _, model, sd = deaotl
    assert len(sd) == N_KEYS
    assert set(model.state_dict()) == set(sd)
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), sd[key])
    for bad_key, shape in (("LSTT.layers.0.linear_ID_U.bias", (512,)),
                           ("LSTT.layers.1.short_term_attn.relative_emb_v",
                            (1, 512, 225))):
        bad = dict(sd)
        bad[bad_key] = np.zeros(shape, np.float32)   # absent from DeAOT
        with pytest.raises(RuntimeError):
            load_reference_state_dict(model, bad)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


MODULES = ["self_attn", "long_term_attn", "short_term_attn"]


@pytest.mark.parametrize("name", MODULES)
@torch.inference_mode()
def test_gated_propagation_modules(deaotl, name):
    """GatedPropagation (with projections: the blocks' self-attention;
    without: the LT read over a ring with per-sample live lengths) and
    LocalGatedPropagation (the ST read), block 1's weights."""
    _, _, params, model, _ = deaotl
    p = params["lstt"]["block_1"][name]
    port = getattr(model.LSTT.layers[1], name)
    rng = np.random.RandomState(MODULES.index(name))
    b = 2
    if name == "self_attn":
        jmod = JL.GatedPropagation(d_qk=512, d_vu=512, num_heads=1,
                                   d_att=128, use_linear=True)
        x = _rand(rng, b, HW, 512)
        args, kw = (x, x, x, x), {}
    elif name == "long_term_attn":
        jmod = JL.GatedPropagation(d_qk=256, d_vu=512, num_heads=1,
                                   d_att=128, use_linear=False)
        lk = 3 * HW
        args = (_rand(rng, b, HW, 128), _rand(rng, b, lk, 128),
                _rand(rng, b, lk, 1024), _rand(rng, b, HW, 1024))
        kw = dict(valid_len=np.asarray([lk, 2 * HW], np.int32))
    else:
        jmod = JL.LocalGatedPropagation(d_qk=256, d_vu=512, num_heads=1,
                                        d_att=128, use_linear=False)
        args = (_rand(rng, b, HW, 128), _rand(rng, b, HW, 128),
                _rand(rng, b, HW, 1024), _rand(rng, b, HW, 1024))
        kw = {}
    want = jax.jit(lambda pp, *a: jmod.apply(
        {"params": pp}, *a, GRID, **{k: jnp.asarray(v) for k, v in kw.items()}
    ))(p, *args)
    got = port(*(_t(a) for a in args), GRID, **{k: _t(v)
                                                for k, v in kw.items()})
    assert tuple(got.shape) == (b, HW, 512)
    close(got, want, MODULE_TOL)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("mode", ["reference", "propagate"])
@torch.inference_mode()
def test_gated_propagation_module(deaotl, layer, mode):
    """One GPM block: at the reference frame (the identity embedding fused
    into its own memory) and at propagation (LT ring with per-sample live
    lengths, ST memory); layer 0 starts the identity branch, layer 1 carries
    it in. Outputs, both streams, and every memory entry; then the fuse of
    a new identity embedding into the block's id_v."""
    _, _, params, model, _ = deaotl
    jmod = JT.GatedPropagationModule(d_model=256, layer_idx=layer)
    p = params["lstt"][f"block_{layer}"]
    port = model.LSTT.layers[layer]
    rng = np.random.RandomState(10 + layer)
    b = 2
    tgt = _rand(rng, b, HW, 256)
    tgt_id = None if layer == 0 else _rand(rng, b, HW, 256)
    id_emb = _rand(rng, b, HW, 256)
    if mode == "reference":
        lt = st = valid = None
        cur_id = id_emb
    else:
        lt = {"k": _rand(rng, b, 2 * HW, 128), "v": _rand(rng, b, 2 * HW, 512),
              "id_v": _rand(rng, b, 2 * HW, 512)}
        st = {k: v[:, :HW] for k, v in lt.items()}
        valid, cur_id = np.asarray([2 * HW, HW], np.int32), None

    @jax.jit
    def run(pp, tgt_, tgt_id_, lt_, st_, cur_id_, valid_):
        return jmod.apply({"params": pp}, tgt_, tgt_id_, lt_, st_, cur_id_,
                          None, GRID, lt_valid_len=valid_)

    j_tgt, j_id, j_mems = run(p, tgt, tgt_id, lt, st, cur_id, valid)
    mem = lambda m: None if m is None else {k: _t(v) for k, v in m.items()}
    t_tgt, t_id, t_mems = port(_t(tgt), _t(tgt_id), mem(lt), mem(st),
                               _t(cur_id), GRID, lt_valid_len=_t(valid))
    close(t_tgt, j_tgt, MODULE_TOL)
    close(t_id, j_id, MODULE_TOL)
    for kind in ("curr", "global"):
        for key, val in j_mems[kind].items():
            if val is None:       # layer 0's curr has no identity input
                assert key not in t_mems[kind]
            else:
                close(t_mems[kind][key], val, MODULE_TOL)

    j_fused = jax.jit(lambda pp, v, i: jmod.apply(
        {"params": pp}, None, v, i, method=JT.GatedPropagationModule
        .fuse_key_value_id))(p, j_mems["curr"]["id_v"], id_emb)
    t_fused = port.fuse_key_value_id(None, t_mems["curr"].get("id_v"),
                                     _t(id_emb))
    assert set(t_fused) == {"id_v"}
    close(t_fused["id_v"], j_fused["id_v"], MODULE_TOL)


@torch.inference_mode()
def test_model_logits(deaotl):
    """DeAOT's id embedding (id LayerNorm), the dual-branch stack at the
    reference frame and at propagation, fuse_memory and the decoder logits,
    each from the same inputs on both sides."""
    _, jmodel, params, model, _ = deaotl
    M = type(jmodel)
    rng = np.random.RandomState(0)
    imgs = _rand(rng, 2, SIZE, SIZE, 3)
    label = np.zeros((2, SIZE, SIZE), np.int32)
    for i in range(1, 11):
        y, x = rng.randint(0, SIZE - 60, 2)
        label[:, y:y + 60, x:x + 60] = i
    xs = jax_apply(jmodel, params, M.encode_image, imgs)
    id_emb = jax_apply(jmodel, params, M.get_id_emb_label, label)
    close(model.get_id_emb_label(_t(label)), id_emb)
    pos = sine_position_embedding_seq(17, 17, 256)

    @jax.jit
    def j_lstt(p, emb, lt, st, idm, vl):
        return jmodel.apply({"params": p}, emb, lt, st, idm, pos, GRID,
                            lt_valid_len=vl, method=M.lstt_forward)

    def t_lstt(emb, lt, st, idm, vl):
        mem = lambda m: None if m is None else [
            {k: _t(v) for k, v in layer.items()} for layer in m]
        return model.lstt_forward(torch.tensor(nchw(emb)), mem(lt), mem(st),
                                  _t(idm), _t(pos), GRID,
                                  lt_valid_len=_t(vl))

    embs, mems = j_lstt(params, xs[-1], None, None, id_emb, None)
    t_embs, t_mems = t_lstt(xs[-1], None, None, id_emb, None)
    assert len(t_embs) == 3 and tuple(t_embs[-1].shape) == (2, HW, 512)
    close(t_embs[-1], embs[-1])

    # propagation: LT ring of 2 frames, sample 1 has only the first live
    lt = [{k: np.concatenate([np.asarray(v), 0.5 * np.asarray(v)], 1)
           for k, v in m["global"].items()} for m in mems]
    st = [{k: np.asarray(v) for k, v in m["global"].items()} for m in mems]
    valid = np.asarray([2 * HW, HW], np.int32)
    embs2, mems2 = j_lstt(params, xs[-1], lt, st, None, valid)
    t_embs2, t_mems2 = t_lstt(xs[-1], lt, st, None, valid)
    close(t_embs2[-1], embs2[-1])

    # the engine's DeAOT fuse: only the identity branch, from layer 1's
    # identity input
    fused = jax.jit(lambda p, v, i: jmodel.apply(
        {"params": p}, 1, None, v, i, method=M.fuse_memory))(
            params, mems2[1]["curr"]["id_v"], id_emb)
    t_fused = model.fuse_memory(1, None, t_mems2[1]["curr"]["id_v"],
                                _t(id_emb))
    close(t_fused["id_v"], fused["id_v"])

    logits = jax_apply(jmodel, params, M.decode_id_logits, embs2, xs)
    t_logits = model.decode_id_logits(t_embs2, [torch.tensor(nchw(x))
                                                for x in xs])
    assert tuple(t_logits.shape) == (2, 11, 65, 65)
    close(t_logits, nchw(logits))


# 5 objects, then 12 arrive mid-video (a second group with a shorter LT
# memory, so the LT read's valid_len is a (B,) tensor); LT gap 2 with a
# 'grow' ring from 1 frame, grown before each write as the evaluator does
EVENTS = [("ref", 5), "step", "step", ("ref", 12), "step", "step", "step"]


def test_engine_matches_jax_free_running(deaotl):
    _, jmodel, params, model, _ = deaotl
    cfg = build_config(stage="pre_ytb_dav", model="deaotl",
                       TEST_LONG_TERM_MEM_GAP=2, TEST_LONG_TERM_MEM_CAP=1)
    assert cfg.TEST_LONG_TERM_MEM_POLICY == "grow"
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    shadow = eng.make_shadow()
    imgs, full_mask = clip(5, len(EVENTS))
    jstep = jax.jit(lambda p, s, i: jeng.step(p, s, i,
                                              output_size=(SIZE, SIZE)))
    js = ps = None
    for t, ev in enumerate(EVENTS):
        img = imgs[t]
        if ev == "step":
            if shadow.will_write(t):
                js = jeng.ensure_lt_capacity(js, shadow.count + 1)
                ps = eng.ensure_lt_capacity(ps, shadow.count + 1)
            js, jpred, jlog = jstep(params, js, jnp.asarray(img))
            ps, pred, logits = eng.step(ps, torch.from_numpy(img),
                                        (SIZE, SIZE))
            shadow.update(t)
            err = np.abs(logits.numpy() - np.asarray(jlog)).max()
            agree = (pred.numpy() == np.asarray(jpred)).mean()
            assert err <= LOGIT_TOL, (t, err)
            assert agree >= MASK_AGREE, (t, agree)
        else:
            n = ev[1]
            if js is not None:
                js = jeng.ensure_lt_capacity(js, shadow.count + 1)
                ps = eng.ensure_lt_capacity(ps, shadow.count + 1)
            mask = np.where(full_mask <= n, full_mask, 0)
            jadd = jax.jit(lambda p, i, m, s, n=n, t=t:
                           jeng.add_reference_frame(p, i, m, obj_num=n,
                                                    state=s, frame_step=t))
            js = jadd(params, jnp.asarray(img), jnp.asarray(mask), js)
            ps = eng.add_reference_frame(torch.from_numpy(img),
                                         torch.from_numpy(mask), n,
                                         state=ps, frame_step=t)
            shadow.add_ref(t)
        assert ps.lt_count == [int(c) for c in np.asarray(js.lt_count)]
        assert eng.lt_cap(ps) == jeng.lt_cap(js)
        assert set(ps.lt[2]) == {"k", "v", "id_v"}
        assert shadow.count == max(ps.lt_count)
    assert ps.batch == 2 and ps.lt_count == [4, 2]
    assert eng.lt_cap(ps) == 4
