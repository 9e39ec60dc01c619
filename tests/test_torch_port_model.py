"""The port's AOTT model against aot_tpu's on the CPU, with the same weights:
the JAX parameters go through aot_tpu.utils.torch_import.export_state_dict
and load strictly into the port.

257x257 input, so the 16x grid is 17x17 and the 15x15 local window has
interior positions. Max abs error <= 1e-3: about 20 conv layers sum in
another order in XLA-CPU and oneDNN."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.ops.position import sine_position_embedding_seq
from aot_tpu.utils.torch_import import export_state_dict
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.utils.weights import load_reference_state_dict

SIZE = 257
TOL = 1e-3


def jax_aott(cfg, seed: int = 0):
    """aot_tpu model and parameters (initialised at a small input: the
    parameter shapes do not depend on it)."""
    model = jax_build_vos_model(cfg, eval_mode=True)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.MODEL_MAX_OBJ_NUM + 1)).at[..., 0].set(1.0)
    params = jax.jit(partial(model.init, deterministic=True))(
        jax.random.PRNGKey(seed), img, oh)["params"]
    return model, params


def port_aott(cfg, params):
    """The port's model with the JAX parameters, loaded strictly."""
    sd, unmapped = export_state_dict(params, cfg)
    assert not unmapped
    model = build_vos_model(cfg, device="cpu")
    load_reference_state_dict(model, sd)
    return model


def jax_apply(model, params, method, *args):
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return fn(params, *args)


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def aott():
    cfg = build_config(stage="pre_ytb_dav", model="aott")
    jmodel, params = jax_aott(cfg)
    rng = np.random.RandomState(0)
    img = rng.randn(1, SIZE, SIZE, 3).astype(np.float32)
    label = np.zeros((1, SIZE, SIZE), np.int32)
    for i in range(1, 11):
        y, x = rng.randint(0, SIZE - 60, 2)
        label[0, y:y + 60, x:x + 60] = i
    return cfg, jmodel, params, port_aott(cfg, params), img, label


def test_reference_state_dict_loads_strictly(aott):
    cfg, _, params, model, _, _ = aott
    sd, _ = export_state_dict(params, cfg)
    assert len(sd) == 322
    assert set(model.state_dict()) == set(sd)
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), sd[key])
    bad = dict(sd)
    bad["LSTT.mask_token"] = np.zeros((1, 1, 256), np.float32)
    with pytest.raises(RuntimeError):
        load_reference_state_dict(model, bad)


@torch.inference_mode()
def test_encoder_maps(aott):
    _, jmodel, params, model, img, _ = aott
    want = jax_apply(jmodel, params, type(jmodel).encode_image, img)
    got = model.encode_image(torch.from_numpy(nchw(img)))
    assert [tuple(g.shape) for g in got] == [
        (1, 24, 65, 65), (1, 32, 33, 33), (1, 96, 17, 17), (1, 256, 17, 17)]
    for g, w in zip(got, want):
        close(g, nchw(w))


@torch.inference_mode()
def test_id_embedding_conv_path_matches_label_path(aott):
    _, jmodel, params, model, _, label = aott
    want = jax_apply(jmodel, params, type(jmodel).get_id_emb_label, label)
    got = model.get_id_emb_label(torch.from_numpy(label))
    close(got, want)
    one_hot = torch.nn.functional.one_hot(torch.from_numpy(label).long(), 11)
    close(model.get_id_emb(one_hot.permute(0, 3, 1, 2).float()), want)


@torch.inference_mode()
def test_lstt_fuse_and_decode(aott):
    """lstt_forward at the reference frame (id embedding fused) and at
    propagation (LT ring of 2 frames with per-sample live lengths, ST
    memory), fuse_memory and the decoder logits — each from the same
    inputs on both sides."""
    _, jmodel, params, model, img, label = aott
    M = type(jmodel)
    imgs = np.concatenate([img, np.flip(img, axis=1)])        # batch of 2
    xs = jax_apply(jmodel, params, M.encode_image, imgs)
    id_emb = jax_apply(jmodel, params, M.get_id_emb_label,
                       np.concatenate([label, label[:, :, ::-1]]))
    size_2d = (17, 17)
    pos = sine_position_embedding_seq(17, 17, 256)

    @jax.jit
    def j_lstt(p, emb, lt, st, idm, vl):
        return jmodel.apply({"params": p}, emb, lt, st, idm, pos, size_2d,
                            lt_valid_len=vl, method=M.lstt_forward)

    def t_lstt(emb, lt, st, idm, vl):
        to_t = lambda x: None if x is None else torch.tensor(np.asarray(x))
        mem = lambda m: None if m is None else [
            {k: to_t(v) for k, v in layer.items()} for layer in m]
        return model.lstt_forward(
            torch.tensor(nchw(emb)), mem(lt), mem(st), to_t(idm),
            to_t(pos), size_2d, lt_valid_len=to_t(vl))

    # reference frame
    embs, mems = j_lstt(params, xs[-1], None, None, id_emb, None)
    t_embs, t_mems = t_lstt(xs[-1], None, None, id_emb, None)
    close(t_embs[0], embs[0])
    for kind in ("curr", "global"):
        for key in ("k", "v"):
            close(t_mems[0][kind][key], mems[0][kind][key])

    # propagation: LT ring of 2 frames, sample 1 has only the first live
    g = mems[0]["global"]
    lt = [{k: np.concatenate([np.asarray(g[k]), 0.5 * np.asarray(g[k])], 1)
           for k in ("k", "v")}]
    st = [{k: np.asarray(g[k]) for k in ("k", "v")}]
    valid = np.asarray([2 * 289, 289], np.int32)
    embs2, mems2 = j_lstt(params, xs[-1], lt, st, None, valid)
    t_embs2, t_mems2 = t_lstt(xs[-1], lt, st, None, valid)
    close(t_embs2[0], embs2[0])

    # fuse the id embedding into the propagated frame's memory
    curr = mems2[0]["curr"]
    fused = jax.jit(lambda p, k, v, i: jmodel.apply(
        {"params": p}, 0, k, v, i, method=M.fuse_memory))(
            params, curr["k"], curr["v"], id_emb)
    t_fused = model.fuse_memory(0, t_mems2[0]["curr"]["k"],
                                t_mems2[0]["curr"]["v"],
                                torch.tensor(np.asarray(id_emb)))
    close(t_fused["k"], fused["k"])
    close(t_fused["v"], fused["v"])

    # decoder logits at 1/4 resolution
    logits = jax_apply(jmodel, params, M.decode_id_logits, embs2, xs)
    t_logits = model.decode_id_logits(
        t_embs2, [torch.tensor(nchw(x)) for x in xs])
    assert tuple(t_logits.shape) == (2, 11, 65, 65)
    close(t_logits, nchw(logits))
