"""All 14 model variants of configs/models.py, built by the port at full
width on the CPU, load aot_tpu's parameters strictly: the flax parameter
shapes from `jax.eval_shape` of the model's init (no compute), each
filled with its own index, then `export_state_dict` and
`load_reference_state_dict` (strict=True). The key count of each variant
is the one utils/weights.py records, and each tensor arrives at its key.
Also `run_both`, which drives aot_tpu's online engine and the port's side
by side, and `check_variant_engine` on it (tests/test_torch_port_variants_
{aot,deaot}.py and the slice's tests use them)."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine import build_infer_engine as jax_build_infer_engine
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.utils import torch_import as TI
from aot_tpu.utils.torch_import import export_state_dict
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.utils.weights import load_reference_state_dict
from test_torch_port_encoders import (  # noqa: F401 (autouse)
    fill_params, one_torch_thread, unflatten)
from test_torch_port_engine import LOGIT_TOL, MASK_AGREE, SIZE, clip

# variant -> reference state dict keys (aot_tpu_torch/utils/weights.py)
N_KEYS = {
    "aott": 322, "aots": 356, "aotb": 390, "aotl": 390,
    "r50_aotl": 345, "r101_aotl": 600, "rs101_aotl": 850, "swinb_aotl": 432,
    "deaott": 325, "deaots": 362, "deaotb": 399, "deaotl": 399,
    "r50_deaotl": 354, "swinb_deaotl": 441,
}


def jax_shapes(cfg):
    """aot_tpu model and its parameter shapes (eval_shape of the init at a
    small input: they do not depend on it)."""
    jmodel = jax_build_vos_model(cfg, eval_mode=True)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.MODEL_MAX_OBJ_NUM + 1), jnp.float32)
    return jmodel, jax.eval_shape(partial(jmodel.init, deterministic=True),
                                  jax.random.PRNGKey(0), img, oh)["params"]


def jax_variant(cfg, seed: int = 0):
    """aot_tpu model and seeded parameters of the variant's full shapes."""
    jmodel, shapes = jax_shapes(cfg)
    return jmodel, unflatten(shapes, fill_params(shapes, seed))


def port_variant(cfg, params):
    """The port's model with the JAX parameters, loaded strictly; and the
    reference state dict."""
    sd, unmapped = export_state_dict(params, cfg)
    assert not unmapped
    model = build_vos_model(cfg, device="cpu")
    load_reference_state_dict(model, sd)
    return model, sd


def run_both(cfg, jmodel, params, model, imgs, mask, objects, size):
    """Reference frame then len(imgs) - 1 steps of the evaluator's loop
    on both engines ('grow' ring grown before each LT write). Returns the
    worst grid-logits error, the largest live logit (channels 0..objects;
    the others hold the -1e10 of absent objects on both sides), the worst
    mask agreement and the port's last state."""
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    shadow = eng.make_shadow()
    js = jax.jit(lambda p, i, m: jeng.add_reference_frame(
        p, i, m, obj_num=objects))(params, jnp.asarray(imgs[0]),
                                   jnp.asarray(mask))
    ps = eng.add_reference_frame(torch.from_numpy(imgs[0]),
                                 torch.from_numpy(mask), objects)
    shadow.add_ref(0)
    jstep = jax.jit(lambda p, s, i: jeng.step(p, s, i,
                                              output_size=(size, size)))
    worst_err, scale, worst_agree = 0.0, 0.0, 1.0
    for t in range(1, len(imgs)):
        if shadow.will_write(t):
            js = jeng.ensure_lt_capacity(js, shadow.count + 1)
            ps = eng.ensure_lt_capacity(ps, shadow.count + 1)
        js, jpred, jlog = jstep(params, js, jnp.asarray(imgs[t]))
        with torch.inference_mode():
            ps, pred, logits = eng.step(ps, torch.from_numpy(imgs[t]),
                                        (size, size))
        shadow.update(t)
        jlog = np.asarray(jlog)
        worst_err = max(worst_err, np.abs(logits.numpy() - jlog).max())
        scale = max(scale, np.abs(jlog[..., :objects + 1]).max())
        worst_agree = min(worst_agree,
                          (pred.numpy() == np.asarray(jpred)).mean())
        assert ps.lt_count == [int(c) for c in np.asarray(js.lt_count)]
    return worst_err, scale, worst_agree, ps


def check_variant_engine(variant: str, objects: int = 6):
    """A variant's reference frame and 2 steps at 257x257 through both
    engines (LT gap 1: the second step reads two LT frames), held to the
    gates of tests/test_torch_port_engine.py."""
    cfg = build_config(stage="pre_ytb_dav", model=variant,
                       TEST_LONG_TERM_MEM_GAP=1, TEST_LONG_TERM_MEM_CAP=4)
    assert cfg.TEST_LONG_TERM_MEM_POLICY == "grow"
    jmodel, params = jax_variant(cfg)
    model, _ = port_variant(cfg, params)
    imgs, full_mask = clip(7, 3)
    mask = np.where(full_mask <= objects, full_mask, 0)
    err, _, agree, ps = run_both(cfg, jmodel, params, model, imgs, mask,
                                 objects, SIZE)
    assert err <= LOGIT_TOL, (variant, err)
    assert agree >= MASK_AGREE, (variant, agree)
    assert ps.lt_count == [3] and len(ps.lt) == cfg.MODEL_LSTT_NUM


@pytest.mark.parametrize("variant", list(N_KEYS))
def test_variant_loads_reference_weights(variant):
    """Each parameter holds its own index, so a key that lands on another
    tensor of the same shape shows."""
    cfg = build_config(stage="pre_ytb_dav", model=variant)
    _, shapes = jax_shapes(cfg)
    flat = {k: np.full(s.shape, i, np.float32) for i, (k, s) in
            enumerate(TI._flatten(shapes).items())}
    model, sd = port_variant(cfg, unflatten(shapes, flat))
    assert len(sd) == N_KEYS[variant]
    state = model.state_dict()
    assert set(state) == set(sd)
    for key, val in state.items():
        assert bool((val == float(sd[key].flat[0])).all()), key
    assert len({float(v.flat[0]) for v in sd.values()}) == len(sd)


@pytest.mark.parametrize("variant", ["r50_aotl", "rs101_aotl",
                                     "swinb_deaotl"])
def test_seeded_init_draws_every_parameter(variant):
    """`build_vos_model`'s seeded init reaches every new encoder parameter:
    the same seed gives the same weights, another seed other values in
    every weight tensor, and Swin's bias tables and linears carry the
    truncated normal 0.02 of aot_tpu's swin.py."""
    cfg = build_config(stage="pre_ytb_dav", model=variant)
    make = lambda seed: build_vos_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    a, b, c = make(1).state_dict(), make(1).state_dict(), make(2).state_dict()
    for key, val in a.items():
        assert torch.equal(val, b[key]), key
        if val.ndim >= 2 and key.startswith("encoder."):
            assert not torch.equal(val, c[key]), key
    if variant.startswith("swinb"):
        for key, val in a.items():
            if key.endswith(("relative_position_bias_table", "qkv.weight")):
                assert 0.015 < float(val.std()) < 0.025, (key, val.std())
                assert float(val.abs().max()) <= 0.04 + 1e-6, key
