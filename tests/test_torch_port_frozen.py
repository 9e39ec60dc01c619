"""Every encoder name aot_tpu's build_encoder takes, built by the port at
full size: its parameters and buffers are exactly the reference keys that
aot_tpu.utils.torch_import's rules give the flax encoder's parameters, and
they load strictly. Then `frozen_param_patterns` against aot_tpu's for
each encoder and `freeze_at`.

aot_tpu's patterns name the reference's modules and end in '/'
(aot_tpu/models/encoders/__init__.py:62-66). Flax flattens a module's
children into `<parent>_<child>` (`layer1_0`, `layers_0_block_1`,
`patch_embed_proj`), which a '/'-terminated prefix does not reach, and
its ResNeSt stem and MobileNetV3 stages carry other names. So the JAX
frozen set is read here as the flax parameters under the named modules:
a pattern `P/` takes `P/...` and `P_...`, and the two renamed modules
take the flax modules listed in ALIASES. The port's frozen parameters
must be that set's image under the reference key map."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.models.encoders import build_encoder as jax_build_encoder
from aot_tpu.models.encoders import frozen_param_patterns as jax_patterns
from aot_tpu.utils import torch_import as TI
from aot_tpu_torch.models.encoders import build_encoder, frozen_param_patterns
from test_torch_port_encoders import (  # noqa: F401 (autouse)
    key_map, one_torch_thread, to_reference)

_R = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23),
      "resnest50": (3, 4, 6), "resnest101": (3, 4, 23),
      "resnest200": (3, 24, 36), "resnest269": (3, 30, 48)}
RULES = {
    "mobilenetv2": TI._mobilenetv2_rules,
    "mobilenetv3": TI._mobilenetv3_rules,
    "swin_base": TI._swin_rules,
    **{n: (lambda n=n: TI._resnet_rules(_R[n])) for n in _R
       if n.startswith("resnet")},
    **{n: (lambda n=n: TI._resnest_rules(_R[n])) for n in _R
       if n.startswith("resnest")},
}
NAMES = list(RULES)

_MNV3_STAGES = [range(1, 4), range(4, 7), range(7, 13), range(13, 16)]
ALIASES = {
    # ResNeSt's deep stem is the reference's `conv1` Sequential
    ("resnest", "encoder/conv1"): [
        "encoder/stem_conv1", "encoder/stem_bn1", "encoder/stem_conv2",
        "encoder/stem_bn2", "encoder/stem_conv3"],
    # MobileNetV3's stages are features[1:4] / [4:7] / [7:13] / [13:] and
    # the final conv (aot_tpu mobilenetv3.py:5-6)
    **{("mobilenetv3", f"encoder/stage_{i}"):
       [f"encoder/features_{j}" for j in rng]
       + (["encoder/conv_conv", "encoder/conv_bn"] if i == 3 else [])
       for i, rng in enumerate(_MNV3_STAGES)},
}


@lru_cache(maxsize=None)
def jax_paths(name: str):
    """The flax encoder's parameter paths (under 'encoder/') and shapes."""
    shapes = jax.eval_shape(jax_build_encoder(name).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 33, 33, 3), jnp.float32))["params"]
    return {"encoder/" + k: v.shape for k, v in TI._flatten(shapes).items()}


def jax_frozen(name: str, freeze_at: int):
    family = "resnest" if name.startswith("resnest") else name
    mods = []
    for pat in jax_patterns(name, freeze_at):
        mod = pat.rstrip("/")
        mods += ALIASES.get((family, mod), [mod])
    return {p for p in jax_paths(name)
            if any(p.startswith((m + "/", m + "_")) for m in mods)}


@lru_cache(maxsize=None)
def port_encoder(name: str):
    return build_encoder(name)


def port_params(name: str):
    """The port encoder's parameter names (under 'encoder.')."""
    return {"encoder." + n for n, _ in port_encoder(name).named_parameters()}


@pytest.mark.parametrize("name", NAMES)
def test_build_encoder_loads_reference_keys(name):
    flat = {k: np.full(s, 0.5, np.float32) for k, s in jax_paths(name).items()}
    sd = to_reference(flat, RULES[name]())
    enc = port_encoder(name)
    port = {"encoder." + k: tuple(v.shape)
            for k, v in enc.state_dict().items()}
    assert port == {k: v.shape for k, v in sd.items()}
    enc.load_state_dict({k[len("encoder."):]: torch.from_numpy(v)
                         for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("freeze_at", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_frozen_param_patterns_match_jax(name, freeze_at):
    kmap = key_map(RULES[name]())
    params = port_params(name)
    pats = frozen_param_patterns(name, freeze_at)
    assert all(p.startswith("encoder.") and p.endswith(".") for p in pats)
    got = {n for n in params if n.startswith(tuple(pats))}
    want = {kmap[p][0] for p in jax_frozen(name, freeze_at)} & params
    assert got == want
    # what aot_tpu's patterns reach as written lies inside it
    literal = {kmap[p][0] for p in jax_paths(name)
               if p.startswith(tuple(jax_patterns(name, freeze_at)))}
    assert literal & params <= got
    if freeze_at >= 1:
        assert got                           # the stem at least
    if freeze_at == 3:                       # stem and two stages
        assert len(got) < len(params)
