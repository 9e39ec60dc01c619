"""The port's encoders (ResNet, ResNeSt, Swin, MobileNetV3) against the flax
encoders of aot_tpu on the CPU, with the same weights, at a reduced depth
and a small input; their pooling and windowing pieces against the JAX
functions.

Weights: the flax parameter shapes come from `jax.eval_shape` (no compute)
and are filled from a seeded numpy generator, FrozenBN statistics and
affine included, so every normalisation does real work. They reach the
port through the reference key map of aot_tpu.utils.torch_import's rule
builders, inverted as `export_state_dict` inverts it, and load with
strict=True. Tolerance: each output within 1e-4 of its largest entry (fp32,
only the summation order differs; the features are unbounded)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from aot_tpu.models.encoders import mobilenetv3 as jmnv3
from aot_tpu.models.encoders import resnest as jresnest
from aot_tpu.models.encoders import resnet as jresnet
from aot_tpu.models.encoders import swin as jswin
from aot_tpu.utils import torch_import as TI
from aot_tpu_torch.models.encoders import common, mobilenetv3, resnest, resnet
from aot_tpu_torch.models.encoders import swin

REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these tests (and, imported, for the other
    encoder and variant files): under the suite's parallel workers torch's
    default of a thread a core oversubscribes the machine, and the tests'
    numbers do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def fill_params(shapes, seed: int):
    """{flax path: array} for a tree of ShapeDtypeStructs: kernels
    N(0, 1/fan_in), biases and BN means N(0, 0.1^2), scales and BN
    variances U[0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in TI._flatten(shapes).items():
        leaf = path.rsplit("/", 1)[-1]
        v = rng.standard_normal(s.shape, dtype=np.float32)
        if leaf in ("running_var", "weight", "scale"):
            v = rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        elif leaf in ("bias", "running_mean"):
            v *= 0.1
        else:
            v *= np.float32(1 / np.sqrt(np.prod(s.shape[:-1])))
        out[path] = v
    return out


def unflatten(shapes, flat):
    """The flax parameter tree of `shapes` holding the (numpy) arrays of
    `flat`."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    keys = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp) for kp, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])


def key_map(rules):
    """flax path -> (reference key, layout transform)."""
    return {my: (tk, tf) for my, tk, tf in rules}


def to_reference(flat, rules):
    """Reference-keyed state dict of flax arrays, as export_state_dict
    writes it."""
    kmap = key_map(rules)
    sd = {}
    for path, v in flat.items():
        tk, tf = kmap[path]
        sd[tk] = tf.inv(v) if tf is not None else np.ascontiguousarray(v)
    return sd


def jax_encoder_params(jmodel, size: int, seed: int = 0):
    """(flax path -> array under the 'encoder/' prefix, params tree)."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)["params"]
    flat = fill_params({"encoder": shapes}, seed)
    return flat, unflatten({"encoder": shapes}, flat)["encoder"]


# name: (flax encoder, port encoder, rules, input size)
ENCODERS = {
    "resnet": (lambda: jresnet.ResNet(layers=(1, 1, 2)),
               lambda: resnet.ResNet(layers=(1, 1, 2)),
               lambda: TI._resnet_rules((1, 1, 2)), 33),
    # odd sizes all the way down (33 -> 17 -> 9 -> 5 -> 3): the avg-down
    # shortcut's last window is partial at every stride
    "resnest": (lambda: jresnest.ResNeSt(layers=(1, 1, 2), stem_width=32),
                lambda: resnest.ResNeSt(layers=(1, 1, 2), stem_width=32),
                lambda: TI._resnest_rules((1, 1, 2)), 33),
    # 60 -> 15x15, 8x8, 4x4 tokens: every stage pads to the window (21, 14,
    # 7) and its second block takes the shift mask
    "swin": (lambda: jswin.SwinTransformer(embed_dim=32, depths=(2, 2, 2),
                                           num_heads=(1, 2, 4)),
             lambda: swin.SwinTransformer(embed_dim=32, depths=(2, 2, 2),
                                          num_heads=(1, 2, 4)),
             lambda: TI._swin_rules(depths=(2, 2, 2)), 60),
    "mobilenetv3": (jmnv3.MobileNetV3Large, mobilenetv3.MobileNetV3Large,
                    TI._mobilenetv3_rules, 65),
}

SHAPES = {
    "resnet": [(256, 9), (512, 5), (1024, 3), (1024, 3)],
    "resnest": [(256, 9), (512, 5), (1024, 3), (1024, 3)],
    "swin": [(32, 15), (64, 8), (128, 4), (128, 4)],
    "mobilenetv3": [(24, 17), (40, 9), (112, 5), (960, 5)],
}


@pytest.mark.parametrize("name", list(ENCODERS))
@torch.inference_mode()
def test_encoder_matches_flax(name):
    make_j, make_p, rules, size = ENCODERS[name]
    jmodel, model = make_j(), make_p()
    flat, params = jax_encoder_params(jmodel, size)
    sd = to_reference(flat, rules())
    model.load_state_dict({k[len("encoder."):]: torch.from_numpy(v)
                           for k, v in sd.items()}, strict=True)
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert [(g.shape[1], g.shape[2]) for g in got] == SHAPES[name]
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        scale = np.abs(w).max()
        assert scale > 0.1, (name, scale)      # the features carry signal
        err = np.abs(g.numpy() - w).max()
        assert err <= REL_TOL * scale, (name, err, scale)


# --- pooling -----------------------------------------------------------------


@pytest.mark.parametrize("size", [32, 33, 65])
@pytest.mark.parametrize("stride", [1, 2])
def test_resnest_pools_match_flax(size, stride):
    """avd (3x3, padding counted) and avg-down (ceil mode, padding not
    counted) against aot_tpu's flax pools, odd sizes included."""
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(
        common.avd_pool(stride)(xt).numpy(),
        nchw(jresnest._avg_pool_3x3(jnp.asarray(x), stride)),
        rtol=1e-6, atol=1e-6)
    ph = (-size) % stride
    want = x if stride == 1 else fnn.avg_pool(
        jnp.asarray(x), (stride, stride), strides=(stride, stride),
        padding=((0, ph), (0, ph)), count_include_pad=False)
    np.testing.assert_allclose(common.avg_down_pool(stride)(xt).numpy(),
                               nchw(want), rtol=1e-6, atol=1e-6)


def test_stem_max_pool_never_takes_the_padding():
    x = -1.0 - np.random.RandomState(0).rand(1, 9, 9, 3).astype(np.float32)
    got = common.stem_max_pool()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding=((1, 1), (1, 1)))
    assert float(got.max()) < -1.0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))


# --- Swin's windowing --------------------------------------------------------


def test_swin_relative_position_index():
    for window in (2, 7):
        np.testing.assert_array_equal(swin.relative_position_index(window),
                                      jswin.relative_position_index(window))


@pytest.mark.parametrize("hp,wp", [(35, 35), (14, 21), (119, 119)])
def test_swin_shift_mask_and_windows(hp, wp):
    """The shift mask on padded sizes (29 -> 35 and 116 -> 119 are
    Swin-B's 464^2 grids), and window partition / reverse."""
    np.testing.assert_array_equal(swin.shift_attn_mask(hp, wp, 7, 3),
                                  jswin.shift_attn_mask(hp, wp, 7, 3))
    x = np.random.RandomState(0).randn(2, hp, wp, 4).astype(np.float32)
    wins = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(
        swin.window_reverse(wins, 7, hp, wp).numpy(), x)
