"""Trainable BN (MODEL_FREEZE_BN=False) and the trainer's logs in the port
against aot_tpu on the CPU.

- TrainableBatchNorm2d against aot_tpu's FrozenBatchNorm(frozen=False):
  the train-mode output and updated running stats, at fp32 and bf16 input,
  the gradients of the input and the affine at fp32, and the eval-mode
  output from the running stats. fp32 within 1e-5 of the largest entry
  (the moments sum in another order); bf16 output within 1e-2 of the
  largest entry (one bf16 rounding, 2^-8, of the product and of the sum,
  which XLA may fuse), its running stats within 1e-5 (fp32 from the same
  bf16 values).
- One AOTT train step with MODEL_FREEZE_BN=False at 49x49, B = 2, T = 3
  against aot_tpu's, from its parts (value_and_grad of TrainEngine.forward
  with batch_stats, build_optimizer, the EMA), the weights and running
  stats folded into one reference-keyed state dict (`fold_batch_stats`,
  the recipe of aot_tpu_torch/utils/weights.py): loss, every gradient (BN weight and
  bias included), the grad norm, the updated parameters, the EMA and the
  running stats (1e-5 of their scale), at tests/test_torch_port_train.py's
  tolerances but where SENS_EPS says why; the optimizer's groups leaf by
  leaf. The frames are normalised floats (see `normalised`).
- A trainable-BN EMA checkpoint loads strictly into the frozen serving
  model through utils/weights.load_model (the eval CLI's loader) and
  keeps the running stats.
- MetricsLogger, AverageMeter and save_pred_image_log against the JAX
  package's on the same inputs: the JSONL fields and values, the meter's
  averages, the decoded JPEG pixels (equal).
"""

import json
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine.train import build_train_engine as jax_build_train_engine
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.models.encoders.common import FrozenBatchNorm
from aot_tpu.ops import attention as jatt
from aot_tpu.train import ema as jema
from aot_tpu.train import optim as joptim
from aot_tpu.train.step import optax_global_norm
from aot_tpu.utils.torch_import import _flatten, build_rules, export_state_dict
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.models.encoders.common import TrainableBatchNorm2d
from aot_tpu_torch.train import optim as poptim
from aot_tpu_torch.train import step as pstep
from aot_tpu_torch.utils.weights import load_reference_state_dict
from test_torch_port_encoders import (  # noqa: F401 (autouse)
    fill_params, one_torch_thread, unflatten)

SIZE, T, B = 49, 3, 2
OBJ_NUMS = [3, 2]
BN_TOL = 1e-5          # fp32, of the largest entry
BF16_BN_TOL = 1e-2     # bf16 output, of the largest entry
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL, GRAD_FLOOR = 2e-4, 1e-6
STATS_TOL = 1e-5       # running stats, of their scale
# With trainable BN at seeded weights the step's gradients are far more
# sensitive than fp32's rounding: aot_tpu's own step on frames moved by
# 1e-6 relative moves a gradient leaf by ~5% of its largest entry (plus
# 1e-3 of the model's largest) and the grad norm by ~1e-4 (a frozen-BN
# step: < 1e-5 of that), and its fp32 moments (E[x^2] - mean^2) are such a
# move. So the encoder's gradients, which carry the moments' own gradient,
# and the grad norm are held to aot_tpu's trainable step within the fp32
# tolerance or SENSE times aot_tpu's own move under SENS_EPS, whichever is
# larger; every other gradient to aot_tpu's frozen-BN step at the port's
# batch moments (the same function outside the encoder), at the fp32
# tolerance.
SENS_EPS, SENSE = 1e-6, 2.0


def fold_batch_stats(params, batch_stats):
    """The params tree with batch_stats's leaves merged in under the same
    paths (aot_tpu/utils/checkpoint.py:103-108)."""
    out = dict(params)
    for key, val in batch_stats.items():
        if isinstance(val, dict):
            out[key] = fold_batch_stats(out.get(key, {}), val)
        else:
            assert key not in out, key
            out[key] = val
    return out


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()) + 1e-7, err


# --- the BN alone ----------------------------------------------------------


def bn_case():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 3) * 1.5 + 0.7).astype(np.float32)   # NHWC
    cot = rng.randn(4, 6, 5, 3).astype(np.float32)
    params = {"weight": rng.uniform(0.5, 1.5, 3).astype(np.float32),
              "bias": (0.1 * rng.randn(3)).astype(np.float32)}
    stats = {"running_mean": (0.3 * rng.randn(3)).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, 3).astype(np.float32)}
    return x, cot, params, stats


def port_bn(params, stats):
    bn = TrainableBatchNorm2d(3)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainable_bn_matches_jax(dtype):
    x, cot, params, stats = bn_case()
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jbn = FrozenBatchNorm(3, frozen=False)

    def train_fwd(p, xin):
        return jbn.apply({"params": p, "batch_stats": stats}, xin,
                         mutable=["batch_stats"])

    jx = jnp.asarray(x).astype(jdt)
    jy, mutated = train_fwd(params, jx)
    bn = port_bn(params, stats).train()
    tx = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    ty = bn(tx)
    assert ty.dtype == tdt
    got_y = ty.detach().float().permute(0, 2, 3, 1).numpy()
    close(got_y, np.asarray(jy.astype(jnp.float32)),
          BN_TOL if dtype == "float32" else BF16_BN_TOL)
    for k in ("running_mean", "running_var"):
        close(getattr(bn, k).numpy(), mutated["batch_stats"][k], STATS_TOL)

    if dtype == "float32":    # gradients of the input and the affine
        def loss(p, xin):
            return jnp.sum(train_fwd(p, xin)[0] * cot)

        jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jx)
        (ty * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
        close(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, BN_TOL)
        close(bn.weight.grad.numpy(), jgp["weight"], BN_TOL)
        close(bn.bias.grad.numpy(), jgp["bias"], BN_TOL)

    # eval mode: the running stats, as aot_tpu without a mutable collection
    new_stats = {k: np.asarray(v) for k, v in mutated["batch_stats"].items()}
    jy_eval = jbn.apply({"params": params, "batch_stats": new_stats}, jx)
    with torch.no_grad():
        ty_eval = bn.eval()(tx.detach())
    close(ty_eval.float().permute(0, 2, 3, 1).numpy(),
          np.asarray(jy_eval.astype(jnp.float32)),
          BN_TOL if dtype == "float32" else BF16_BN_TOL)


# --- one train step with trainable BN --------------------------------------


def train_cfg(**over):
    over = dict(dict(MODEL_FREEZE_BN=False), **over)
    return build_config(stage="pre_ytb_dav", model="aott",
                        TRAIN_DTYPE="float32", TRAIN_LSTT_DROPPATH=0.0,
                        TRAIN_LONG_TERM_MEM_CAP=2, TRAIN_TOTAL_STEPS=1000,
                        **over)


def clip(seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, B, SIZE, SIZE, 3)).astype(np.uint8)
    masks = np.zeros((T, B, SIZE, SIZE), np.int32)
    for b, n in enumerate(OBJ_NUMS):
        for i in range(1, n + 1):
            y, x = rng.randint(0, SIZE - 16, 2)
            for t in range(T):
                masks[t, b, y + t:y + t + 14, x + t:x + t + 12] = i
                frames[t, b, y + t:y + t + 14, x + t:x + t + 12] = 60 * i
    return frames, masks


def normalised(frames):
    """The frames as the float pipeline gives them (the engine's own
    normalisation of raw uint8 frames, in fp32). aot_tpu's trainable-BN
    encoder pass applies the model to the frames it is given without the
    engine's uint8 normalisation (aot_tpu/engine/train.py:145-149, against
    engine.py:60-67), so the two packages are compared on float frames;
    the port normalises raw frames on this path too (below)."""
    from aot_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD

    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return ((frames.astype(np.float32) / np.float32(255.0) - mean) / std
            ).astype(np.float32)


def port_step(cfg, sd, frames, masks, model=None):
    if model is None:
        model = build_vos_model(cfg, device="cpu", train=True)
    load_reference_state_dict(model, sd)
    state = pstep.create_train_state(cfg, model)
    step = pstep.make_train_step(cfg, build_train_engine(model, cfg),
                                 enable_id_shuffle=False)
    stats = step(state, torch.from_numpy(frames), torch.from_numpy(masks),
                 torch.tensor(OBJ_NUMS), torch.Generator().manual_seed(0),
                 False, deterministic=True)
    return model, state, stats


def jax_variables(cfg, seed: int = 0):
    """aot_tpu's trainable-BN model with seeded params and batch_stats."""
    jmodel = jax_build_vos_model(cfg)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.MODEL_MAX_OBJ_NUM + 1), jnp.float32)
    shapes = jax.eval_shape(partial(jmodel.init, deterministic=True),
                            jax.random.PRNGKey(0), img, oh)
    assert set(shapes) == {"params", "batch_stats"}
    return (jmodel, unflatten(shapes["params"],
                              fill_params(shapes["params"], seed)),
            unflatten(shapes["batch_stats"],
                      fill_params(shapes["batch_stats"], seed + 1)))


def reference_sd(cfg, params, batch_stats):
    sd, unmapped = export_state_dict(fold_batch_stats(params, batch_stats),
                                     cfg)
    assert not unmapped
    return sd


@pytest.fixture(scope="module")
def bn_step():
    cfg = train_cfg()
    jmodel, params, bstats = jax_variables(cfg)
    raw, masks = clip()
    frames = normalised(raw)
    eng = jax_build_train_engine(jmodel, cfg)
    tx = joptim.build_optimizer(cfg, params)

    def loss_fn(p, fr):
        with jatt.attn_training_context():
            return eng.forward(p, fr, jnp.asarray(masks),
                               jnp.asarray(OBJ_NUMS), 0.0, deterministic=True,
                               batch_stats=bstats)

    @jax.jit
    def run(p, fr):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, fr)
        upd, _ = tx.update(grads, tx.init(p), p)
        new = jax.tree.map(lambda a, u: a + u, p, upd)
        ema = jema.ema_update(jema.ema_init(p), new, jema.ema_decay_for(cfg))
        return loss, stats, grads, new, ema.shadow, optax_global_norm(grads)

    loss, jstats, grads, new, ema, norm = run(params, jnp.asarray(frames))
    new_stats = jax.tree.map(np.asarray, jstats["batch_stats"])
    # aot_tpu's own move when the frames move by SENS_EPS relative
    rng = np.random.RandomState(1)
    moved = (frames * (1 + SENS_EPS * rng.randn(*frames.shape))
             ).astype(np.float32)
    _, _, moved_grads, _, _, moved_norm = run(params, jnp.asarray(moved))
    own = {"grads": export_state_dict(moved_grads, cfg)[0],
           "norm": abs(float(moved_norm) - float(norm)) / float(norm)}
    want = {"loss": float(loss), "grad_norm": float(norm),
            "grads": export_state_dict(grads, cfg)[0],
            "state": reference_sd(cfg, new, new_stats),
            "ema": export_state_dict(ema, cfg)[0],
            "init": reference_sd(cfg, params, bstats)}

    moments = {}
    model = build_vos_model(cfg, device="cpu", train=True)
    for name, mod in model.named_modules():
        if isinstance(mod, TrainableBatchNorm2d):
            mod.register_forward_hook(partial(batch_moments, moments, name))
    model, state, stats = port_step(cfg, want["init"], frames, masks, model)
    got = {"loss": stats["loss"].item(),
           "grad_norm": stats["grad_norm"].item(),
           "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
           "state": {k: v.numpy() for k, v in model.state_dict().items()},
           "ema": {k: v.numpy() for k, v in state.ema.shadow.items()}}
    want["frozen_grads"] = jax_frozen_grads(params, bstats, moments, frames,
                                            masks)
    gmax = max(float(np.abs(w).max()) for w in want["grads"].values())
    want["own_grad"] = max(
        float(np.abs(own["grads"][n] - w).max())
        / (float(np.abs(w).max()) + 1e-3 * gmax)
        for n, w in want["grads"].items())
    want["own_norm"] = own["norm"]
    return cfg, params, want, got, raw


def batch_moments(out, name, mod, inputs, _):
    """A BN's batch mean and biased variance, rounded to fp32 (as
    TrainableBatchNorm2d takes them)."""
    x = inputs[0].detach().double()
    out[name] = (x.mean(dim=(0, 2, 3)).float().numpy(),
                 x.var(dim=(0, 2, 3), unbiased=False).float().numpy())


def jax_frozen_grads(params, bstats, moments, frames, masks):
    """aot_tpu's gradients of the same step with frozen BN at the port's
    batch moments: the same forward, and outside the encoder the same
    gradient (the moments' own gradient reaches only the encoder), free of
    the rounding of aot_tpu's fp32 moments."""
    from aot_tpu.utils.torch_import import convert_state_dict

    cfg = train_cfg(MODEL_FREEZE_BN=True)
    sd = reference_sd(cfg, params, bstats)
    for name, (mean, var) in moments.items():
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = mean, var
    frozen, missing, _ = convert_state_dict(
        sd, fold_batch_stats(params, bstats), cfg)
    assert not missing
    eng = jax_build_train_engine(jax_build_vos_model(cfg), cfg)

    def loss_fn(p):
        with jatt.attn_training_context():
            return eng.forward(p, jnp.asarray(frames), jnp.asarray(masks),
                               jnp.asarray(OBJ_NUMS), 0.0,
                               deterministic=True)[0]

    return export_state_dict(jax.jit(jax.grad(loss_fn))(frozen), cfg)[0]


def test_trainable_bn_train_step_matches_jax(bn_step):
    cfg, _, want, got, _ = bn_step
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=max(1e-4, SENSE * want["own_norm"]))
    grads = got["grads"]
    assert len([n for n in grads if n.startswith("encoder.")
                and n.endswith((".1.weight", ".1.bias"))]) >= 50
    gmax = max(float(np.abs(w).max()) for w in want["grads"].values())
    for name, g in grads.items():
        if name.startswith("encoder."):      # with the moments' gradient
            w = want["grads"][name]
            scale = float(np.abs(w).max())
            atol = max(GRAD_REL * scale + GRAD_FLOOR * gmax,
                       SENSE * want["own_grad"] * (scale + 1e-3 * gmax))
        else:
            w = want["frozen_grads"][name]
            atol = GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR * gmax
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=name)

    lr = cfg.TRAIN_LR_MIN
    state, moved_stats = got["state"], 0
    assert set(state) == set(want["state"])
    for name, val in state.items():
        w = want["state"][name]
        if name in grads:
            # Adam's first update is lr g / (|g| + eps): two LR units where
            # the gradient is noise or the two gradients differ by more
            # than half of the port's (their updates may then differ by
            # up to 2 lr)
            g, wg = grads[name], want["grads"][name]
            flip = ((np.abs(g) < GRAD_FLOOR * gmax)
                    | (np.abs(g - wg) > 0.5 * np.abs(g)))
            tol = np.where(flip, 2 * lr, lr / 4) + 1e-7
            assert (np.abs(val - w) <= tol).all(), name
            assert (np.abs(got["ema"][name] - want["ema"][name]) <= tol
                    ).all(), name
        else:                      # the running stats
            assert "running" in name
            close(val, w, STATS_TOL)
            moved_stats += not np.array_equal(w, want["init"][name])
    assert moved_stats >= 100


def test_trainable_bn_step_normalises_raw_frames(bn_step):
    """The port's step on raw uint8 frames is its step on the normalised
    float frames (the engine normalises them before the BN pass)."""
    cfg, _, want, got, raw = bn_step
    _, masks = clip()
    _, _, stats = port_step(cfg, want["init"], raw, masks)
    np.testing.assert_allclose(stats["loss"].item(), got["loss"], rtol=1e-6)
    # (the rounding of the normalisation is a move as SENS_EPS's)
    np.testing.assert_allclose(stats["grad_norm"].item(), got["grad_norm"],
                               rtol=max(1e-4, SENSE * want["own_norm"]))


@pytest.mark.parametrize("over", [
    {}, dict(TRAIN_ENCODER_FREEZE_AT=4), dict(MODEL_FREEZE_BACKBONE=True)])
def test_trainable_bn_param_groups_match_jax(bn_step, over):
    _, params, _, _, _ = bn_step
    cfg = train_cfg(**over)
    model = build_vos_model(cfg, device="cpu", train=True)
    got = poptim.build_param_groups(cfg, list(model.named_parameters()))
    port_name = {my: tk for my, tk, _ in build_rules(cfg)}
    want = {key: _flatten(tree)
            for key, tree in joptim.build_param_groups(cfg, params).items()}
    assert {port_name[p] for p in want["wd"]} == set(got)
    for path, wd in want["wd"].items():
        meta = {k: want[k][path] for k in ("encoder", "frozen", "seq_freeze")}
        meta["wd"] = float(wd)
        assert got[port_name[path]] == meta, port_name[path]
    bn = [f"{n}.{k}" for n, m in model.named_modules()
          if isinstance(m, TrainableBatchNorm2d) for k in ("weight", "bias")]
    assert len(bn) == 104 and all(got[n]["wd"] == 0.0 for n in bn)


# --- checkpoints -------------------------------------------------------------


def test_trainable_bn_ema_checkpoint_loads_into_the_frozen_model(bn_step,
                                                                  tmp_path):
    from aot_tpu_torch.utils.weights import load_model
    from aot_tpu_torch.utils import checkpoint as ckpt

    cfg, _, want, _, _ = bn_step
    model = build_vos_model(cfg, device="cpu", train=True)
    load_reference_state_dict(model, want["state"])
    ema = pstep.create_train_state(cfg, model).ema
    path = ckpt.save_checkpoint(str(tmp_path), 1,
                                {"state_dict": ema.state_dict(model)})
    serving = load_model(cfg, path, torch.device("cpu"))
    assert not serving.training
    sd = serving.state_dict()
    assert set(sd) == set(want["state"])
    for name, val in sd.items():
        np.testing.assert_array_equal(val.numpy(), want["state"][name], name)


# --- the trainer's logs ------------------------------------------------------


def test_metrics_logger_and_meter_match_jax(tmp_path):
    from aot_tpu.utils.logging import MetricsLogger as JaxLogger
    from aot_tpu.utils.meters import AverageMeter as JaxMeter
    from aot_tpu_torch.utils.logging import MetricsLogger
    from aot_tpu_torch.utils.meters import AverageMeter

    rng = np.random.RandomState(1)
    records = [(s, {"loss": float(rng.rand()), "iou": float(rng.rand()),
                    "grad_norm": np.float32(rng.rand() * 10)})
               for s in (5, 10, 15)]
    lines = []
    for cls, sub in ((JaxLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / sub))
        for step, scalars in records:
            log.log(step, scalars)
        log.close()
        lines.append([json.loads(l) for l in open(log.path)])
    assert lines[1][0]["step"] == 5
    for a, b in zip(*lines):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "time"} == {
            k: v for k, v in b.items() if k != "time"}

    meters = [JaxMeter(), AverageMeter(), JaxMeter(0.5), AverageMeter(0.5)]
    for v in rng.rand(20):
        for m in meters:
            m.update(float(v), n=2)
    for a, b in (meters[:2], meters[2:]):
        assert (a.val, a.avg, a.moving_avg, a.sum, a.count) == (
            b.val, b.avg, b.moving_avg, b.sum, b.count)


@pytest.mark.parametrize("raw", [True, False])
def test_pred_image_log_matches_jax(tmp_path, raw):
    from PIL import Image

    from aot_tpu.utils.logging import save_pred_image_log as jax_save
    from aot_tpu_torch.utils.logging import save_pred_image_log

    rng = np.random.RandomState(2)
    if raw:
        frame = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    else:      # the normalised pipeline
        frame = rng.randn(24, 32, 3).astype(np.float32)
    gt = rng.randint(0, 4, (24, 32)).astype(np.int32)
    pred = rng.randint(0, 4, (24, 32)).astype(np.int64)
    jax_save(str(tmp_path / "jax"), 7, frame, gt, pred)
    save_pred_image_log(str(tmp_path / "port"), 7, frame, gt, pred)
    want = np.asarray(Image.open(tmp_path / "jax" / "step_7.jpg"))
    got = np.asarray(Image.open(tmp_path / "port" / "step_7.jpg"))
    assert got.shape == (24, 96, 3)
    np.testing.assert_array_equal(got, want)
