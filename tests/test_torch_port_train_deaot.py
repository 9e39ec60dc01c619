"""DeAOT training in the port against aot_tpu's on the CPU, at fp32 and
bf16 (TRAIN_DTYPE; AOTT's bf16 step is in tests/test_torch_port_train_bf16.py,
with these helpers), with the same weights (seeded numpy values in the JAX shapes, through export_state_dict,
loaded strictly): DeAOTT at 49x49 with B = 2, T = 3 and an LT write every
frame (TRAIN_LONG_TERM_MEM_GAP = 1, so the last frame reads two LT frames),
dropout and stochastic depth off (the JAX engine's deterministic=True:
DeAOT's DWConv2d drops channels in every training forward). One step on
each side, from its own parts (the JAX package's value_and_grad of
TrainEngine.forward, build_optimizer and the EMA; the port's train_step):
the engine forward (loss, per-frame losses, last prediction), every
gradient leaf, then the grad norm, the updated parameters and the EMA.
Also: DeAOT's parameter groups leaf by leaf, the per-frame recompute
replaying DeAOT's dropout draws, DWConv2d's channel dropout, the CLI
training `deaott`, and a DeAOT checkpoint round trip with auto-resume at
bf16 (parameters, Adam moments and EMA stay fp32).

Tolerances (fp32), as the AOT tests hold them (tests/
test_torch_port_train.py): losses 1e-5 relative, each gradient within
2e-4 of its leaf's largest entry plus 1e-6 of the model's largest and 1e-3
relative, the grad norm 1e-4 relative, parameters and EMA within a quarter
of one LR unit (two where the gradient is below that floor: Adam's first
update is ~lr sign(g)). The bf16 tolerances, and why, are the bf16
file's."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine.train import build_train_engine as jax_build_train_engine
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.models import layers as JL
from aot_tpu.ops import attention as jatt
from aot_tpu.train import ema as jema
from aot_tpu.train import optim as joptim
from aot_tpu.train.step import optax_global_norm
from aot_tpu.utils.torch_import import _flatten, build_rules, export_state_dict
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.models import layers as L
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.train import optim as poptim
from aot_tpu_torch.train import step as pstep
from aot_tpu_torch.utils.weights import load_reference_state_dict
from test_torch_port_encoders import (  # noqa: F401 (autouse)
    fill_params, one_torch_thread, unflatten)

SIZE, T, B = 49, 3, 2
OBJ_NUMS = [3, 2]
# fp32 (tests/test_torch_port_train.py)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL, GRAD_FLOOR = 2e-4, 1e-6
# bf16 (tests/test_torch_port_train_bf16.py says why)
BF16_LOSS, BF16_NORM, BF16_GRAD, BF16_PARAM = 2e-2, 2e-2, 5e-2, 1e-2
BF16_NOISE = 2.0


def train_cfg(model: str, dtype: str, **over):
    return build_config(stage="pre_ytb_dav", model=model, TRAIN_DTYPE=dtype,
                        TRAIN_LSTT_DROPPATH=0.0, TRAIN_LONG_TERM_MEM_CAP=2,
                        TRAIN_TOTAL_STEPS=1000, **over)


def clip(seed=0):
    """uint8 frames (T, B, H, W, 3) and masks (T, B, H, W): noise with
    square objects that drift a pixel a frame."""
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


def jax_params(cfg, seed: int = 0):
    """aot_tpu's training model and seeded parameters of its shapes."""
    jmodel = jax_build_vos_model(cfg)
    img = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, cfg.MODEL_MAX_OBJ_NUM + 1), jnp.float32)
    shapes = jax.eval_shape(partial(jmodel.init, deterministic=True),
                            jax.random.PRNGKey(0), img, oh)["params"]
    return jmodel, unflatten(shapes, fill_params(shapes, seed))


def port_model(cfg, params):
    sd, unmapped = export_state_dict(params, cfg)
    assert not unmapped
    model = build_vos_model(cfg, device="cpu", train=True)
    load_reference_state_dict(model, sd)
    assert model.training and all(p.requires_grad for p in model.parameters())
    return model


def jax_step(cfg, jmodel, params, frames, masks):
    """One deterministic step of aot_tpu from its parts: value_and_grad of
    TrainEngine.forward, the optimizer's first update and the EMA's.
    Returns numpy (loss, stats, grads, params, ema, grad_norm), the trees
    as reference-keyed state dicts."""
    eng = jax_build_train_engine(jmodel, cfg)
    tx = joptim.build_optimizer(cfg, params)

    def loss_fn(p):
        with jatt.attn_training_context():
            return eng.forward(p, jnp.asarray(frames), jnp.asarray(masks),
                               jnp.asarray(OBJ_NUMS), 0.0, deterministic=True)

    @jax.jit
    def run(p):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        new = jax.tree.map(lambda a, u: a + u, p, upd)
        ema = jema.ema_update(jema.ema_init(p), new, jema.ema_decay_for(cfg))
        return loss, stats, grads, new, ema.shadow, optax_global_norm(grads)

    loss, stats, grads, new, ema, norm = run(params)
    sd = lambda tree: export_state_dict(tree, cfg)[0]
    return (float(loss), jax.tree.map(np.asarray, stats), sd(grads), sd(new),
            sd(ema), float(norm))


def port_step(cfg, model, frames, masks):
    """The port's train_step (deterministic, no id shuffle). Returns (stats,
    grads, params, ema) as numpy."""
    state = pstep.create_train_state(cfg, model)
    step = pstep.make_train_step(cfg, build_train_engine(model, cfg),
                                 enable_id_shuffle=False)
    stats = step(state, torch.from_numpy(frames), torch.from_numpy(masks),
                 torch.tensor(OBJ_NUMS), torch.Generator().manual_seed(0),
                 False, deterministic=True)
    assert state.step == 1 and state.optimizer.count == 1
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for n, p in model.named_parameters()}
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in model.parameters())
    return (stats, grads, {k: v.numpy() for k, v in model.state_dict().items()},
            {k: v.numpy() for k, v in state.ema.shadow.items()})


def run_both(model: str, dtype: str, **over):
    """(cfg, the JAX step's results, the port's, the initial state dict)
    from the same weights and clip; at bf16 also the port's fp32 gradients
    from the same weights (the exact gradients, to the fp32 tests'
    tolerance, against which bf16's own rounding is measured)."""
    cfg = train_cfg(model, dtype, **over)
    jmodel, params = jax_params(cfg)
    frames, masks = clip()
    want = jax_step(cfg, jmodel, params, frames, masks)
    got = port_step(cfg, port_model(cfg, params), frames, masks)
    init, _ = export_state_dict(params, cfg)
    exact = None
    if dtype == "bfloat16":
        cfg32 = train_cfg(model, "float32", **over)
        exact = port_step(cfg32, port_model(cfg32, params), frames, masks)[1]
    return cfg, want, got, init, exact


def assert_grads_close(got: dict, want: dict, exact=None):
    """fp32 (exact None): the fp32 tolerance. bf16: each leaf's largest
    error within BF16_GRAD of its largest entry, or within BF16_NOISE
    times aot_tpu's own bf16 error on that leaf (its largest distance from
    `exact`, the fp32 gradients), whichever is larger."""
    assert set(got) <= set(want)
    floor = GRAD_FLOOR * max(float(np.abs(want[n]).max()) for n in got)
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        if exact is not None:
            err = float(np.abs(g - w).max())
            noise = float(np.abs(w - exact[name]).max())
            assert err <= max(BF16_GRAD * scale, BF16_NOISE * noise), (
                name, err, scale, noise)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3,
                                       atol=GRAD_REL * scale + floor,
                                       err_msg=name)


def assert_step_close(cfg, want, got, init, bf16: bool):
    """grad norm, the updated parameters (and buffers) and the EMA."""
    loss, _, jgrads, jparams, jema_, jnorm = want
    stats, grads, params, ema = got
    np.testing.assert_allclose(stats["grad_norm"].item(), jnorm,
                               rtol=BF16_NORM if bf16 else 1e-4)
    assert set(params) == set(jparams)
    lr = cfg.TRAIN_LR_MIN
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    moved = 0
    for name, val in params.items():
        assert val.dtype == np.float32, name
        w = jparams[name]
        if name not in grads:                   # buffers: unchanged
            np.testing.assert_array_equal(val, w, err_msg=name)
            continue
        moved += not np.array_equal(w, init[name])
        if bf16:     # and Adam's sign flip (a zero-initialised leaf)
            tol = BF16_PARAM * float(np.abs(w).max()) + 2 * lr
        else:
            noise = np.abs(grads[name]) < GRAD_FLOOR * gmax
            tol = np.where(noise, 2 * lr, lr / 4) + 1e-7
        assert (np.abs(val - w) <= tol).all(), (name, np.abs(val - w).max())
        e = ema[name]
        assert e.dtype == np.float32, name
        assert (np.abs(e - jema_[name]) <= tol).all(), name
    assert moved > 100


# --- DeAOTT against aot_tpu, fp32 and bf16 --------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def deaot_step(request):
    return run_both("deaott", request.param, TRAIN_LONG_TERM_MEM_GAP=1)


def check_forward(cfg, want, got, bf16: bool):
    loss, jstats = want[0], want[1]
    stats = got[0]
    tol = dict(rtol=BF16_LOSS, atol=0) if bf16 else LOSS_TOL
    np.testing.assert_allclose(stats["loss"].item(), loss, **tol)
    np.testing.assert_allclose(stats["frame_losses"].numpy(),
                               jstats["frame_losses"], **tol)
    agree = (stats["last_pred"].numpy() == jstats["last_pred"]).mean()
    assert agree >= (0.99 if bf16 else 1.0), agree


def check_grads(want, got, exact=None):
    assert_grads_close(got[1], want[2], exact)
    # frozen-BN arrays get no gradient on either side
    assert all(not np.any(want[2][n]) for n in want[2] if n not in got[1])


def test_deaot_train_engine_forward_matches_jax(deaot_step):
    cfg, want, got, _, exact = deaot_step
    check_forward(cfg, want, got, bf16=exact is not None)


def test_deaot_gradients_match_jax_leaf_by_leaf(deaot_step):
    _, want, got, _, exact = deaot_step
    check_grads(want, got, exact)


def test_deaot_train_step_matches_jax(deaot_step):
    cfg, want, got, init, exact = deaot_step
    assert_step_close(cfg, want, got, init, bf16=exact is not None)


# --- groups, dropout, the CLI and checkpoints -------------------------------


@pytest.mark.parametrize("over", [
    {}, dict(TRAIN_ENCODER_FREEZE_AT=4), dict(MODEL_FREEZE_BACKBONE=True),
    dict(TRAIN_WEIGHT_DECAY_EXCLUSIVE={"decoder": 0.5})])
def test_deaot_param_groups_match_jax_leaf_by_leaf(over):
    """DeAOT's optimizer groups (wd, encoder LR, frozen, seq_freeze) for
    every parameter, against aot_tpu/train/optim.py's for every leaf."""
    cfg = train_cfg("deaotl", "bfloat16", **over)
    _, params = jax_params(cfg)
    model = build_vos_model(cfg, device="cpu", train=True)
    got = poptim.build_param_groups(cfg, list(model.named_parameters()))
    port_name = {my: tk for my, tk, _ in build_rules(cfg)}
    want = {key: _flatten(tree)
            for key, tree in joptim.build_param_groups(cfg, params).items()}
    seen = set()
    for path, wd in want["wd"].items():
        name = port_name[path]
        if name not in got:        # FrozenBN arrays: buffers in the port
            assert want["frozen"][path] and "encoder" in name
            continue
        seen.add(name)
        meta = {k: want[k][path] for k in ("encoder", "frozen", "seq_freeze")}
        meta["wd"] = float(wd)
        assert got[name] == meta, (name, got[name], meta)
    assert seen == set(got)
    assert any(n.startswith("LSTT.layers.2.linear_ID_U") for n in got)


def test_dwconv_drops_whole_channels():
    """DWConv2d's dropout (p = 0.1) zeroes whole channels of a sample, as
    nn.Dropout(broadcast_dims=(1,)) over (B, HW, C) does, and scales the
    kept ones by 1 / 0.9; without a generator it is the conv alone."""
    conv = L.DWConv2d(64)
    x = torch.randn(3, 36, 64)
    plain = conv(x, (6, 6))
    g = torch.Generator().manual_seed(0)
    y = conv(x, (6, 6), g)
    dropped = (y == 0).all(dim=1, keepdim=True)        # (B, 1, C)
    assert dropped.any() and not dropped.all()
    torch.testing.assert_close(y, torch.where(dropped, 0.0, plain / 0.9))
    assert JL.DWConv2d.dropout == conv.dropout == 0.1
    assert torch.equal(conv(x, (6, 6), torch.Generator().manual_seed(0)), y)


def test_deaot_recompute_replays_the_dropout_draws():
    """With DeAOT's dropouts on (DWConv2d's channels, stochastic depth on
    both streams, the LT/ST dropout on tgt and delta_id, the embedding and
    identity dropouts), the per-frame recompute (TRAIN_REMAT) gives the
    loss and gradients of the forward that keeps its activations."""
    cfg = build_config(stage="pre_ytb_dav", model="deaott",
                       TRAIN_DTYPE="float32", TRAIN_LONG_TERM_MEM_CAP=2,
                       TRAIN_LONG_TERM_MEM_GAP=1, TRAIN_TOTAL_STEPS=1000,
                       TRAIN_LSTT_DROPPATH=0.5, TRAIN_LSTT_ID_DROPOUT=0.2,
                       TRAIN_LSTT_EMB_DROPOUT=0.2, TRAIN_LSTT_LT_DROPOUT=0.2)
    frames, masks = map(torch.from_numpy, clip(seed=2))

    def run(remat, seed):
        model = build_vos_model(cfg, device="cpu", train=True,
                                generator=torch.Generator().manual_seed(0))
        eng = build_train_engine(model, cfg)
        eng.remat = remat
        with att.attn_training_context():
            loss, _ = eng.forward(frames, masks, torch.tensor(OBJ_NUMS), 10.0,
                                  seed=seed)
            loss.backward()
        return loss.item(), {n: p.grad.numpy() for n, p in
                             model.named_parameters() if p.grad is not None}

    kept_loss, kept = run(False, seed=7)
    loss, grads = run(True, seed=7)
    np.testing.assert_allclose(loss, kept_loss, rtol=1e-6)
    assert set(grads) == set(kept)
    scale = max(float(np.abs(g).max()) for g in kept.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g, kept[name], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)
    # the draws act: another seed gives another loss
    assert abs(run(True, seed=8)[0] - kept_loss) > 1e-4


def cli_base(tmp_path):
    return ["--stage", "pre_ytb_dav", "--datasets", "test", "--device", "cpu",
            "--batch_size", "2", "--total_steps", "2", "--save_step", "2",
            "--log_step", "1", "--data_workers", "0",
            "--set", f"DIR_ROOT={str(tmp_path)!r}",
            "--set", "DATA_RANDOMCROP=(33, 33)", "--set", "DATA_SEQ_LEN=2",
            "--set", "PRETRAIN=False"]


def test_cli_trains_deaott(tmp_path, capsys):
    """`python -m aot_tpu_torch.train --model deaott` trains 2 steps on the
    synthetic fixture, in the config's bf16, and writes its checkpoints."""
    from aot_tpu_torch.train.__main__ import main
    from aot_tpu_torch.utils import checkpoint as ckpt

    main(cli_base(tmp_path) + ["--model", "deaott", "--exp_name", "cli"])
    out = capsys.readouterr().out
    assert "DeAOTT on cpu, bfloat16" in out and "step 2/2" in out
    cfg = build_config(stage="pre_ytb_dav", model="deaott", exp_name="cli",
                       DIR_ROOT=str(tmp_path))
    raw = ckpt.load_checkpoint(ckpt.latest_checkpoint(cfg.DIR_CKPT))
    assert raw["step"] == 2 and "LSTT.layers.0.linear_ID_V.weight" in raw["model"]


def test_deaot_checkpoint_round_trip_and_auto_resume(tmp_path):
    """A bf16 DeAOT Trainer: parameters, gradients' moments and EMA stay
    fp32; the checkpoint holds them, auto-resume restores them exactly and
    trains on, and the EMA state dict loads strictly into a serving
    model."""
    from aot_tpu_torch.train.trainer import Trainer
    from aot_tpu_torch.utils import checkpoint as ckpt

    cfg = build_config(stage="pre_ytb_dav", model="deaott", PRETRAIN=False,
                       DATASETS=["test"], DATA_RANDOMCROP=(33, 33),
                       DATA_SEQ_LEN=2, TRAIN_BATCH_SIZE=2, DATA_WORKERS=0,
                       TRAIN_TOTAL_STEPS=3, TRAIN_SAVE_STEP=2,
                       TRAIN_MAX_KEEP_CKPT=2, TRAIN_LOG_STEP=1,
                       DIR_ROOT=str(tmp_path)).init_dir(make=True)
    assert cfg.TRAIN_DTYPE == "bfloat16"
    trainer = Trainer(cfg, seed=0, device="cpu")
    assert trainer.model.compute_dtype == torch.bfloat16
    trainer.sequential_training(max_steps=2)
    state = trainer.state
    assert all(t.dtype == torch.float32 for t in
               list(state.model.parameters()) + state.optimizer.mu
               + state.optimizer.nu + list(state.ema.shadow.values()))
    raw = ckpt.load_checkpoint(ckpt.latest_checkpoint(cfg.DIR_CKPT))
    assert raw["step"] == 2
    weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    resumed = Trainer(cfg, seed=0, device="cpu")
    assert resumed.start_step == 2 and resumed.state.optimizer.count == 2
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    for k, v in resumed.state.ema.shadow.items():
        assert torch.equal(v, state.ema.shadow[k]), k
    resumed.sequential_training()          # on to TRAIN_TOTAL_STEPS = 3
    assert resumed.state.step == 3
    ema = ckpt.load_checkpoint(ckpt.latest_checkpoint(cfg.DIR_EMA_CKPT))
    serving = build_vos_model(cfg, device="cpu")
    serving.load_state_dict(ema["state_dict"], strict=True)
