"""The port's training path against aot_tpu's on the CPU, with the same
weights (the JAX init through export_state_dict, loaded strictly), at 49x49
with B = 2, T = 3 and no stochastic depth (TRAIN_LSTT_DROPPATH = 0, as
tools/grad_parity.py runs it): the losses, the optimizer's groups, the LR
schedule and the EMA, one TrainEngine.forward (loss and every gradient,
with the same id-shuffle matrix fed to both, use_prev_pred False and True),
one full train step (loss, grad_norm, updated parameters), and the port's
Trainer and CLI on the synthetic `test` dataset.

JAX gradients and parameters map onto the port's names through the
reference rule table (aot_tpu.utils.torch_import: export_state_dict for
arrays, build_rules for per-leaf metadata)."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine.train import build_train_engine as jax_build_train_engine
from aot_tpu.models import build_vos_model as jax_build_vos_model
from aot_tpu.ops import attention as jatt
from aot_tpu.ops import image as jimg
from aot_tpu.ops import losses as jloss
from aot_tpu.train import ema as jema
from aot_tpu.train import optim as joptim
from aot_tpu.train.step import create_train_state, make_train_step
from aot_tpu.utils.torch_import import _flatten, build_rules, export_state_dict
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.ops import image as img
from aot_tpu_torch.ops import losses
from aot_tpu_torch.train import ema as pema
from aot_tpu_torch.train import optim as poptim
from aot_tpu_torch.train import step as pstep
from aot_tpu_torch.utils.weights import load_reference_state_dict

SIZE, T, B = 49, 3, 2
OBJ_NUMS = [3, 2]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 losses, summation order only
# Gradients: each leaf within 2e-4 of its own largest entry plus 1e-6 of the
# largest gradient of the model, and 1e-3 relative. ~20 conv and matmul
# layers sum in another order in XLA-CPU and oneDNN, and the backward grows
# that to ~5e-5 of a leaf's scale (measured); a wrong term is of the leaf's
# own size. The floor covers leaves whose gradient is fp32 noise on both
# sides: at init the self-attention's q and k gradients are ~1e-9 of the
# model's largest (its tokens are near alike), and their digits differ.
GRAD_REL, GRAD_FLOOR = 2e-4, 1e-6


def _train_cfg(**over):
    return build_config(stage="pre_ytb_dav", model="aott",
                        TRAIN_DTYPE="float32", TRAIN_LSTT_DROPPATH=0.0,
                        TRAIN_LONG_TERM_MEM_CAP=2, TRAIN_TOTAL_STEPS=1000,
                        **over)


def _clip(seed=0):
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


@pytest.fixture(scope="module")
def setup():
    cfg = _train_cfg()
    jmodel = jax_build_vos_model(cfg)
    img0 = jnp.zeros((1, 65, 65, 3), jnp.float32)
    oh = jnp.zeros((1, 65, 65, 11)).at[..., 0].set(1.0)
    params = jax.jit(partial(jmodel.init, deterministic=True))(
        jax.random.PRNGKey(0), img0, oh)["params"]
    return cfg, jmodel, params


def _port_model(cfg, params):
    sd, unmapped = export_state_dict(params, cfg)
    assert not unmapped
    model = build_vos_model(cfg, device="cpu", train=True)
    load_reference_state_dict(model, sd)
    assert model.training and all(p.requires_grad for p in model.parameters())
    return model


def _shuffle(seed=5):
    rng = np.random.RandomState(seed)
    eye = np.eye(11, dtype=np.float32)
    return np.stack([np.concatenate([eye[:1], eye[1:][rng.permutation(10)]])
                     for _ in range(B)])


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = want[name]
        atol = GRAD_REL * float(np.abs(w).max()) + floor
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=name)


# --- losses -------------------------------------------------------------


def test_topk_sum_value_and_grad_with_ties():
    """Ties at the threshold: the gradient reaches only the entries above
    it (the JAX semantics), not the tied ones torch.topk would pick."""
    rng = np.random.RandomState(0)
    v = np.concatenate([np.full((2, 40), 0.5, np.float32),
                        rng.rand(2, 24).astype(np.float32) + 1.0], axis=1)
    v[1, :3] = 0.0
    for k in (10, 30, 64, 0):
        want, jgrad = jax.value_and_grad(
            lambda x: jloss.topk_sum(x, k).sum())(jnp.asarray(v))
        tv = torch.tensor(v, requires_grad=True)
        got = losses.topk_sum(tv, k)
        got.sum().backward()
        np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-6)
        np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jgrad))
    # k = 30: 24 entries above the tie at 0.5, 6 of the 40 tied make it up
    tv = torch.tensor(v, requires_grad=True)
    losses.topk_sum(tv, 30).sum().backward()
    assert tv.grad[:, :40].sum() == 0 and tv.grad[:, 40:].sum() == 48


@pytest.mark.parametrize("ignore", [False, True])
def test_losses_match_jax(ignore):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 9, 11, 11).astype(np.float32) * 3
    labels = rng.randint(0, 4, (2, 9, 11)).astype(np.int32)
    labels[1][labels[1] == 3] = 0
    if ignore:
        labels[:, :2] = 255
    obj = np.asarray([3, 2], np.int32)
    j = lambda x: jnp.asarray(x)
    t = lambda x: torch.tensor(x)
    for ratio in (1.0, 0.4):
        np.testing.assert_allclose(
            losses.cross_entropy_loss(t(logits), t(labels), t(obj),
                                      top_k_percent=0.15,
                                      top_k_ratio=ratio).numpy(),
            np.asarray(jloss.cross_entropy_loss(
                j(logits), j(labels), j(obj), top_k_percent=0.15,
                top_k_ratio=ratio)), **LOSS_TOL)
    np.testing.assert_allclose(
        losses.cross_entropy_loss(t(logits), t(labels), t(obj)).numpy(),
        np.asarray(jloss.cross_entropy_loss(j(logits), j(labels), j(obj))),
        **LOSS_TOL)
    np.testing.assert_allclose(
        losses.soft_jaccard_loss(t(logits), t(labels), t(obj)).numpy(),
        np.asarray(jloss.soft_jaccard_loss(j(logits), j(labels), j(obj))),
        **LOSS_TOL)

    cf = logits.transpose(0, 3, 1, 2).copy()
    want, jgrad = jax.value_and_grad(lambda x: jloss.combined_vos_loss_cf(
        x, j(labels), j(obj), top_k_ratio=0.7).sum())(j(cf))
    tcf = torch.tensor(cf, requires_grad=True)
    got = losses.combined_vos_loss_cf(tcf, t(labels), t(obj), top_k_ratio=0.7)
    got.sum().backward()
    np.testing.assert_allclose(got.sum().item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(tcf.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-6)

    pred = rng.randint(0, 4, (2, 9, 11)).astype(np.int32)
    for o in (obj, np.zeros(2, np.int32)):
        np.testing.assert_allclose(
            losses.mean_iou(t(pred), t(labels), t(o), 10).item(),
            float(jloss.mean_iou(j(pred), j(labels), j(o), 10)), rtol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_matmul_resize_and_permutations(align_corners):
    x = np.random.RandomState(2).randn(2, 11, 13, 13).astype(np.float32)
    want = jimg.interpolate_bilinear_matmul_cf(jnp.asarray(x), (49, 51),
                                               align_corners)
    got = img.interpolate_bilinear_matmul_cf(torch.tensor(x), (49, 51),
                                             align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for keep_first in (True, False):
        s = img.generate_permute_matrix(11, 4, torch.Generator().manual_seed(3),
                                        keep_first=keep_first).numpy()
        assert s.shape == (4, 11, 11)
        assert (s.sum(1) == 1).all() and (s.sum(2) == 1).all()
        assert (s[:, 0, 0] == 1).all() or not keep_first


# --- optimizer, schedule, EMA -------------------------------------------


@pytest.mark.parametrize("over", [
    {}, dict(TRAIN_ENCODER_FREEZE_AT=4), dict(MODEL_FREEZE_BACKBONE=True),
    dict(TRAIN_WEIGHT_DECAY_EXCLUSIVE={"decoder": 0.5})])
def test_param_groups_match_jax_leaf_by_leaf(setup, over):
    _, _, params = setup
    cfg = _train_cfg(**over)
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
    frozen = [n for n, m in got.items() if m["frozen"]]
    assert frozen and all(n.startswith("encoder.") for n in frozen)


@pytest.mark.parametrize("over", [
    {}, dict(TRAIN_LR_COSINE_DECAY=True), dict(TRAIN_LR_RESTART=3)])
def test_lr_schedule_and_ema_match_jax(over):
    cfg = _train_cfg(**over)
    want = joptim.poly_warmup_lr(cfg)
    got = poptim.poly_warmup_lr(cfg)
    for step in (0, 1, 25, 49, 50, 51, 333, 500, 999):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5)

    decay = pema.ema_decay_for(cfg)
    assert decay == jema.ema_decay_for(cfg)
    rng = np.random.RandomState(4)
    p0 = rng.randn(5, 3).astype(np.float32)
    model = torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor(p0))
    ema = pema.EMA(model, decay)
    jstate = jema.ema_init({"w": jnp.asarray(p0)})
    for _ in range(3):
        p = rng.randn(5, 3).astype(np.float32)
        with torch.no_grad():
            model.weight.copy_(torch.tensor(p))
        ema.update(model)
        jstate = jema.ema_update(jstate, {"w": jnp.asarray(p)}, decay)
    np.testing.assert_allclose(ema.shadow["weight"].numpy(),
                               np.asarray(jstate.shadow["w"]), rtol=1e-6)


# --- the training forward and the train step ------------------------------


def _jax_forward(cfg, jmodel, params, frames, masks, shuffle, use_prev_pred):
    eng = jax_build_train_engine(jmodel, cfg)

    def loss_fn(p):
        with jatt.attn_training_context():
            return eng.forward(p, frames, masks, jnp.asarray(OBJ_NUMS), 0.0,
                               shuffle_matrix=shuffle,
                               use_prev_pred=use_prev_pred,
                               deterministic=True)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


@pytest.mark.parametrize("use_prev_pred", [False, True])
def test_train_engine_forward_matches_jax(setup, use_prev_pred):
    cfg, jmodel, params = setup
    frames, masks = _clip()
    shuffle = _shuffle()
    (jloss_, jstats), jgrads = _jax_forward(
        cfg, jmodel, params, jnp.asarray(frames), jnp.asarray(masks),
        jnp.asarray(shuffle), use_prev_pred)

    model = _port_model(cfg, params)
    eng = build_train_engine(model, cfg)
    with att.attn_training_context():
        loss, stats = eng.forward(
            torch.from_numpy(frames), torch.from_numpy(masks),
            torch.tensor(OBJ_NUMS), 0.0,
            shuffle_matrix=torch.from_numpy(shuffle),
            use_prev_pred=use_prev_pred)
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss_), **LOSS_TOL)
    np.testing.assert_allclose(stats["frame_losses"].detach().numpy(),
                               np.asarray(jstats["frame_losses"]), **LOSS_TOL)
    np.testing.assert_array_equal(stats["last_pred"].numpy(),
                                  np.asarray(jstats["last_pred"]))
    want, _ = export_state_dict(jgrads, cfg)
    got = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for n, p in model.named_parameters()}
    _assert_grads_close(got, {n: want[n] for n in got})
    # frozen-BN arrays get no gradient on either side
    assert all(not np.any(want[n]) for n in want if n not in got)
    # use_prev_pred freezes the id embedding, the reference frame's too
    id_bank = model.patch_wise_id_bank.weight.grad
    assert (id_bank is None) == use_prev_pred


def test_recompute_replays_the_dropout_draws():
    """With stochastic depth and every dropout on, the per-frame recompute
    (TRAIN_REMAT) gives the loss and gradients of the forward that keeps its
    activations: each recomputed frame draws the masks its forward drew."""
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TRAIN_DTYPE="float32", TRAIN_LONG_TERM_MEM_CAP=2,
                       TRAIN_TOTAL_STEPS=1000, TRAIN_LSTT_DROPPATH=0.5,
                       TRAIN_LSTT_ID_DROPOUT=0.2, TRAIN_LSTT_EMB_DROPOUT=0.2,
                       TRAIN_LSTT_LT_DROPOUT=0.2)
    frames, masks = map(torch.from_numpy, _clip(seed=2))

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


def test_train_step_matches_jax(setup):
    """One full step of each side's make_train_step (id shuffle off): loss,
    grad_norm and every updated parameter, buffer and EMA entry. Parameters
    within 5e-6, a quarter of one LR unit (the step-0 lr is TRAIN_LR_MIN =
    2e-5), as tests/test_dp_equivalence.py reasons it: Adam's first update
    is ~lr sign(g). Where the gradient itself is fp32 noise (below the
    GRAD_FLOOR of the model's largest; the self-attention's q and k here),
    its sign may differ between the frameworks, so those entries get two LR
    units. A wrong gradient or group moves a whole leaf by ~lr."""
    cfg, jmodel, params = setup
    frames, masks = _clip(seed=1)
    jstep = jax.jit(make_train_step(cfg, jax_build_train_engine(jmodel, cfg),
                                    enable_id_shuffle=False),
                    static_argnums=(5,))
    jstate, jstats = jstep(create_train_state(cfg, params),
                           jnp.asarray(frames), jnp.asarray(masks),
                           jnp.asarray(OBJ_NUMS), jax.random.PRNGKey(7), False)

    model = _port_model(cfg, params)
    state = pstep.create_train_state(cfg, model)
    train_step = pstep.make_train_step(cfg, build_train_engine(model, cfg),
                                       enable_id_shuffle=False)
    stats = train_step(state, torch.from_numpy(frames),
                       torch.from_numpy(masks), torch.tensor(OBJ_NUMS),
                       torch.Generator().manual_seed(7), False)
    assert state.step == 1 and state.optimizer.count == 1
    np.testing.assert_allclose(stats["loss"].item(), float(jstats["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(stats["grad_norm"].item(),
                               float(jstats["grad_norm"]), rtol=1e-4)

    lr = cfg.TRAIN_LR_MIN
    grads = {n: p.grad for n, p in model.named_parameters()}
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())

    def tol(name):
        if name not in grads:                       # buffers: unchanged
            return 0.0
        noise = (grads[name].abs() < floor).numpy()
        return np.where(noise, 2 * lr, lr / 4) + 1e-7

    want, _ = export_state_dict(jstate.params, cfg)
    init, _ = export_state_dict(params, cfg)
    ema, _ = export_state_dict(jstate.ema.shadow, cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0
    for name, val in got.items():
        err = np.abs(val.numpy() - want[name])
        assert (err <= tol(name)).all(), (name, err.max())
        moved += not np.array_equal(want[name], init[name])
    assert moved > 100
    for name, s in state.ema.shadow.items():
        assert (np.abs(s.numpy() - ema[name]) <= tol(name)).all(), name


# --- the Trainer and the CLI ----------------------------------------------


def _trainer_cfg(root, **over):
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TRAIN_DTYPE="float32", PRETRAIN=False,
                       DATASETS=["test"], DATA_RANDOMCROP=(33, 33),
                       DATA_SEQ_LEN=2, TRAIN_BATCH_SIZE=2, DATA_WORKERS=0,
                       TRAIN_TOTAL_STEPS=4, TRAIN_SAVE_STEP=2,
                       TRAIN_MAX_KEEP_CKPT=1, TRAIN_LOG_STEP=1,
                       DIR_ROOT=str(root), **over)
    return cfg.init_dir(make=True)


def test_trainer_two_steps_checkpoint_and_auto_resume(tmp_path):
    from aot_tpu_torch.train.trainer import Trainer
    from aot_tpu_torch.utils import checkpoint as ckpt

    cfg = _trainer_cfg(tmp_path)
    losses_seen = []
    trainer = Trainer(cfg, seed=0, device="cpu")
    trainer.sequential_training(
        max_steps=2, on_step=lambda s, st: losses_seen.append(
            float(st["loss"])))
    assert len(losses_seen) == 2 and np.isfinite(losses_seen).all()
    path = ckpt.latest_checkpoint(cfg.DIR_CKPT)
    assert path.endswith("save_step_2.pth")
    assert ckpt.latest_checkpoint(cfg.DIR_EMA_CKPT).endswith("save_step_2.pth")
    weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    resumed = Trainer(cfg, seed=0, device="cpu")
    assert resumed.start_step == 2 and resumed.state.optimizer.count == 2
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert torch.equal(resumed.state.optimizer.mu[0],
                       trainer.state.optimizer.mu[0])
    resumed.sequential_training()          # on to TRAIN_TOTAL_STEPS = 4
    assert resumed.state.step == 4
    names = sorted(ckpt.list_checkpoints(cfg.DIR_CKPT))
    assert [n.rsplit("_", 1)[-1] for n in names] == ["4.pth"]   # max_keep 1


@pytest.mark.parametrize("argv,match", [
    (["--fp32", "--gpu_num", "2"], "MESH_DP_SIZE=2"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, match):
    """Data parallelism is ported: `--gpu_num 2` without `--device cpu`
    asks for two cards and, with fewer, raises before starting a rank
    (never moving to the CPU)."""
    from aot_tpu_torch.train.__main__ import main

    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA cards are present: the ranks would start")
    base = ["--stage", "pre_ytb_dav", "--datasets", "test",
            "--set", f"DIR_ROOT={str(tmp_path)!r}"]
    with pytest.raises(RuntimeError, match=match + ": no CUDA device"):
        main(base + argv)
