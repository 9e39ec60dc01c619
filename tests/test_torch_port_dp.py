"""The port's data parallelism on the CPU: two gloo ranks, each a spawned
process (aot_tpu_torch.parallel.launch) with one torch thread, a `file://`
rendezvous under the test's tmp_path, against one process on the same
global batch.

- trainable BN's global moments: the output, the running stats and the
  gradients of the input, weight and bias of two ranks' halves equal one
  process's whole batch (1e-5 of each tensor's largest entry: the sums add
  in another order);
- one AOTT train step, 33x33, T = 2, global batch 4 (2 a rank),
  deterministic, the id shuffle on, with MODEL_FREEZE_BN True and False:
  the loss and grad norm within 1e-5 relative, every updated parameter
  within a quarter of one LR unit (two where the gradient is fp32 noise:
  Adam's first update is ~lr sign(g), tests/test_dp_equivalence.py's
  reasoning) and the running stats within 1e-5 of their scale, and both
  ranks hold the same model;
- the per-frame recompute moves trainable BN's running stats once;
- the CLI (`--device cpu --gpu_num 2`): two steps, only rank 0 prints and
  writes (checkpoints, metrics.jsonl, the image log), then auto-resume;
- the refusals: a world the Trainer was not given, a batch the ranks do
  not divide, more ranks than cards; the checkpoint's backup directory.

This module imports no JAX: the spawned ranks import it by name.
"""

import json
import os

import numpy as np
import pytest
import torch

from aot_tpu_torch import parallel
from aot_tpu_torch.configs import build_config
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.models.encoders.common import TrainableBatchNorm2d
from aot_tpu_torch.ops import attention as att
from aot_tpu_torch.train import step as pstep

SIZE, T, B, RANKS = 33, 2, 4, 2
OBJ_NUMS = [2, 1, 3, 2]
MOMENT_TOL = 1e-5       # of a tensor's largest entry: summation order
LOSS_RTOL = 1e-5
GRAD_FLOOR = 1e-6       # of the model's largest gradient: fp32 noise


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread here and in every spawned rank (the suite runs
    six workers)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_ranks(fn, tmp_path, *args):
    parallel.launch(fn, RANKS, (str(tmp_path),) + args,
                    devices=["cpu"] * RANKS,
                    init_method=f"file://{tmp_path}/rendezvous")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
            for r in range(RANKS)]


# --- trainable BN's global moments ---------------------------------------


def bn_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 6, 7).astype(np.float32) * 2 + 0.5
    cot = rng.randn(4, 5, 6, 7).astype(np.float32)
    affine = rng.uniform(0.5, 1.5, (2, 5)).astype(np.float32)
    return x, cot, affine


def bn_step(x, cot, affine):
    """Train-mode forward and backward of a TrainableBatchNorm2d on x
    (this rank's rows): (y, running mean, running var, dx, dweight,
    dbias)."""
    bn = TrainableBatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(affine[0]))
        bn.bias.copy_(torch.from_numpy(affine[1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    return {"y": y.detach(), "mean": bn.running_mean, "var": bn.running_var,
            "dx": xt.grad, "dw": bn.weight.grad, "db": bn.bias.grad}


def moments_rank(device, out):
    r = parallel.rank()
    x, cot, affine = bn_inputs()
    rows = slice(2 * r, 2 * r + 2)
    res = bn_step(x[rows], cot[rows], affine)
    # the weight's and bias's gradients are each rank's share
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def test_global_moments_and_their_gradients_two_ranks(tmp_path):
    want = bn_step(*bn_inputs())
    got = run_ranks(moments_rank, tmp_path)
    for key in ("y", "dx"):
        cat = torch.cat([g[key] for g in got])
        scale = float(want[key].abs().max())
        assert float((cat - want[key]).abs().max()) <= MOMENT_TOL * scale, key
    for key in ("mean", "var"):
        for g in got:                      # every rank: the global stats
            torch.testing.assert_close(g[key], want[key], rtol=MOMENT_TOL,
                                       atol=MOMENT_TOL)
    for key in ("dw", "db"):               # the ranks' shares add up
        torch.testing.assert_close(got[0][key] + got[1][key], want[key],
                                   rtol=MOMENT_TOL, atol=MOMENT_TOL)
    # per-rank moments would differ: a half's mean is not the whole's
    x, cot, affine = bn_inputs()
    half = bn_step(x[:2], cot[:2], affine)
    assert float((half["mean"] - want["mean"]).abs().max()) > 1e-3


# --- one data-parallel train step ----------------------------------------


def step_cfg(freeze_bn: bool):
    return build_config(stage="pre_ytb_dav", model="aott",
                        TRAIN_DTYPE="float32", TRAIN_LSTT_DROPPATH=0.0,
                        TRAIN_LONG_TERM_MEM_CAP=2, TRAIN_TOTAL_STEPS=1000,
                        MODEL_FREEZE_BN=freeze_bn)


def step_batch():
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (T, B, SIZE, SIZE, 3)).astype(np.uint8)
    masks = np.zeros((T, B, SIZE, SIZE), np.int32)
    for b, n in enumerate(OBJ_NUMS):
        for i in range(1, n + 1):
            y, x = rng.randint(0, SIZE - 10, 2)
            masks[:, b, y:y + 9, x:x + 8] = i
            frames[:, b, y:y + 9, x:x + 8] = 70 * i
    return frames, masks


def one_step(freeze_bn: bool, rows: slice):
    """One deterministic step of a seeded AOTT on the batch's `rows`:
    (stats, gradients, state dict)."""
    cfg = step_cfg(freeze_bn)
    model = build_vos_model(cfg, device="cpu", train=True,
                            generator=torch.Generator().manual_seed(0))
    state = pstep.create_train_state(cfg, model)
    step = pstep.make_train_step(cfg, build_train_engine(model, cfg))
    frames, masks = step_batch()
    stats = step(state, torch.from_numpy(frames[:, rows]),
                 torch.from_numpy(masks[:, rows]),
                 torch.tensor(OBJ_NUMS)[rows],
                 torch.Generator().manual_seed(5), False, deterministic=True)
    return ({k: v for k, v in stats.items() if k != "last_pred"},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            model.state_dict())


def step_rank(device, out, freeze_bn):
    r = parallel.rank()
    half = B // RANKS
    torch.save(one_step(freeze_bn, slice(r * half, (r + 1) * half)),
               os.path.join(out, f"rank{r}.pt"))


@pytest.mark.parametrize("freeze_bn", [True, False])
def test_dp_step_equals_single_process(tmp_path, freeze_bn):
    stats, grads, want = one_step(freeze_bn, slice(0, B))
    got = run_ranks(step_rank, tmp_path, freeze_bn)
    (s0, g0, p0), (s1, g1, p1) = got
    for key in ("loss", "grad_norm", "aux_loss", "pred_loss"):
        np.testing.assert_allclose(float(s0[key]), float(stats[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
        assert float(s0[key]) == float(s1[key]), key
    for name in p0:                         # the ranks hold one model
        assert torch.equal(p0[name], p1[name]), name
    lr = step_cfg(freeze_bn).TRAIN_LR_MIN
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())
    init = build_vos_model(step_cfg(freeze_bn), device="cpu", train=True,
                           generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    moved = 0
    for name, val in p0.items():
        if name in grads:                   # parameters: LR units
            noise = grads[name].abs() < floor
            tol = torch.where(noise, 2 * lr, lr / 4) + 1e-7
            err = (val - want[name]).abs()
            assert bool((err <= tol).all()), (name, float(err.max()))
        else:                               # buffers: the running stats
            scale = float(want[name].abs().max())
            assert float((val - want[name]).abs().max()) <= (
                MOMENT_TOL * scale + 1e-7), name
            moved += not torch.equal(val, init[name])
    assert (moved > 0) == (not freeze_bn)


# --- the recompute and the running stats --------------------------------


def test_recompute_moves_the_running_stats_once():
    """With the per-frame recompute on, one step runs each trainable BN in
    batch mode once: its running mean is one momentum step from its init
    toward the encoder pass's batch mean."""
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TRAIN_DTYPE="float32", TRAIN_LSTT_DROPPATH=0.0,
                       TRAIN_LONG_TERM_MEM_CAP=2, MODEL_FREEZE_BN=False)
    model = build_vos_model(cfg, device="cpu", train=True)
    eng = build_train_engine(model, cfg)
    assert eng.remat
    bns = [m for m in model.modules() if isinstance(m, TrainableBatchNorm2d)]
    assert len(bns) == 52
    calls, means = [], {}

    def hook(mod, inputs, _):
        calls.append(mod)
        x = inputs[0].detach().float()
        means[mod] = x.mean(dim=(0, 2, 3))

    handles = [bn.register_forward_hook(hook) for bn in bns]
    frames, masks = step_batch()
    with att.attn_training_context():
        loss, _ = eng.forward(torch.from_numpy(frames),
                              torch.from_numpy(masks),
                              torch.tensor(OBJ_NUMS), 0.0)
        loss.backward()
    for h in handles:
        h.remove()
    assert len(calls) == len(bns) and set(calls) == set(bns)
    for bn in bns:
        torch.testing.assert_close(bn.running_mean, 0.1 * means[bn],
                                   rtol=1e-5, atol=1e-6)
    assert bns[0].weight.grad is not None


# --- the CLI on two gloo ranks -------------------------------------------


def cli_args(tmp_path, steps: int):
    return ["--stage", "pre_ytb_dav", "--datasets", "test", "--device",
            "cpu", "--gpu_num", "2", "--fp32", "--batch_size", "4",
            "--total_steps", str(steps), "--save_step", "2", "--log_step",
            "1", "--data_workers", "0", "--exp_name", "dp",
            "--dist_url", f"file://{tmp_path}/rendezvous_{steps}",
            "--set", f"DIR_ROOT={str(tmp_path)!r}",
            "--set", "DATA_RANDOMCROP=(33, 33)", "--set", "DATA_SEQ_LEN=2",
            "--set", "PRETRAIN=False", "--set", "MODEL_FREEZE_BN=False",
            "--set", "TRAIN_TBLOG_STEP=2"]


def test_cli_two_gloo_ranks_rank0_writes_then_auto_resumes(tmp_path, capfd):
    from aot_tpu_torch.train.__main__ import main
    from aot_tpu_torch.utils import checkpoint as ckpt

    main(cli_args(tmp_path, 2))
    out = capfd.readouterr().out
    assert out.count("[trainer] AOTT on cpu, float32, ranks: 2") == 1
    assert out.count("[trainer] step ") == 2 and "(avg " in out
    cfg = build_config(stage="pre_ytb_dav", model="aott", exp_name="dp",
                       DIR_ROOT=str(tmp_path))
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(cfg.DIR_CKPT)
            ] == ["save_step_2.pth"]
    raw = ckpt.load_checkpoint(ckpt.latest_checkpoint(cfg.DIR_CKPT))
    assert raw["step"] == 2
    assert "encoder.features.0.1.running_var" in raw["model"]
    lines = [json.loads(l) for l in
             open(os.path.join(cfg.DIR_LOG, "metrics.jsonl"))]
    assert [rec["step"] for rec in lines] == [1, 2]
    assert {"loss", "aux_loss", "pred_loss", "iou", "grad_norm",
            "sec_per_it"} <= set(lines[0])
    assert os.listdir(cfg.DIR_IMG_LOG) == ["step_2.jpg"]

    main(cli_args(tmp_path, 3))              # auto-resumes at step 2
    out = capfd.readouterr().out
    assert "auto-resumed" in out and out.count("[trainer] step ") == 1
    assert ckpt.load_checkpoint(
        ckpt.latest_checkpoint(cfg.DIR_CKPT))["step"] == 3
    lines = open(os.path.join(cfg.DIR_LOG, "metrics.jsonl")).readlines()
    assert [json.loads(l)["step"] for l in lines] == [1, 2, 3]


# --- refusals and the backup directory -----------------------------------


def test_refusals(tmp_path):
    from aot_tpu_torch.train.trainer import Trainer

    cfg = build_config(stage="pre_ytb_dav", model="aott", MESH_DP_SIZE=2,
                       DIR_ROOT=str(tmp_path))
    with pytest.raises(ValueError, match="MESH_DP_SIZE=2 but 1 rank"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="batch 6 not divisible by 4"):
        parallel.local_batch(6, 4)
    assert parallel.local_batch(16, 4) == 4
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.rank_devices(64)
    assert parallel.rank_devices(3, "cpu") == ["cpu"] * 3
    assert parallel.dp_world_size(cfg, "cpu") == 2
    cfg.MESH_DP_SIZE = -1
    assert parallel.dp_world_size(cfg, "cpu") == 1


def test_checkpoint_falls_back_to_the_backup_dir(tmp_path):
    from aot_tpu_torch.utils import checkpoint as ckpt

    blocked = tmp_path / "ckpt"
    blocked.write_text("a file where the directory should be")
    backup = tmp_path / "backup" / "ckpt"
    for step in (1, 2, 3):
        path = ckpt.save_checkpoint(str(blocked), step, {"step": step},
                                    max_keep=2, backup_dir=str(backup))
        assert path == str(backup / f"save_step_{step}.pth")
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(str(backup))
            ] == ["save_step_2.pth", "save_step_3.pth"]
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(blocked), 4, {"step": 4})
