"""The port's attention knobs and its training CLI against aot_tpu's.

- For each ATTN_IMPL, `use_flash` and `local_route` route as aot_tpu's
  `_use_flash`, `_use_local_kernel` and `local_attention` do, "the TPU"
  read as "a CUDA tensor": the JAX side runs under its own `set_attn_impl`
  with `jax.default_backend` reporting "tpu" (a CPU tensor against JAX's
  CPU backend for the modes that route alike there), and its local routes
  are read off stand-ins for the functions `local_attention` calls.
- Each ATTN_* threshold key through `build_infer_engine`, and each
  AOT_TPU_* environment variable at import (in a subprocess), moves the
  port's switch; `--set ATTN_IMPL=reference` on the eval CLI reaches the
  engine.
- The training CLI's `config_overrides` equal tools/train.py's for the same
  argv, read off tools/train.py's own main with its config builder and
  Trainer stubbed.

No kernel runs, no model is built: a few seconds in all.
"""

import os
import subprocess
import sys
import types

import jax
import pytest
import torch

import aot_tpu.ops.attention as jatt
import aot_tpu.ops.pallas.local_window_attn as jlwa
from aot_tpu_torch.configs import build_config
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.ops import attention as att

IMPLS = ("auto", "xla", "reference", "window", "pallas")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_knobs():
    """Both packages' modes and thresholds back to their defaults after
    each test."""
    saved = (att.FLASH_MIN_KEYS_BF16, att.FLASH_MIN_KEYS,
             att.DENSE_LOCAL_MAX_TOKENS)
    jsaved = (jatt._FLASH_MIN_KEYS_BF16, jatt._FLASH_MIN_KEYS_FP32,
              jatt._DENSE_LOCAL_MAX_TOKENS)
    torch.set_num_threads(1)
    yield
    att.set_attn_impl("auto")
    att.set_attn_thresholds(*saved)
    jatt.set_attn_impl("auto")
    jatt.set_attn_thresholds(*jsaved)


@pytest.fixture
def jax_on(monkeypatch):
    """Set aot_tpu's mode and report `backend` as JAX's default backend."""
    def set_mode(impl: str, backend: str):
        jatt.set_attn_impl(impl)
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
    return set_mode


# (Lk, valid_len, top_k, max_mem_len_ratio, bf16)
FLASH_CASES = [(900, None, -1, -1.0, False), (900, 900, -1, -1.0, False),
               (8192, 8192, -1, -1.0, False), (8191, 8191, -1, -1.0, False),
               (4096, 4096, -1, -1.0, True), (4095, 4095, -1, -1.0, True),
               (20000, None, -1, -1.0, False), (20000, 20000, 40, -1.0, False),
               (20000, 20000, -1, 1.2, True)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("training", [False, True])
def test_use_flash_routes_as_aot_tpu(impl, training, jax_on):
    att.set_attn_impl(impl)
    jax_on(impl, "tpu")
    for lk, valid, top_k, ratio, bf16 in FLASH_CASES:
        jdt = jax.numpy.bfloat16 if bf16 else jax.numpy.float32
        tdt = torch.bfloat16 if bf16 else torch.float32
        if training:
            with jatt.attn_training_context(), att.attn_training_context():
                want = jatt._use_flash(lk, valid, top_k, ratio, jdt)
                got = att.use_flash(lk, valid, top_k, ratio, tdt)
        else:
            want = jatt._use_flash(lk, valid, top_k, ratio, jdt)
            got = att.use_flash(lk, valid, top_k, ratio, tdt)
        assert got == want, (impl, training, lk, valid, top_k, ratio, bf16)


@pytest.mark.parametrize("impl", ["xla", "reference", "pallas"])
def test_use_flash_on_the_cpu_as_aot_tpu_on_its_cpu(impl, jax_on):
    """The modes that route a CPU tensor as JAX routes its CPU backend
    ('auto' differs there by design: a CPU tensor over a long memory takes
    the flash path's plain version, the same function)."""
    att.set_attn_impl(impl)
    jax_on(impl, "cpu")
    for lk, valid, top_k, ratio, bf16 in FLASH_CASES:
        jdt = jax.numpy.bfloat16 if bf16 else jax.numpy.float32
        tdt = torch.bfloat16 if bf16 else torch.float32
        assert (att.use_flash(lk, valid, top_k, ratio, tdt)
                == jatt._use_flash(lk, valid, top_k, ratio, jdt))


def _jax_local_route(monkeypatch, size, dilation, training):
    """Which function aot_tpu's local_attention calls for a (1, HW, 8*32)
    read at `size`: 'wide' or 'flat' (its kernels), 'window' (the window
    form) or 'plain' (banded or dense)."""
    called = []

    def stub(name):
        def fn(*args, **kwargs):
            called.append(name)
            return None
        return fn

    monkeypatch.setattr(jlwa, "local_window_attention_wide", stub("wide"))
    monkeypatch.setattr(jlwa, "local_window_attention_flat", stub("flat"))
    monkeypatch.setattr(jatt, "local_attention_window", stub("window"))
    monkeypatch.setattr(jatt, "local_attention_banded", stub("plain"))
    monkeypatch.setattr(jatt, "_local_attention_dense", stub("plain"))
    hw = size[0] * size[1]
    q = types.SimpleNamespace(shape=(1, hw, 8 * 32))
    kw = dict(num_heads=8, size_2d=size, max_dis=7, dilation=dilation)
    if training:
        with jatt.attn_training_context():
            jatt.local_attention(q, q, q, None, None, **kw)
    else:
        jatt.local_attention(q, q, q, None, None, **kw)
    return called[0]


def _kernel_of(route: str) -> str:
    """A route by the kernel it launches ('none' for every plain form)."""
    return route if route in ("flat", "wide") else "none"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size", [(30, 30), (64, 113)])
@pytest.mark.parametrize("training", [False, True])
def test_local_route_as_aot_tpu(impl, size, training, jax_on, monkeypatch):
    """A card tensor at dilation 1 against the TPU: the same kernel (or
    none), and the window form wherever ATTN_IMPL 'window' asks for it."""
    att.set_attn_impl(impl)
    jax_on(impl, "tpu")
    want = _jax_local_route(monkeypatch, size, 1, training)
    got = att.local_route(size[0] * size[1], "cuda", 1, training)
    assert _kernel_of(got) == _kernel_of(want), (impl, size, training)
    if impl == "window" or training:
        assert got == "window" and want in ("window", "plain")
    if impl in ("xla", "reference") and not training:
        assert got == "plain"


def test_local_route_thresholds_and_the_cpu():
    att.set_attn_thresholds(dense_local_max_tokens=500)
    assert att.local_route(900, "cuda", 1, False) == "wide"
    att.set_attn_thresholds(dense_local_max_tokens=1000)
    assert att.local_route(900, "cuda", 1, False) == "flat"
    for impl in IMPLS:
        att.set_attn_impl(impl)
        assert att.local_route(900, "cpu", 1, False) == (
            "window" if impl == "window" else "plain")
        assert att.local_route(900, "cuda", 2, False) == (
            "window" if impl == "window" else
            "plain" if impl in ("xla", "reference") else "none")
    with pytest.raises(ValueError):
        att.set_attn_impl("tpu")


def test_build_infer_engine_applies_the_config(tmp_path):
    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       DIR_ROOT=str(tmp_path), ATTN_IMPL="pallas",
                       ATTN_FLASH_MIN_KEYS_FP32=100,
                       ATTN_FLASH_MIN_KEYS_BF16=50,
                       ATTN_DENSE_LOCAL_MAX_TOKENS=400)
    build_infer_engine(None, cfg)
    assert att.attn_impl() == "pallas"
    assert (att.FLASH_MIN_KEYS, att.FLASH_MIN_KEYS_BF16,
            att.DENSE_LOCAL_MAX_TOKENS) == (100, 50, 400)
    att.set_attn_impl("auto")
    assert att.use_flash(100, 100, -1, -1.0)
    assert not att.use_flash(99, 99, -1, -1.0)
    assert att.use_flash(50, 50, -1, -1.0, torch.bfloat16)
    assert att.local_route(401, "cuda", 1, False) == "wide"
    # None keeps a threshold; the mode goes back to the config's
    build_infer_engine(None, build_config(stage="pre_ytb_dav", model="aott",
                                          DIR_ROOT=str(tmp_path)))
    assert att.attn_impl() == "auto" and att.FLASH_MIN_KEYS == 100


def test_environment_variables_set_the_defaults():
    env = dict(os.environ, AOT_TPU_FLASH_MIN_KEYS_BF16="123",
               AOT_TPU_FLASH_MIN_KEYS_FP32="456",
               AOT_TPU_DENSE_LOCAL_MAX_TOKENS="789", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c",
         "import aot_tpu_torch.ops.attention as a; print(a.FLASH_MIN_KEYS_BF16,"
         " a.FLASH_MIN_KEYS, a.DENSE_LOCAL_MAX_TOKENS, a.use_flash(456, 456,"
         " -1, -1.0), a.use_flash(455, 455, -1, -1.0), a.local_route(790,"
         " 'cuda', 1, False))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    assert out.stdout.split() == ["123", "456", "789", "True", "False",
                                  "wide"]


def test_eval_cli_set_reaches_the_engine(tmp_path, monkeypatch):
    from aot_tpu_torch.eval import __main__ as cli
    from aot_tpu_torch.eval.evaluator import Evaluator

    monkeypatch.setattr(cli, "load_model", lambda *a: torch.nn.Identity())
    monkeypatch.setattr(Evaluator, "evaluate", lambda self: {})
    ev, _ = cli.run(["--dataset", "test", "--ckpt_path", "test", "--device",
                     "cpu", "--set", f"DIR_ROOT={tmp_path}", "--set",
                     "ATTN_IMPL=reference", "--set",
                     "ATTN_FLASH_MIN_KEYS_FP32=321"])
    assert ev.cfg.ATTN_IMPL == "reference"
    assert att.attn_impl() == "reference" and att.FLASH_MIN_KEYS == 321
    assert not att.use_flash(20000, 20000, -1, -1.0)


TRAIN_ARGV = ["--max_id_num", "5", "--amp", "--gpu_num", "2", "--fp32",
              "--batch_size", "4", "--set", "X=1", "--total_steps", "7",
              "--lr", "0.1", "--datasets", "test", "--data_workers", "0",
              "--log_step", "3", "--save_step", "9", "--pretrained_path",
              "w.pth", "--set", "NAME=abc"]


def _tools_train_overrides(monkeypatch, argv):
    """tools/train.py's config overrides for `argv`, from its own main: the
    config builder records them and the Trainer does nothing."""
    import aot_tpu.configs as jcfg
    import aot_tpu.train.trainer as jtrainer

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import train as tools_train
    finally:
        sys.path.pop(0)
    seen = {}

    def fake_build(stage, model, exp_name, make_dirs, **over):
        seen.update(over)
        return None

    class FakeTrainer:
        def __init__(self, *a, **k):
            pass

        def sequential_training(self):
            pass

    monkeypatch.setattr(jcfg, "build_config", fake_build)
    monkeypatch.setattr(jtrainer, "Trainer", FakeTrainer)
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    tools_train.main()
    return seen


@pytest.mark.parametrize("argv", [TRAIN_ARGV[:10], TRAIN_ARGV, []])
def test_train_cli_overrides_as_tools_train(argv, monkeypatch):
    from aot_tpu_torch.train.__main__ import config_overrides, parse_args

    got = config_overrides(parse_args(argv))
    want = _tools_train_overrides(monkeypatch, argv)
    assert got == want
    if "--gpu_num" in argv:
        assert got["TRAIN_GPUS"] == got["MESH_DP_SIZE"] == 2
        assert got["MODEL_MAX_OBJ_NUM"] == 5
