"""The port stands alone: its own copies of the JAX package's JAX-free
modules (configs, data pipeline, C++ augkit, J&F scorer, mask IO) behave as
the originals, and its entry points run on the card unless the CPU is
asked for.

- every copied module is the original with only its import paths changed
  (the augkit loader also repairs the original's build race);
- build_config gives equal dicts from both packages for every model and
  stage of the registries;
- one seeded batch of the synthetic `test` training dataset is equal array
  for array from both loaders;
- without a card, the model builder, Trainer and both CLIs raise unless
  given the CPU."""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from aot_tpu.configs import MODEL_REGISTRY as JAX_MODELS
from aot_tpu.configs import STAGE_REGISTRY as JAX_STAGES
from aot_tpu.configs import build_config as jax_build_config
from aot_tpu.data.loader import TrainLoader as JaxTrainLoader
from aot_tpu.data.train_datasets import build_train_dataset as jax_dataset
from aot_tpu_torch.configs import MODEL_REGISTRY, STAGE_REGISTRY, build_config
from aot_tpu_torch.data.loader import TrainLoader
from aot_tpu_torch.data.train_datasets import build_train_dataset

ROOT = Path(__file__).resolve().parents[1]

# modules copied verbatim but for their import paths (and the comments that
# name the copied files)
COPIES = ["configs/config.py", "configs/models.py", "configs/stages.py",
          "data/__init__.py", "data/loader.py", "data/image_aug.py",
          "data/video_aug.py", "data/native_aug.py", "data/train_datasets.py",
          "data/eval_datasets.py", "native/augkit.cpp", "utils/image.py",
          "utils/eval_pack.py", "utils/meters.py", "eval/metrics.py"]


def _as_port(src: str) -> str:
    src = re.sub(r"^(\s*)(from|import) aot_tpu(\.|\s|$)",
                 r"\1\2 aot_tpu_torch\3", src, flags=re.M)
    return (src.replace("aot_tpu/native/augkit.cpp",
                        "aot_tpu_torch/native/augkit.cpp")
            .replace("aot_tpu/data/native_aug.py",
                     "aot_tpu_torch/data/native_aug.py"))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_import_paths(rel):
    original = (ROOT / "aot_tpu" / rel).read_text()
    assert (ROOT / "aot_tpu_torch" / rel).read_text() == _as_port(original)


def test_augkit_builds_to_a_private_name_then_renames():
    """The port's augkit loader builds to a per-process temporary file and
    renames it into place (the original builds every process to one fixed
    `.tmp` path, so test workers building at once can fail)."""
    src = (ROOT / "aot_tpu_torch" / "native" / "__init__.py").read_text()
    assert 'so_path + ".tmp"' not in src
    assert "os.getpid()" in src and "os.replace(tmp, so_path)" in src
    from aot_tpu_torch import native
    assert native.available()


@pytest.mark.parametrize("model", sorted(JAX_MODELS))
def test_build_config_equal_for_every_stage(model):
    assert sorted(MODEL_REGISTRY) == sorted(JAX_MODELS)
    assert sorted(STAGE_REGISTRY) == sorted(JAX_STAGES)
    for stage in sorted(JAX_STAGES):
        want = jax_build_config(stage=stage, model=model).as_dict()
        got = build_config(stage=stage, model=model).as_dict()
        assert got == want, (stage, model)


def test_train_loader_batch_equal():
    kw = dict(stage="pre_ytb_dav", model="aott", DATASETS=["test"],
              DATA_SEQ_LEN=3)
    batches = []
    for make_cfg, make_ds, loader_cls in (
            (jax_build_config, jax_dataset, JaxTrainLoader),
            (build_config, build_train_dataset, TrainLoader)):
        random.seed(7)
        np.random.seed(7)
        loader = loader_cls(make_ds(make_cfg(**kw)), 2, num_workers=0, seed=3)
        batches.append(next(iter(loader)))
        loader.close()
    want, got = batches
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["frames"].shape == (3, 2, 465, 465, 3)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")


def test_model_builder_and_trainer_default_to_the_card(tmp_path):
    _no_card()
    from aot_tpu_torch.models import build_vos_model
    from aot_tpu_torch.train.trainer import Trainer

    cfg = build_config(stage="pre_ytb_dav", model="aott",
                       TRAIN_DTYPE="float32", DIR_ROOT=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vos_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vos_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_vos_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_clis_default_to_the_card(tmp_path):
    _no_card()
    from aot_tpu_torch.eval import __main__ as eval_cli
    from aot_tpu_torch.train import __main__ as train_cli

    root = f"DIR_ROOT={tmp_path}"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--dataset", "test", "--ckpt_path", "test",
                       "--set", root])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--stage", "pre_ytb_dav", "--fp32", "--datasets",
                        "test", "--set", root])
    assert eval_cli.build_parser().parse_args([]).device is None
    assert train_cli.parse_args([]).device is None
