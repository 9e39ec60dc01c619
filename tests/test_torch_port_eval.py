"""The port's evaluator (aot_tpu_torch.eval) against aot_tpu's Evaluator on
the CPU, with the same weights, over dataset folders the test writes with
PIL: a DAVIS-2017 layout (2 sequences x 6 frames at 129x161, 3 objects)
and a Demo layout in which a 4th object arrives at frame 3.

Each side feeds back its own masks, so per frame the written PNGs must
agree on >= 99.9% of pixels (argmax near-ties may flip a few); the JAX side
runs its own default ATTN_IMPL. Also: the port's J&F scorer against the
JAX one on the same result folder, the CLI's config overrides against
tools/eval.py's, the evaluator's cuDNN autotuning kept to its own run, and
the knobs that are not ported raise."""

import argparse
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from aot_tpu.configs import build_config
from aot_tpu.eval import metrics as jax_metrics
from aot_tpu.eval.evaluator import Evaluator as JaxEvaluator
from aot_tpu_torch.configs import build_config as port_build_config
from aot_tpu_torch.eval import Evaluator
from aot_tpu_torch.eval import __main__ as cli
from aot_tpu_torch.eval import metrics
from aot_tpu_torch.utils.image import vos_palette
from test_torch_port_model import jax_aott, port_aott

ROOT = Path(__file__).resolve().parents[1]
H, W = 129, 161
FRAMES = 6
MASK_AGREE = 0.999


def _clip(seed: int, objects: int, arrive: int = -1):
    """Seeded frames (uint8 RGB) of moving ellipses on a noisy gradient and
    their label maps; object `objects` (if arrive >= 0) enters at frame
    `arrive`."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([yy / H, xx / W, (yy + xx) / (H + W)], -1) * 160
    centre = rng.uniform(0.25, 0.75, (objects, 2)) * (H, W)
    radius = rng.uniform(0.1, 0.2, (objects, 2)) * (H, W)
    speed = rng.uniform(-3.0, 3.0, (objects, 2))
    colour = rng.uniform(40, 255, (objects, 3))
    frames, labels = [], []
    for t in range(FRAMES):
        img = base + rng.normal(0, 8, base.shape)
        lab = np.zeros((H, W), np.uint8)
        for i in range(objects):
            if arrive >= 0 and i == objects - 1 and t < arrive:
                continue
            cy, cx = centre[i] + t * speed[i]
            inside = (((yy - cy) / radius[i, 0]) ** 2
                      + ((xx - cx) / radius[i, 1]) ** 2) <= 1
            img[inside] = colour[i]
            lab[inside] = i + 1
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        labels.append(lab)
    return frames, labels


def _save_label(lab: np.ndarray, path: Path) -> None:
    im = Image.fromarray(lab).convert("P")
    im.putpalette(vos_palette())
    im.save(path)


def _write_davis(root: Path):
    """DAVIS-2017 layout, every frame annotated (as DAVIS val is; the
    evaluator reads only the first)."""
    seqs = ["bear", "car"]
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("\n".join(seqs))
    for si, seq in enumerate(seqs):
        img_dir = root / "JPEGImages" / "480p" / seq
        ann_dir = root / "Annotations" / "480p" / seq
        img_dir.mkdir(parents=True)
        ann_dir.mkdir(parents=True)
        for t, (img, lab) in enumerate(zip(*_clip(10 + si, 3))):
            Image.fromarray(img).save(img_dir / f"{t:05d}.jpg", quality=95)
            _save_label(lab, ann_dir / f"{t:05d}.png")


def _write_demo(root: Path):
    """datasets/Demo layout: images/<seq>/*.jpg, masks/<seq>/ holding the
    first frame's mask and the one where a 4th object arrives."""
    img_dir = root / "Demo" / "images" / "walk"
    ann_dir = root / "Demo" / "masks" / "walk"
    img_dir.mkdir(parents=True)
    ann_dir.mkdir(parents=True)
    for t, (img, lab) in enumerate(zip(*_clip(20, 4, arrive=3))):
        Image.fromarray(img).save(img_dir / f"{t:05d}.jpg", quality=95)
        if t in (0, 3):
            _save_label(lab, ann_dir / f"{t:05d}.png")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    _write_davis(root / "DAVIS")
    _write_demo(root)
    cfg = build_config(stage="pre_ytb_dav", model="aott")
    jmodel, params = jax_aott(cfg)
    return root, jmodel, params, port_aott(cfg, params)


CASES = {
    "plain": {},
    "flip_ms": dict(TEST_FLIP=True, TEST_MULTISCALE=[1.0, 1.3]),
    "prev_prob": dict(MODEL_USE_PREV_PROB=True),
}


def _run_both(data, out: Path, dataset: str, over: dict):
    root, jmodel, params, model = data
    kw = dict(stage="pre_ytb_dav", model="aott", TEST_DATASET=dataset,
              DIR_DATA=str(root), **over)
    jcfg, pcfg = build_config(**kw), port_build_config(**kw)
    JaxEvaluator(jcfg, jmodel, params, result_root=str(out / "jax")).evaluate()
    summary = Evaluator(pcfg, model, result_root=str(out / "port"),
                        device="cpu").evaluate()
    return summary


def _agreement(out: Path):
    """{(seq, frame): share of equal pixels} over the JAX side's PNGs."""
    agree = {}
    for f in sorted((out / "jax").rglob("*.png")):
        rel = f.relative_to(out / "jax")
        a = np.array(Image.open(f))
        b = np.array(Image.open(out / "port" / rel))
        assert a.shape == b.shape, rel
        agree[str(rel)] = float((a == b).mean())
    return agree


@pytest.mark.parametrize("case", list(CASES))
def test_davis_matches_jax_evaluator(data, tmp_path, case):
    summary = _run_both(data, tmp_path, "davis2017", CASES[case])
    agree = _agreement(tmp_path)
    assert len(agree) == 2 * (FRAMES - 1)
    assert min(agree.values()) >= MASK_AGREE, agree
    assert summary["sequences"] == 2
    assert summary["total_frames"] == 2 * (FRAMES - 1)
    assert all(len(s["frame_times"]) == FRAMES - 1
               for s in summary["per_sequence"])
    if case == "plain":
        # the port's scorer and the JAX one on the port's result folder
        gt = data[0] / "DAVIS" / "Annotations" / "480p"
        got = metrics.evaluate_davis(str(tmp_path / "port"), str(gt),
                                     verbose=False)
        want = jax_metrics.evaluate_davis(str(tmp_path / "port"), str(gt),
                                          verbose=False)
        assert got == want


@pytest.mark.parametrize("case", ["plain", "prev_prob"])
def test_demo_mid_video_arrival_matches_jax_evaluator(data, tmp_path, case):
    """A 4th object arrives at frame 3: the ground truth overwrites the
    prediction and re-references the state on both sides."""
    _run_both(data, tmp_path, "demo", CASES[case])
    agree = _agreement(tmp_path)
    assert len(agree) == FRAMES - 1
    assert min(agree.values()) >= MASK_AGREE, agree
    arrived = np.array(Image.open(tmp_path / "port" / "walk" / "00003.png"))
    assert 4 in np.unique(arrived)


@pytest.mark.parametrize("autotune", [True, False])
def test_evaluate_scopes_cudnn_benchmark(data, tmp_path, monkeypatch,
                                         autotune):
    """Evaluator.evaluate sets torch.backends.cudnn.benchmark to its own
    choice for every sequence and gives the caller's setting back."""
    root, _, _, model = data
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            TEST_DATASET="davis2017", DIR_DATA=str(root))
    seen = []

    def eval_sequence(self, seq):
        seen.append(torch.backends.cudnn.benchmark)
        return {"seq_name": seq.seq_name, "timed_frames": 1, "time": 1.0,
                "fps": 1.0}

    monkeypatch.setattr(Evaluator, "eval_sequence", eval_sequence)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", not autotune)
    summary = Evaluator(cfg, model, result_root=str(tmp_path), device="cpu",
                        cudnn_benchmark=autotune).evaluate()
    assert summary["sequences"] == 2
    assert seen == [autotune, autotune]
    assert torch.backends.cudnn.benchmark is (not autotune)


def _tools_eval():
    spec = importlib.util.spec_from_file_location("tools_eval",
                                                  ROOT / "tools" / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "davis2017", "--max_resolution", "1080"],
    ["--dataset", "youtubevos", "--split", "valid", "--ms", "1.0", "1.3",
     "--flip"],
    ["--lt_gap", "5", "--st_skip", "2", "--mem_cap", "8", "--lstt_num", "2",
     "--max_id_num", "15", "--ema", "--ckpt_step", "100"],
])
def test_cli_overrides_match_tools_eval(argv):
    tools = _tools_eval()
    want = tools.build_overrides(tools.build_parser().parse_args(argv))
    got = cli.build_overrides(cli.build_parser().parse_args(argv))
    assert got == want


def test_cli_grid_at_davis_full_resolution():
    """--max_resolution 1080 with TEST_DATASET_FULL_RESOLUTION: a 1080x1920
    frame is snapped to 1009x1793, a 64x113 = 7,232-token grid, above
    aot_tpu's threshold for its wide kernel."""
    from aot_tpu.ops.attention import _DENSE_LOCAL_MAX_TOKENS
    from aot_tpu_torch.data.video_aug import restrict_size

    args = cli.build_parser().parse_args(
        ["--dataset", "davis2017", "--max_resolution", "1080",
         "--set", "TEST_DATASET_FULL_RESOLUTION=True"])
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            **cli.build_overrides(args))
    assert cfg.TEST_DATASET_FULL_RESOLUTION is True
    hgt, wid = restrict_size(1080, 1920, 1.0, cfg.TEST_MAX_SHORT_EDGE,
                             cfg.TEST_MAX_LONG_EDGE, cfg.MODEL_ALIGN_CORNERS)
    assert (hgt, wid) == (1009, 1793)
    grid = ((hgt - 1) // 16 + 1, (wid - 1) // 16 + 1)
    assert grid == (64, 113) and grid[0] * grid[1] > _DENSE_LOCAL_MAX_TOKENS
