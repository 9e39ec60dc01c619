"""The port's entry points (aot_tpu_torch.tools, utils.logging.ProfilerHook,
utils/weights.load_model) against the JAX package's tools on the CPU.

- demo: tools/demo.py's main (JAX) and the port's demo on one .pth written
  by aot_tpu's save_torch_checkpoint from seeded AOTT parameters, over a
  Demo folder the test writes from chip_smoke.ellipse_clip (2 sequences x
  6 frames at 240x320, 3 objects, stepped at 129x161): per frame the PNGs
  agree on >= 99.9% of pixels (argmax near-ties may flip a few), as
  tests/test_torch_port_eval.py holds the evaluators. Port only:
  --frame_chunk 4 writes the per-frame PNGs bit for bit, and the overlay
  video holds a frame a frame.
- score: the port's command prints tools/score.py's JSON line.
- overfit_check: the npz batch and stream each tool writes load in the
  other, the logged lines carry tools/overfit_check.py's keys, and
  --init_pth loads strictly.
- ProfilerHook writes a Chrome trace with the program's spans on their own
  track; stop without a trace does nothing.
- load_model takes DistributedDataParallel's 'module.'-prefixed keys, as
  aot_tpu's loader does.

tools/demo.py and the JAX Trainer call aot_tpu.utils.runtime.setup_runtime,
which sets JAX config for the whole process (the default matmul precision
among it); the tests stub it so the rest of the worker keeps the suite's
settings.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import aot_tpu.utils.runtime as jax_runtime
from aot_tpu.configs import build_config
from aot_tpu.utils.torch_import import save_torch_checkpoint
from aot_tpu_torch.configs import build_config as port_build_config
from aot_tpu_torch.utils.weights import load_model
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.tools import demo, overfit_check, score
from aot_tpu_torch.utils.image import vos_palette
from aot_tpu_torch.utils import tracing
from aot_tpu_torch.utils.logging import ProfilerHook
from chip_smoke import ellipse_clip
from test_torch_port_model import jax_aott

ROOT = Path(__file__).resolve().parents[1]
H, W = 240, 320           # frames; --max_resolution 100 steps them at 129x161
FRAMES = 6
OBJECTS = 3
MASK_AGREE = 0.999
SEQS = ("bear", "car")
ELLIPSES = dict(speed=4.0, radius=(0.1, 0.2))  # ellipse_clip's motion, size


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One torch intra-op thread (the suite's workers share the cores), and
    aot_tpu's process-wide runtime setup stubbed out."""
    monkeypatch.setattr(jax_runtime, "setup_runtime", lambda *a, **k: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tool(name: str):
    """tools/<name>.py, the JAX package's command, as a module."""
    spec = importlib.util.spec_from_file_location(f"tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(monkeypatch, name: str, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + list(argv))
    return _tool(name).main()


def _save_label(lab: np.ndarray, path: Path) -> None:
    im = Image.fromarray(lab).convert("P")
    im.putpalette(vos_palette())
    im.save(path)


@pytest.fixture(scope="module")
def demo_data(tmp_path_factory):
    """A Demo folder (images/<seq>/*.jpg, masks/<seq>/00000.png), every
    frame's ground truth in an Annotations folder, and one .pth of seeded
    AOTT parameters."""
    root = tmp_path_factory.mktemp("demo_data")
    for si, seq in enumerate(SEQS):
        img_dir = root / "Demo" / "images" / seq
        mask_dir = root / "Demo" / "masks" / seq
        ann_dir = root / "Annotations" / seq
        for d in (img_dir, mask_dir, ann_dir):
            d.mkdir(parents=True)
        for t, (img, lab) in enumerate(zip(*ellipse_clip(
                30 + si, FRAMES, (H, W), OBJECTS, **ELLIPSES))):
            Image.fromarray(img).save(img_dir / f"{t:05d}.jpg", quality=95)
            _save_label(lab, ann_dir / f"{t:05d}.png")
            if t == 0:
                _save_label(lab, mask_dir / f"{t:05d}.png")
    cfg = build_config(stage="pre_ytb_dav", model="aott")
    _, params = jax_aott(cfg, seed=3)
    pth = root / "aott.pth"
    assert save_torch_checkpoint(str(pth), params, cfg) == []
    return root, pth


def _port_demo(data, out: Path, *extra):
    root, pth = data
    return demo.main(["--model", "aott", "--ckpt_path", str(pth),
                      "--data_path", str(root / "Demo"), "--output_path",
                      str(out), "--max_resolution", "100", "--device", "cpu",
                      *extra])


def _pngs(out: Path):
    return {str(f.relative_to(out)): np.array(Image.open(f))
            for f in sorted(out.rglob("*.png"))}


def test_demo_matches_jax_demo(demo_data, tmp_path, monkeypatch):
    root, pth = demo_data
    _run_jax_tool(monkeypatch, "demo", [
        "--model", "aott", "--ckpt_path", str(pth), "--data_path",
        str(root / "Demo"), "--output_path", str(tmp_path / "jax"),
        "--max_resolution", "100", "--no_video"])
    stats = _port_demo(demo_data, tmp_path / "port", "--no_video")
    assert [s["frames"] for s in stats] == [FRAMES - 1] * len(SEQS)
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == FRAMES * len(SEQS)
    agree = {}
    for name, a in want.items():
        assert got[name].shape == a.shape == (H, W), name
        agree[name] = float((got[name] == a).mean())
    assert min(agree.values()) >= MASK_AGREE, agree
    # the masks are not all background: the check compares objects
    assert all(len(np.unique(got[f"{s}/00005.png"])) > 1 for s in SEQS)


def test_demo_frame_chunk_equals_per_frame_and_writes_video(demo_data,
                                                            tmp_path):
    import cv2

    _port_demo(demo_data, tmp_path / "frame", "--no_video")
    _port_demo(demo_data, tmp_path / "chunk", "--frame_chunk", "4")
    want, got = _pngs(tmp_path / "frame"), _pngs(tmp_path / "chunk")
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, name)
    assert not list((tmp_path / "frame").glob("*.avi"))
    for seq in SEQS:
        cap = cv2.VideoCapture(str(tmp_path / "chunk" / f"{seq}.avi"))
        try:
            n = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                assert frame.shape == (H, W, 3)
                n += 1
        finally:
            cap.release()
        assert n == FRAMES


def test_score_prints_the_jax_tools_json(demo_data, tmp_path, monkeypatch,
                                         capsys):
    root, _ = demo_data
    _port_demo(demo_data, tmp_path / "port", "--no_video")
    argv = [str(tmp_path / "port"), str(root / "Annotations"), "--json"]
    capsys.readouterr()
    _run_jax_tool(monkeypatch, "score", argv)
    want = capsys.readouterr().out.strip().splitlines()
    score.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert json.loads(got[0]) == json.loads(want[0])
    assert json.loads(got[0])["sequences"] == len(SEQS)


# --- the overfit check --------------------------------------------------------

NPZ_KEYS = ("frames", "labels", "obj_nums")
OVERFIT = ["--batch", "1", "--crop", "65"]


@pytest.fixture()
def static_dir(tmp_path, monkeypatch):
    """A Static-pretrain folder (datasets/Static/{JPEGImages,Annotations}/
    COCO) of 4 annotated images under a fresh working directory, where the
    tools' config finds it and writes its run folders."""
    img_dir = tmp_path / "datasets" / "Static" / "JPEGImages" / "COCO"
    ann_dir = tmp_path / "datasets" / "Static" / "Annotations" / "COCO"
    img_dir.mkdir(parents=True)
    ann_dir.mkdir(parents=True)
    for i in range(4):
        imgs, labels = ellipse_clip(40 + i, 1, (96, 128), 2, **ELLIPSES)
        Image.fromarray(imgs[0]).save(img_dir / f"{i:05d}.jpg", quality=95)
        _save_label(labels[0], ann_dir / f"{i:05d}.png")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _same_npz(a, b):
    assert sorted(a) == sorted(b) == sorted(NPZ_KEYS)
    for k in NPZ_KEYS:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], k)


def test_overfit_npz_loads_in_either_tool(static_dir, monkeypatch):
    """A batch (and a stream of 2) sampled by each tool has the other's
    keys, shapes and dtypes, and each tool reloads the other's file
    unchanged (--batch_npz / --stream_npz, then --dump_batch)."""
    d = static_dir
    _run_jax_tool(monkeypatch, "overfit_check",
                  OVERFIT + ["--dump_batch", str(d / "jax.npz")])
    overfit_check.main(OVERFIT + ["--dump_batch", str(d / "port.npz"),
                                  "--device", "cpu"])
    jax_b, port_b = _npz(d / "jax.npz"), _npz(d / "port.npz")
    for k in NPZ_KEYS:
        assert jax_b[k].dtype == port_b[k].dtype, k
        assert jax_b[k].shape == port_b[k].shape, k
    assert port_b["frames"].shape[:4] == (5, 1, 65, 65)
    overfit_check.main(["--batch_npz", str(d / "jax.npz"), "--dump_batch",
                        str(d / "jax_in_port.npz"), "--device", "cpu"])
    _same_npz(_npz(d / "jax_in_port.npz"), jax_b)
    _run_jax_tool(monkeypatch, "overfit_check",
                  ["--batch_npz", str(d / "port.npz"), "--dump_batch",
                   str(d / "port_in_jax.npz")])
    _same_npz(_npz(d / "port_in_jax.npz"), port_b)

    _run_jax_tool(monkeypatch, "overfit_check",
                  OVERFIT + ["--dump_stream", "2", "--dump_batch",
                             str(d / "jax_stream.npz")])
    overfit_check.main(OVERFIT + ["--dump_stream", "2", "--dump_batch",
                                  str(d / "port_stream.npz"), "--device",
                                  "cpu"])
    jax_s, port_s = _npz(d / "jax_stream.npz"), _npz(d / "port_stream.npz")
    for k in NPZ_KEYS:
        assert jax_s[k].dtype == port_s[k].dtype, k
        assert jax_s[k].shape == port_s[k].shape == (2,) + port_b[k].shape
    overfit_check.main(["--stream_npz", str(d / "jax_stream.npz"),
                        "--dump_batch", str(d / "stream0.npz"), "--device",
                        "cpu"])
    _same_npz(_npz(d / "stream0.npz"), {k: v[0] for k, v in jax_s.items()})


def _json_lines(text: str):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


class _StubTrainer:
    """aot_tpu's Trainer with fixed step stats: tools/overfit_check.py's
    loop, log lines and verdict run without its train-step compile (the
    JAX Trainer also needs a batch divisible by the suite's 8 virtual
    devices)."""

    def __init__(self, cfg):
        self.state = None
        self.mesh = None

    def train_step(self, state, *args):
        return state, {"loss": 1.0, "iou": 0.5, "grad_norm": 2.0}


def test_overfit_logs_the_jax_tools_lines(static_dir, monkeypatch, capsys):
    """3 steps at B=1, crop 65 from the JAX tool's npz batch, a line every
    2 steps and at the end: the port's lines (stdout and --jsonl) carry the
    JAX tool's keys, line for line."""
    import aot_tpu.parallel
    import aot_tpu.train.trainer

    d = static_dir
    _run_jax_tool(monkeypatch, "overfit_check",
                  OVERFIT + ["--dump_batch", str(d / "b.npz")])
    run = ["--batch_npz", str(d / "b.npz"), "--steps", "3", "--log_step",
           "2", "--fp32", "--jsonl"]
    monkeypatch.setattr(aot_tpu.train.trainer, "Trainer", _StubTrainer)
    monkeypatch.setattr(aot_tpu.parallel, "shard_batch",
                        lambda mesh, x, **kw: x)
    capsys.readouterr()
    _run_jax_tool(monkeypatch, "overfit_check", run + [str(d / "jax.jsonl")])
    want = _json_lines(capsys.readouterr().out)
    iou = overfit_check.main(run + [str(d / "port.jsonl"), "--device",
                                    "cpu"])
    got = _json_lines(capsys.readouterr().out)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r.get("step") for r in got] == [None, 2, 3, None]
    assert got[-1]["final_iou"] == iou and np.isfinite(got[2]["loss"])
    assert got[-1]["verdict"] in ("PASS", "FAIL")
    for name in ("jax.jsonl", "port.jsonl"):
        logged = [json.loads(x) for x in (d / name).read_text().splitlines()]
        assert [sorted(r) for r in logged] == [sorted(r) for r in got[1:3]]
    assert [json.loads(x) for x in (d / "port.jsonl").read_text()
            .splitlines()] == got[1:3]


def test_overfit_init_pth_loads_strictly(static_dir, monkeypatch, capsys):
    """--init_pth: a DistributedDataParallel state dict ('module.' keys) of
    the model loads and the run starts from it; a file short of one key
    raises."""
    d = static_dir
    overfit_check.main(OVERFIT + ["--dump_batch", str(d / "b.npz"),
                                  "--device", "cpu"])
    cfg = port_build_config(stage="pre", model="aott")
    model = build_vos_model(cfg, device="cpu", train=True,
                            generator=torch.Generator().manual_seed(5))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save(sd, d / "init.pth")
    run = ["--batch_npz", str(d / "b.npz"), "--steps", "1", "--fp32",
           "--device", "cpu", "--init_pth"]
    capsys.readouterr()
    overfit_check.main(run + [str(d / "init.pth")])
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"init_pth": str(d / "init.pth"), "unexpected": 0}
    sd.pop(next(iter(sd)))
    torch.save(sd, d / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        overfit_check.main(run + [str(d / "short.pth")])


# --- ProfilerHook and the loader ------------------------------------------------


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    """The trace holds the host's operations and, on a track of their own,
    the program's spans on the same clock; spans are on while the hook runs
    and off again after it."""
    hook = ProfilerHook(str(tmp_path / "trace"))
    assert hook.stop() is None
    assert not tracing.spans_on()
    hook.start()
    assert tracing.spans_on()
    x = torch.randn(64, 64)
    with tracing.span("stage"):
        (x @ x).sum().item()
    path = hook.stop()
    assert not tracing.spans_on()
    assert tracing.take_spans() == []           # the hook took them
    assert Path(path).parent == tmp_path / "trace"
    events = json.loads(Path(path).read_text())["traceEvents"]
    matmul = [e for e in events if "matmul" in str(e.get("name", ""))
              and e.get("ph") == "X"]
    assert matmul
    stage = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in stage] == ["stage"]
    (stage,) = stage
    assert stage["pid"] != matmul[0]["pid"]
    assert (stage["ts"] <= matmul[0]["ts"]
            <= stage["ts"] + stage["dur"])      # one timeline
    assert hook.stop() is None
    assert list((tmp_path / "trace").iterdir()) == [Path(path)]


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "module_prefix"])
def test_load_model_takes_the_jax_loaders_keys(tmp_path, wrap):
    """A state dict as it is, under 'state_dict', or saved from a
    DistributedDataParallel model (every key under 'module.') loads
    strictly into the serving model."""
    cfg = port_build_config(stage="pre_ytb_dav", model="aott")
    src = build_vos_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    sd = src.state_dict()
    if wrap == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    blob = {"state_dict": sd} if wrap != "plain" else sd
    torch.save(blob, tmp_path / "w.pth")
    got = load_model(cfg, str(tmp_path / "w.pth"), torch.device("cpu"))
    want = src.state_dict()
    for name, val in got.state_dict().items():
        torch.testing.assert_close(val, want[name], rtol=0, atol=0)
