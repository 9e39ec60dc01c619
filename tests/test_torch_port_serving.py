"""The port's serving modes on the CPU: batched multi-video stepping
(VOSInferEngine.add_reference_frames_videos / step_videos), chunked
stepping (step_chunk), the evaluator's TEST_VIDEO_BATCH and
TEST_FRAME_CHUNK modes and the CLI knobs, and the 4-bit mask packing.

Against aot_tpu with the same weights (export_state_dict): step_videos'
masks agree on >= 99.9% of pixels (each side feeds back its own masks;
argmax near-ties may flip a few) and one step's grid-resolution logits
from the same state agree to 1e-4 of their largest entry (fp32, only the
summation order differs). Against the port's own scalar path, the masks
must be equal: rows of a batch never interact, and a chunk runs the
per-frame ops."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from aot_tpu.configs import build_config
from aot_tpu.engine import build_infer_engine as jax_build_infer_engine
from aot_tpu.ops import image as jimage
from aot_tpu_torch.configs import build_config as port_build_config
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.eval import Evaluator
from aot_tpu_torch.eval import __main__ as cli
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.ops import image as pimage
from test_eval_chunked import _Seq
from test_torch_port_engine import port_state
from test_torch_port_model import jax_aott, port_aott

SIZE = 97                 # a 7 x 7 token grid
LOGIT_REL = 1e-4
MASK_AGREE = 0.999
OBJ_NUMS = [3, 7, 10]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def videos(n: int, frames: int, seed: int = 7, size: int = SIZE):
    """(frames, n, size, size, 3) noise frames and (n, size, size) masks of
    OBJ_NUMS[i] square objects."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(frames, n, size, size, 3).astype(np.float32)
    masks = np.zeros((n, size, size), np.int64)
    for v in range(n):
        for o in range(1, OBJ_NUMS[v % len(OBJ_NUMS)] + 1):
            y, x = rng.randint(0, size - 24, 2)
            masks[v, y:y + 24, x:x + 24] = o
    return imgs, masks


@pytest.fixture(scope="module")
def weights():
    cfg = build_config(stage="pre_ytb_dav", model="aott")
    jmodel, params = jax_aott(cfg)
    return jmodel, params, port_aott(cfg, params)


def _cfg(**kw):
    return dict(stage="pre_ytb_dav", model="aott", TEST_LONG_TERM_MEM_GAP=2,
                TEST_LONG_TERM_MEM_CAP=3, TEST_LONG_TERM_MEM_POLICY="fifo",
                **kw)


# --- 4-bit packing -------------------------------------------------------------


@pytest.mark.parametrize("width", [10, 11])
def test_pack_labels_4bit_matches_jax(width):
    lab = np.random.RandomState(width).randint(0, 16, (2, 3, 5, width))
    got = pimage.pack_labels_4bit(torch.from_numpy(lab).to(torch.uint8))
    want = np.asarray(jimage.pack_labels_4bit(jnp.asarray(lab, jnp.uint8)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = pimage.unpack_labels_4bit_np(got.numpy(), width)
    np.testing.assert_array_equal(back, jimage.unpack_labels_4bit_np(want,
                                                                     width))
    np.testing.assert_array_equal(back, lab)


def test_label_to_onehot_probs_matches_jax():
    lab = np.random.RandomState(0).randint(0, 11, (2, 7, 9))
    got = pimage.label_to_onehot_probs(torch.from_numpy(lab), 11)
    want = jimage.label_to_onehot_probs(jnp.asarray(lab), num_classes=11)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- batched multi-video stepping ----------------------------------------------


def test_step_videos_matches_jax(weights):
    """N = 3 videos of 3, 7 and 10 objects through both packages' batched
    step (LT writes every other frame into a fifo ring of 3)."""
    jmodel, params, model = weights
    cfg = build_config(**_cfg())
    jeng = jax_build_infer_engine(jmodel, cfg)
    eng = build_infer_engine(model, cfg)
    imgs, masks = videos(3, 4)

    js = jax.jit(lambda p, i, m: jeng.add_reference_frames_videos(
        p, i, m, OBJ_NUMS))(params, jnp.asarray(imgs[0]),
                            jnp.asarray(masks.astype(np.int32)))
    ps = eng.add_reference_frames_videos(torch.from_numpy(imgs[0]),
                                         torch.from_numpy(masks), OBJ_NUMS)

    # one step's logits from the same (the JAX) state, live ids only
    with torch.inference_mode():
        st = eng.engine.propagate(port_state(js), torch.from_numpy(imgs[1]))
        got = eng.engine.decode_logits(st).numpy()
    jst = jax.jit(jeng.engine.propagate)(params, js, jnp.asarray(imgs[1]))
    want = np.asarray(jax.jit(jeng.engine.decode_logits)(params, jst))
    for v, n in enumerate(OBJ_NUMS):
        err = np.abs(got[v, ..., :n + 1] - want[v, ..., :n + 1]).max()
        assert err <= LOGIT_REL * np.abs(want[v, ..., :n + 1]).max(), (v, err)

    jstep = jax.jit(lambda p, s, i: jeng.step_videos(p, s, i,
                                                     orig_size=(SIZE, SIZE)))
    for t in range(1, len(imgs)):
        js, jpred = jstep(params, js, jnp.asarray(imgs[t]))
        ps, pred, _ = eng.step_videos(ps, torch.from_numpy(imgs[t]),
                                      (SIZE, SIZE))
        agree = (pred.numpy() == np.asarray(jpred)).mean(axis=(1, 2))
        assert agree.min() >= MASK_AGREE, (t, agree)
        assert ps.lt_count == [int(c) for c in np.asarray(js.lt_count)]
    assert all(np.asarray(jpred)[v].max() > 0 for v in range(3))


def _solo(eng, img0, mask, obj_num, frames, orig_size, input_size):
    """One video alone through the evaluator's scalar cadence: propagate,
    decode at orig_size, argmax, nearest-down to input_size, update."""
    st = eng.add_reference_frame(torch.from_numpy(img0[None]),
                                 torch.from_numpy(mask[None]), obj_num)
    preds = []
    for img in frames:
        if tuple(orig_size) == tuple(input_size):
            st, pred, _ = eng.step(st, torch.from_numpy(img[None]), orig_size)
        else:
            with torch.inference_mode():
                st = eng.propagate(st, torch.from_numpy(img[None]))
                pred = pimage.upsample_argmax(eng.decode_logits(st),
                                              orig_size)
                lab = pimage.interpolate_nearest(pred[..., None].float(),
                                                 input_size)[..., 0].long()
                st = eng.update_memory(st, lab)
        preds.append(pred[0].numpy())
    return preds


@pytest.mark.parametrize("case", ["same_size", "resized", "ragged"])
def test_step_videos_rows_match_scalar_step(weights, case):
    """Each row of a batch against its video stepped alone: masks equal.
    'resized' decodes at an original size of 113 x 121 and writes the
    nearest-down mask into memory; 'ragged' ends video 1 two frames early
    and replays its last frame, whose outputs are dropped."""
    model = weights[2]
    eng = build_infer_engine(model, port_build_config(**_cfg()))
    imgs, masks = videos(3, 5, seed=11)
    orig = (113, 121) if case == "resized" else (SIZE, SIZE)
    lens = [5, 3, 5] if case == "ragged" else [5, 5, 5]
    want = [_solo(eng, imgs[0, v], masks[v], OBJ_NUMS[v],
                  imgs[1:lens[v], v], orig, (SIZE, SIZE)) for v in range(3)]
    ps = eng.add_reference_frames_videos(torch.from_numpy(imgs[0]),
                                         torch.from_numpy(masks), OBJ_NUMS)
    last = imgs[0].copy()
    for t in range(1, 5):
        for v in range(3):
            if t < lens[v]:
                last[v] = imgs[t, v]
        ps, pred, _ = eng.step_videos(ps, torch.from_numpy(last.copy()),
                                      orig, (SIZE, SIZE))
        assert tuple(pred.shape) == (3,) + orig
        for v in range(3):
            if t < lens[v]:
                np.testing.assert_array_equal(pred[v].numpy(),
                                              want[v][t - 1],
                                              err_msg=f"{case} {v} {t}")


def test_step_chunk_matches_step(weights):
    """K = 4 frames in one step_chunk on a 'grow' ring of 1 with an LT write
    inside the chunk (gap 2): the masks equal four step calls."""
    model = weights[2]
    cfg = port_build_config(stage="pre_ytb_dav", model="aott",
                            TEST_LONG_TERM_MEM_GAP=2,
                            TEST_LONG_TERM_MEM_CAP=1)
    eng = build_infer_engine(model, cfg)
    imgs, masks = videos(1, 5, seed=5)

    def ref():
        return eng.add_reference_frame(torch.from_numpy(imgs[0]),
                                       torch.from_numpy(masks[:1]), 3)

    st, shadow, want = ref(), eng.make_shadow(), []
    shadow.add_ref(0)
    for t in range(1, 5):
        if shadow.will_write(t):
            st = eng.ensure_lt_capacity(st, shadow.count + 1)
        st, pred, _ = eng.step(st, torch.from_numpy(imgs[t]), (SIZE, SIZE))
        shadow.update(t)
        want.append(pred.to(torch.uint8).numpy())

    st2 = eng.ensure_lt_capacity(ref(), shadow.count)
    st2, preds = eng.step_chunk(st2, torch.from_numpy(imgs[1:]),
                                (SIZE, SIZE), (SIZE, SIZE))
    assert preds.dtype == torch.uint8 and tuple(preds.shape) == (4, 1, SIZE,
                                                                 SIZE)
    np.testing.assert_array_equal(preds.numpy(), np.stack(want))
    assert st2.lt_count == st.lt_count == [3]
    assert eng.lt_cap(st2) == 4


# --- the evaluator's modes (tests/test_video_batch.py:82,
# tests/test_eval_chunked.py:93,105,117) ---------------------------------------


class _VSeq(_Seq):
    """A _Seq with frames of its own (a row mix-up must not cancel)."""

    def __init__(self, seed, name, **kw):
        super().__init__(**kw)
        self.seed = seed
        self.seq_name = name

    def __getitem__(self, idx):
        s = super().__getitem__(idx)
        rng = np.random.RandomState(self.seed * 10000 + idx)
        s["image"] = (rng.rand(*s["image"].shape) * 255).astype(np.float32)
        return s


@pytest.fixture(scope="module")
def eval_model():
    cfg = port_build_config(stage="pre", model="aott")
    return build_vos_model(cfg, device="cpu")


def _pngs(root: str, seqs):
    out = {}
    for s in seqs:
        d = os.path.join(root, s.seq_name)
        for f in sorted(os.listdir(d)):
            out[f"{s.seq_name}/{f}"] = np.array(Image.open(os.path.join(d, f)))
    return out


def _evaluator(eval_model, root, **over):
    cfg = port_build_config(stage="pre", model="aott", TEST_DATASET="test",
                            TEST_LONG_TERM_MEM_GAP=2,
                            TEST_LONG_TERM_MEM_CAP=2, **over)
    cfg.TEST_MULTISCALE = [1.0]
    return Evaluator(cfg, eval_model, result_root=str(root), device="cpu")


def test_evaluator_video_batch_matches_scalar(eval_model, tmp_path):
    """Three videos of 6, 8 and 8 frames, annotated at frame 0 only, two
    batches' worth of `_buckets` at TEST_VIDEO_BATCH=2 (a pair and a
    single): the same PNGs as the scalar path."""
    def seqs():
        return [_VSeq(i + 1, f"vb{i}", size=65, n_frames=nf,
                      mid_label_at=None) for i, nf in enumerate((6, 8, 8))]

    scalar = _evaluator(eval_model, tmp_path / "scalar")
    for s in seqs():
        assert scalar.eval_sequence(s)["timed_frames"] == len(s) - 1
    ev = _evaluator(eval_model, tmp_path / "batched", TEST_VIDEO_BATCH=2)
    batches, single = ev._buckets(seqs())
    assert [[len(s) for s in b] for b in batches] == [[6, 8]]
    assert [len(s) for s in single] == [8]
    stats = ev.eval_sequences_batched(batches[0]) + [ev.eval_sequence(
        single[0])]
    assert [s["timed_frames"] for s in stats] == [5, 7, 7]
    a = _pngs(str(tmp_path / "scalar"), seqs())
    b = _pngs(str(tmp_path / "batched"), seqs())
    assert a.keys() == b.keys() and len(a) == 19
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert any(m.max() > 0 for m in a.values())


@pytest.mark.parametrize("case", ["chunk4_mid_label", "tta_bypass",
                                  "chunk_beyond_video"])
def test_evaluator_frame_chunk_matches_per_frame(eval_model, tmp_path, case):
    """TEST_FRAME_CHUNK against per-frame stepping, same PNGs: chunks of 4
    around a label at frame 5 (4 + 1 + 4 + 1, the LT ring growing inside a
    chunk); flip TTA bypasses chunking; a chunk of 16 over 10 label-free
    frames runs 8 + 2."""
    chunk = {"chunk4_mid_label": 4, "tta_bypass": 8,
             "chunk_beyond_video": 16}[case]
    mid = 5 if case == "chunk4_mid_label" else None
    flip = case == "tta_bypass"
    out = []
    for k in (1, chunk):
        ev = _evaluator(eval_model, tmp_path / f"c{k}", TEST_FRAME_CHUNK=k,
                        TEST_FLIP=flip)
        seq = _Seq(mid_label_at=mid)
        assert ev.eval_sequence(seq)["timed_frames"] == len(seq) - 1
        out.append(_pngs(str(tmp_path / f"c{k}"), [seq]))
    a, b = out
    assert a.keys() == b.keys() and len(a) == 10
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("argv", [["--video_batch", "2"],
                                  ["--frame_chunk", "4"], ["--amp"]])
def test_cli_serving_knobs_run(argv, tmp_path):
    """The synthetic fixture (3 videos x 10 frames, shrunk to 166 px)
    through `python -m aot_tpu_torch.eval` on the CPU with each knob."""
    summary = cli.main(argv + [
        "--device", "cpu", "--ckpt_path", "test", "--dataset", "test",
        "--max_resolution", "100", "--set", f"DIR_ROOT={tmp_path}"])
    assert summary["sequences"] == 3
    assert summary["total_frames"] == 27
    pngs = list(tmp_path.rglob("*.png"))
    assert len(pngs) == 27
    assert {np.array(Image.open(p)).shape for p in pngs} == {(400, 400)}
