"""The slice's first main path on the CPU: R50_DeAOTL (ResNet-50 at full
depth, three gated-propagation blocks, h=1) through the port's online
engine against aot_tpu's, with the same seeded weights: the reference
frame with 3 objects and 3 steps at 65x65 (a 5x5 grid), LT gap 2 on a
'grow' ring of one frame, grown at the second step as the evaluator does.
Gates of tests/test_torch_port_engine.py: grid logits within 1e-3 of the
largest live logit (or of 1, if larger; a deep encoder's features are
unbounded), masks agree on >= 99.9%."""

import numpy as np

from aot_tpu.configs import build_config
from test_torch_port_encoders import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_engine import LOGIT_TOL, MASK_AGREE
from test_torch_port_variants import jax_variant, port_variant, run_both

SIZE = 65
OBJECTS = 3


def small_clip(seed: int, frames: int, size: int, objects: int):
    """Noise frames (T, 1, H, W, 3) and a mask of `objects` squares."""
    rng = np.random.RandomState(seed)
    imgs = rng.randn(frames, 1, size, size, 3).astype(np.float32)
    mask = np.zeros((1, size, size), np.int32)
    side = size // 3
    for i in range(1, objects + 1):
        y, x = rng.randint(0, size - side, 2)
        mask[0, y:y + side, x:x + side] = i
    return imgs, mask


def check_slice(variant: str, size: int):
    cfg = build_config(stage="pre_ytb_dav", model=variant,
                       TEST_LONG_TERM_MEM_GAP=2, TEST_LONG_TERM_MEM_CAP=1)
    assert cfg.TEST_LONG_TERM_MEM_POLICY == "grow"
    jmodel, params = jax_variant(cfg)
    model, _ = port_variant(cfg, params)
    imgs, mask = small_clip(3, 4, size, OBJECTS)
    err, scale, agree, ps = run_both(cfg, jmodel, params, model, imgs, mask,
                                     OBJECTS, size)
    assert err <= LOGIT_TOL * max(1.0, scale), (variant, err, scale)
    assert agree >= MASK_AGREE, (variant, agree)
    assert ps.lt_count == [2]
    return cfg, model


def test_r50_deaotl_engine_matches_jax():
    cfg, model = check_slice("r50_deaotl", SIZE)
    assert cfg.MODEL_ALIGN_CORNERS
    assert model.patch_wise_id_bank.kernel_size == (17, 17)
