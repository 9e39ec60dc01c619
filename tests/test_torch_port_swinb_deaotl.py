"""The slice's second main path on the CPU: SwinB_DeAOTL (Swin-B at full
depth, MODEL_ALIGN_CORNERS=False) through the port's online engine
against aot_tpu's, as tests/test_torch_port_r50_deaotl.py runs
R50_DeAOTL, at 64x64: the patch embedding gives 16x16 tokens, the stages
8x8 and 4x4 (each padded to a window of 7, shifted blocks masked), and
the identity bank's kernel 16 / padding 0 gives the same 4x4 grid; the
decoder's resizes and the engine's upsampling take align_corners=False.
Also the evaluator's size snap for that mode (multiples of 16: the
465x465 frames of the AOTT and DeAOTL serving paths give 464x464, Swin-B's
29x29 grid; a 480p frame gives 480x848)."""

import pytest

from aot_tpu.data.video_aug import restrict_size as jax_restrict_size
from aot_tpu_torch.data.video_aug import restrict_size
from test_torch_port_encoders import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_r50_deaotl import check_slice

SIZE = 64


def test_swinb_deaotl_engine_matches_jax():
    cfg, model = check_slice("swinb_deaotl", SIZE)
    assert not cfg.MODEL_ALIGN_CORNERS
    assert model.patch_wise_id_bank.kernel_size == (16, 16)
    assert model.patch_wise_id_bank.padding == (0, 0)
    assert len(model.encoder.layers[2].blocks) == 18


@pytest.mark.parametrize("hw", [(480, 854), (720, 1280), (465, 465)])
def test_eval_size_snap_without_align_corners(hw):
    args = (*hw, 1.0, 480, 800 * 1.3, False)
    got = restrict_size(*args)
    assert got == tuple(jax_restrict_size(*args))
    assert got[0] % 16 == 0 and got[1] % 16 == 0
    assert got == {(480, 854): (480, 848), (720, 1280): (480, 848),
                   (465, 465): (464, 464)}[hw]
