"""Swin's window attention on the port's kernel route.

On the CPU: the window kernel's addressing (ops/kernels/swin_window_attn.py
`cells`, the kernel's arithmetic mirrored in Python) against the pad, roll
and partition of models/encoders/swin.py on odd map sizes with both
shifts; a block's kernel route (its plain version here) against the
block's own plain path; the route's dispatch and counters; the libraries
an engine built on a card loads before its first frame; and the port's
Swin against the benchmark's plain reference encoder
(vosbench/reference/encoders/swin_base.py) on seeded weights.

On a card (marked `card`, skipped without one): the kernel against the
block's plain path at Swin-B's three stage shapes at DAVIS 480p (480x848
frames) and at 464x464, shifted and unshifted, one and two images:

    python -m pytest --noconftest -m card tests/test_torch_port_swin_window.py

(`--noconftest`: the suite's conftest imports JAX, which a machine with a
card need not have; this file imports none of it.)
"""

import functools
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aot_tpu_torch.models.encoders import swin
from aot_tpu_torch.ops import attention
from aot_tpu_torch.ops.kernels import _build
from aot_tpu_torch.ops.kernels import swin_window_attn as swa
from aot_tpu_torch.utils import tracing
from vosbench.reference.encoders import swin_base
from vosbench.reference.model import Ops

SIZES = [(9, 10), (15, 23), (5, 3), (7, 14), (30, 53), (29, 29)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel runs only there")
    return torch.device("cuda", 0)


def rolled_windows(grid: torch.Tensor, window: int, shift: int, fill):
    """(H, W) -> (nW, window^2) by swin.py's own pad, roll and partition."""
    hgt, wid = grid.shape
    pad_b, pad_r = (-hgt) % window, (-wid) % window
    x = F.pad(grid[None, :, :, None].float(), (0, 0, 0, pad_r, 0, pad_b),
              value=fill)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    return swin.window_partition(x, window)[..., 0].long()


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_cells_are_the_pad_roll_partition(size, shift):
    """Each window cell's source token (padding -1) as the kernel works it
    out, against the tokens that swin.py's pad, roll and partition put
    there; the regions' -100 mask against swin.py's shift mask."""
    hgt, wid = size
    cells = swa.cells(hgt, wid, 7, shift)
    tokens = torch.arange(hgt * wid).view(hgt, wid)
    assert torch.equal(cells.src, rolled_windows(tokens, 7, shift, -1))
    reg = cells.region
    mask = torch.where(reg[:, :, None] != reg[:, None, :], -100.0, 0.0)
    if shift == 0:
        assert not reg.any()
    else:
        hp, wp = -(-hgt // 7) * 7, -(-wid // 7) * 7
        np.testing.assert_array_equal(
            mask.numpy(), swin.shift_attn_mask(hp, wp, 7, shift))


def test_heads_per_block():
    # Swin-B at DAVIS 480p on 132 multiprocessors: 558, 144 and 40 windows
    assert [swa.heads_per_block(1, h, w, 132)
            for h, w in ((4, 558), (8, 144), (16, 40))] == [4, 4, 2]
    assert swa.heads_per_block(1, 6, 10, 132) == 1
    assert swa.heads_per_block(2, 16, 40, 132) == 4


def seeded_block(dim, heads, shift, seed=0):
    blk = swin.SwinBlock(dim, heads, 7, shift).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (p.shape[-1] ** -0.5 if p.ndim > 1 else 0.3))
    return blk


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("size", [(9, 10), (15, 23), (5, 3)], ids=str)
def test_kernel_route_matches_plain_path(size, shift, monkeypatch):
    """A block whose attention takes the kernel route (here the kernel's
    plain version in the launch's place, by the kernel's addressing, with
    the qkv product over the image's own tokens) against the block's
    pad/roll/partition path: fp32 on both sides, only the order of sums
    may differ."""
    blk = seeded_block(64, 4, shift)
    hgt, wid = size
    x = torch.randn(2, hgt * wid, 64, generator=torch.Generator()
                    .manual_seed(1))
    with torch.inference_mode():
        want = blk(x, size)
        monkeypatch.setattr(attention, "window_route",
                            lambda *a: "kernel")
        monkeypatch.setattr(swa, "swin_window_attention_cuda",
                            swa.swin_window_attention_plain)
        tracing.reset_counters()
        got = blk(x, size)
    assert tracing.counters()["attn.window.kernel"] == 1
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


MODES = ("auto", "pallas", "xla", "reference", "window")


@pytest.mark.parametrize("impl", MODES)
@pytest.mark.parametrize("case", [
    ("cuda", torch.float32, False, False), ("cpu", torch.float32, False, False),
    ("cuda", torch.bfloat16, False, False), ("cuda", torch.float32, True, False),
    ("cuda", torch.float32, False, True)],
    ids=["cuda", "cpu", "bf16", "grad", "training"])
def test_window_route(case, impl):
    """Only an fp32 card tensor outside training with no gradient asked
    for, under 'auto' or 'pallas', takes the kernel."""
    device, dtype, grad, training = case
    prev = attention.set_attn_impl(impl)
    try:
        if training:
            with attention.attn_training_context():
                route = attention.window_route(device, dtype, grad)
        else:
            route = attention.window_route(device, dtype, grad)
    finally:
        attention.set_attn_impl(prev)
    kernel = (device == "cuda" and dtype == torch.float32 and not grad
              and not training and impl in ("auto", "pallas"))
    assert route == ("kernel" if kernel else "plain")


@pytest.mark.parametrize("impl", MODES)
@pytest.mark.parametrize("dtype, swin_enc", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True)],
    ids=["fp32-swin", "fp32", "bf16-swin"])
def test_load_serving_kernels(dtype, swin_enc, impl, monkeypatch):
    """The libraries an engine built on a card has built and loaded before
    its first frame: the local kernel's and the flash forward's of the
    model's dtype, the window kernel's for an fp32 Swin encoder, none
    under 'xla' and 'reference' (which launch no kernel)."""
    built, loaded = [], []
    monkeypatch.setattr(_build, "build", lambda *n: built.extend(n))
    monkeypatch.setattr(_build, "load", loaded.append)
    prev = attention.set_attn_impl(impl)
    try:
        got = attention.load_serving_kernels(dtype, swin=swin_enc)
    finally:
        attention.set_attn_impl(prev)
    if impl in ("xla", "reference"):
        want = []
    elif dtype == torch.float32:
        want = (["local_window_attn_tc", "flash_attn_fwd"]
                + ["swin_window_attn"] * swin_enc)
    else:
        want = ["local_window_attn_bf16", "flash_attn_fwd_bf16"]
    assert list(got) == built == loaded == want


@pytest.mark.parametrize("encoder", ["mobilenetv2", "swinb"])
def test_build_infer_engine_asks_the_model_for_swin_reads(encoder,
                                                          monkeypatch):
    """The model says whether its encoder makes Swin window reads, and
    build_infer_engine hands that answer to load_serving_kernels (a
    recording stand-in here) for a model on a card (its parameters a
    stand-in that reports a CUDA tensor). Swin at small widths."""
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.engine import infer
    from aot_tpu_torch.models import encoders
    from aot_tpu_torch.models.aot import AOT

    monkeypatch.setattr(encoders, "SwinTransformer", functools.partial(
        swin.SwinTransformer, embed_dim=32, depths=(2, 2, 2),
        num_heads=(1, 2, 4), full_depths=(2, 2, 2, 2)))
    is_swin = encoder == "swinb"
    dims = (32, 64, 128, 128) if is_swin else (24, 32, 96, 1280)
    model = AOT(encoder_name=encoder, encoder_dims=dims, emb_dim=32,
                self_heads=2, att_heads=2).eval()
    assert isinstance(model.encoder, swin.SwinTransformer) == is_swin
    assert model.swin_window_reads == is_swin
    calls = []
    monkeypatch.setattr(infer, "load_serving_kernels",
                        lambda dtype, swin: calls.append((dtype, swin)))
    monkeypatch.setattr(model, "parameters", lambda: iter(
        [types.SimpleNamespace(is_cuda=True)]))
    infer.build_infer_engine(model, build_config(stage="pre_ytb_dav",
                                                 model="aott"))
    assert calls == [(torch.float32, is_swin)]


@pytest.mark.parametrize("mode", ["eval", "grad", "training", "bf16"])
def test_cpu_blocks_go_plain_and_count(mode):
    """Every block of a small Swin on the CPU takes the plain path, in
    serving, with a gradient, in training and at bf16, and counts its
    windows times heads (padded windows included)."""
    enc = swin.SwinTransformer(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                               full_depths=(2, 2), out_indices=(0, 1)).eval()
    x = torch.randn(1, 3, 36, 60)
    if mode == "bf16":
        x = x.to(torch.bfloat16)    # fp32 weights, cast at use
    tracing.reset_counters()
    if mode == "training":
        with attention.attn_training_context():
            enc(x)
    elif mode == "grad":
        enc(x)
    else:
        with torch.inference_mode():
            enc(x)
    got = tracing.counters()
    # stage maps 9x15 (2 x 3 windows, 1 head) and 5x8 (1 x 2, 2 heads)
    assert got["attn.window.plain"] == 4
    assert got["attn.window.plain.windows"] == 2 * 6 * 1 + 2 * 2 * 2
    assert "attn.window.kernel" not in got


def test_port_swin_matches_reference_encoder():
    """The port's Swin (its plain path, small widths and depths) against the
    benchmark's plain reference encoder, written from the published
    description, on the same seeded weights: both fp32 on the CPU, where
    only the order of sums may differ (the maps' largest entries are ~5,
    fp32 rounding ~1e-6 of them)."""
    depths, heads = (2, 2, 2), (2, 4, 8)
    enc = swin.SwinTransformer(embed_dim=32, depths=depths,
                               num_heads=heads).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            n = torch.randn(p.shape, generator=g)
            if p.ndim > 1:                   # variance 1 / fan-in
                p.copy_(n * p[0].numel() ** -0.5)
            else:                            # norm scales near 1, biases
                p.copy_(0.1 * n + (0.0 if name.endswith("bias") else 1.0))
    P = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    x = torch.randn(1, 3, 80, 112, generator=g)
    with torch.inference_mode():
        got = enc(x)
        want = swin_base.swin(P, x, Ops, depths, heads)
    assert [t.shape for t in got] == [t.shape for t in want]
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


STAGES_480 = [(120, 212, 128, 4), (60, 106, 256, 8), (30, 53, 512, 16)]
STAGES_464 = [(116, 116, 128, 4), (58, 58, 256, 8), (29, 29, 512, 16)]


@pytest.mark.card
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", STAGES_480 + STAGES_464, ids=str)
def test_kernel_matches_plain_path_on_card(stage, shift, b, card):
    """The kernel route of a Swin-B block against its plain path on the
    card, fp32 with TF32 off: within 1e-5 of the largest entry. The two
    differ only in the order of fp32 sums (~1e-6 measured); a TF32 product
    anywhere in the read (10-bit mantissas) would be off by ~1e-3."""
    hgt, wid, dim, heads = stage
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        blk = seeded_block(dim, heads, shift).to(card)
        x = torch.randn(b, hgt * wid, dim, generator=torch.Generator()
                        .manual_seed(2)).to(card)
        with torch.inference_mode():
            y = blk.norm1(x)
            a = blk.attn
            want = blk._windowed(y, (hgt, wid))
            tracing.reset_counters()
            got = a.proj(attention.window_attention(
                a.qkv(y), a.qkv.bias, a.relative_position_bias_table,
                num_heads=heads, size_2d=(hgt, wid), window=7, shift=shift))
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert tracing.counters()["launch.swin_window_attn"] == 1
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
