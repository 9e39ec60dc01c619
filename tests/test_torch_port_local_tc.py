"""The decomposition of the port's local-window kernel
(csrc/local_window_attn_tc.cu), emulated in plain PyTorch on the CPU, and
its launch plan (ops/kernels/local_window_attn.py `launch_plan`).

The emulation walks the kernel's tiles as the launch plan cuts them: for
each tile of `rows` query rows x 16 pixels, the halo rows in the image
(r_lo .. r_hi), and for each query row the banded 16 x 32 products
S_dy = Q_row K_halo^T over the 32 halo keys of window row dy, extracted into
slot order (slot dy*win + dx <- column x + dx); rel_bias added and the
softmax taken, masked by position; for dv > 128 the two passes through the
(B*h, HW, win2) P scratch, the value pass on its own tiles and 128-column
value tiles; the banded P_dy V_halo products and the dense P rel_v^T product
in slot order. Edge tiles (overhanging columns and rows) and halos that
reach past the image are zero-filled as the kernel's cp.async copies are.

It is held to local_window_attention_plain and to the JAX package's flat
and wide Pallas kernels in interpret mode at 1e-5 (products in fp64 here;
the kernel's 3xTF32 keeps fp32 accuracy, and chip_smoke.py holds the kernel
itself to the plain version on the card at 1e-4)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aot_tpu.ops.pallas.local_window_attn import (local_window_attention_flat,
                                                   local_window_attention_wide)
from aot_tpu_torch.ops.kernels import local_window_attn as lwa

TIGHT = dict(atol=1e-5, rtol=1e-5)
SMS = 132   # an H100 SXM's multiprocessors


def _mk(b, hgt, wid, h, d, dv, max_dis, with_rv, seed):
    rng = np.random.RandomState(seed)
    hw, win2 = hgt * wid, (2 * max_dis + 1) ** 2
    q = rng.randn(b, hw, h * d).astype(np.float32)
    k = rng.randn(b, hw, h * d).astype(np.float32)
    v = rng.randn(b, hw, h * dv).astype(np.float32)
    rb = (0.3 * rng.randn(b, h, hw, win2)).astype(np.float32)
    rv = (0.3 * rng.randn(h, dv, win2)).astype(np.float32) if with_rv else None
    return q, k, v, rb, rv


def _halo(img, ky, x0, m):
    """(N, 32, C): the 32 halo keys of image row ky from column x0 - m,
    zero off the image (img: (N, H, W, C))."""
    n, _, wid, c = img.shape
    out = img.new_zeros(n, lwa.HALO, c)
    lo, hi = max(0, x0 - m), min(wid, x0 - m + lwa.HALO)
    if hi > lo:
        out[:, lo - (x0 - m):hi - (x0 - m)] = img[:, ky, lo:hi]
    return out


def _tiles(hgt, wid, rows):
    for y0 in range(0, hgt, rows):
        for x0 in range(0, wid, lwa.TILE_X):
            yield y0, x0


def emulate(q, k, v, rel_bias, rel_v, *, num_heads, size_2d, max_dis,
            d_att=None):
    """The kernel's function, computed in its decomposition (fp64)."""
    hgt, wid = size_2d
    b, hw = q.shape[:2]
    h, m = num_heads, max_dis
    d = d_att or q.shape[-1] // h
    dv = v.shape[-1] // h
    win, tx = 2 * m + 1, lwa.TILE_X
    win2 = win * win
    # column x + dx of a banded product holds query x's slot dx
    col = torch.arange(tx)[:, None] + torch.arange(win)
    on_band = (torch.arange(lwa.HALO) - torch.arange(tx)[:, None])  # c - x
    on_band = (on_band >= 0) & (on_band < win)
    plan = lwa.launch_plan(b, h, hgt, wid, d, dv, m, SMS)
    img = lambda x, c: (x.double().reshape(b, hgt, wid, h, c)
                        .permute(0, 3, 1, 2, 4).reshape(b * h, hgt, wid, c))
    qi, ki, vi = img(q, d), img(k, d), img(v, dv)
    scale = 1.0 / math.sqrt(d)
    # 1-2. scores and softmax over the first pass's tiles
    p_all = torch.zeros(b * h, hgt, wid, win2, dtype=torch.float64)
    rows = plan.rows[0]
    for y0, x0 in _tiles(hgt, wid, rows):
        nx = min(tx, wid - x0)
        r_lo, r_hi = max(0, m - y0), min(rows + 2 * m, hgt - y0 + m)
        for qrow in range(min(rows, hgt - y0)):
            y = y0 + qrow
            sc = torch.zeros(b * h, nx, win2, dtype=torch.float64)
            q_row = qi.new_zeros(b * h, tx, d)
            q_row[:, :nx] = qi[:, y, x0:x0 + nx]
            for r in range(r_lo, r_hi):
                dy = r - qrow
                if not 0 <= dy < win:
                    continue
                band = q_row @ _halo(ki, y0 - m + r, x0, m).transpose(1, 2)
                # slot dy*win + dx <- column x + dx
                sc[:, :, dy * win:(dy + 1) * win] += torch.gather(
                    band[:, :nx], 2, col[:nx].expand(b * h, nx, win)) * scale
            ky = y + torch.arange(win).repeat_interleave(win) - m
            kx = (x0 + torch.arange(nx))[:, None] + torch.arange(win).repeat(
                win) - m
            ok = (ky >= 0) & (ky < hgt) & (kx >= 0) & (kx < wid)
            sc = sc + rel_bias.double().reshape(b * h, hgt, wid, win2)[
                :, y, x0:x0 + nx]
            sc = sc.masked_fill(~ok, -math.inf)
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            p_all[:, y, x0:x0 + nx] = e / e.sum(-1, keepdim=True)
    if plan.passes == 2:   # through the scratch, as the value pass reads it
        p_all = p_all.float().double()
        assert p_all[0].numel() * b * h == plan.scratch_floats
    # 3-4. values over the value pass's tiles and value tiles
    out = torch.zeros(b * h, hgt, wid, dv, dtype=torch.float64)
    # a one-pass block takes 32 value columns at dv <= 32, else 128
    rows = plan.rows[-1]
    vt = 32 if plan.passes == 1 and dv <= 32 else lwa.VALUE_TILE
    for y0, x0 in _tiles(hgt, wid, rows):
        nx = min(tx, wid - x0)
        r_lo, r_hi = max(0, m - y0), min(rows + 2 * m, hgt - y0 + m)
        for c0 in range(0, dv, vt):
            cols = slice(c0, min(dv, c0 + vt))
            for qrow in range(min(rows, hgt - y0)):
                y = y0 + qrow
                p = p_all.new_zeros(b * h, tx, win2)
                p[:, :nx] = p_all[:, y, x0:x0 + nx]
                acc = out.new_zeros(b * h, tx, cols.stop - c0)
                for r in range(r_lo, r_hi):
                    dy = r - qrow
                    if not 0 <= dy < win:
                        continue
                    # A(x, c) = P[x][dy, c - x] on the band, 0 off it
                    a_band = torch.gather(
                        p[:, :, dy * win:(dy + 1) * win], 2,
                        ((torch.arange(lwa.HALO) - torch.arange(tx)[:, None])
                         .clamp(0, win - 1)).expand(b * h, tx, lwa.HALO))
                    a_band = a_band * on_band
                    acc += a_band @ _halo(vi, y0 - m + r, x0, m)[..., cols]
                if rel_v is not None:
                    rv = rel_v.double()[:, cols].repeat(b, 1, 1)
                    acc += p @ rv.transpose(1, 2)
                out[:, y, x0:x0 + nx, cols] = acc[:, :nx]
    return (out.reshape(b, h, hw, dv).permute(0, 2, 1, 3)
            .reshape(b, hw, h * dv).float())


HEADS = {"aot": (2, 8, 8),          # (heads, d, dv): one pass, 32-column tile
         "deaot": (1, 16, 160)}     # two passes, a partial 2nd value tile
GRIDS = [(5, 3), (9, 7), (17, 17), (20, 37)]   # 46x80 trimmed to 20x37


def _case(hgt, wid, max_dis, head, with_rv):
    h, d, dv = HEADS[head]
    args = _mk(2, hgt, wid, h, d, dv, max_dis, with_rv, seed=hgt * wid + d)
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=max_dis, d_att=d)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    return args, t, kw


@pytest.mark.parametrize("with_rv", [True, False])
@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("max_dis", [2, 7])
@pytest.mark.parametrize("hgt,wid", GRIDS)
def test_emulated_kernel_matches_plain(hgt, wid, max_dis, head, with_rv):
    _, t, kw = _case(hgt, wid, max_dis, head, with_rv)
    np.testing.assert_allclose(
        emulate(*t, **kw).numpy(),
        lwa.local_window_attention_plain(*t, **kw).numpy(), **TIGHT)


# every grid at both radii; the heads and rel_v alternate so that each of
# the four (head, rel_v) pairs meets each radius
PALLAS_CASES = [(hgt, wid, m, head, rv)
                for i, (hgt, wid) in enumerate(GRIDS) for m in (2, 7)
                for head, rv in [[("aot", True), ("deaot", False),
                                  ("aot", False), ("deaot", True)][
                                      (2 * i + (m == 7)) % 4]]]


@pytest.mark.parametrize("hgt,wid,max_dis,head,with_rv", PALLAS_CASES)
def test_emulated_kernel_matches_pallas_kernels(hgt, wid, max_dis, head,
                                                with_rv):
    """The TPU kernels this one replaces: flat (local_window_attn.py:414)
    and wide (:236), in interpret mode."""
    args, t, kw = _case(hgt, wid, max_dis, head, with_rv)
    got = emulate(*t, **kw).numpy()
    j = [None if a is None else jnp.asarray(a) for a in args]
    for fn, extra in ((local_window_attention_flat, {}),
                      (local_window_attention_wide, {"rows_per_band": 4})):
        want = np.asarray(fn(*j, **kw, **extra, interpret=True))
        np.testing.assert_allclose(got, want, **TIGHT)


# (B, h, H, W, d, dv): passes, rows a tile, blocks, scratch bytes
PLANS = {
    "aot_30x30": ((1, 8, 30, 30, 32, 32), (1, (2,), (240,), 0)),
    "deaot_30x30": ((1, 1, 30, 30, 128, 1024),
                    (2, (1, 2), (60, 240), 810000)),
    "aot_64x113": ((1, 8, 64, 113, 32, 32), (1, (4,), (1024,), 0)),
    "deaot_64x113": ((1, 1, 64, 113, 128, 1024),
                     (2, (2, 2), (256, 2048), 6508800)),
    "aot_43x76": ((1, 8, 43, 76, 32, 32), (1, (4,), (440,), 0)),
    "deaot_43x76": ((1, 1, 43, 76, 128, 1024),
                    (2, (1, 2), (215, 880), 2941200)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_launch_plan(name):
    """Tiles, passes, scratch and grid at the serving grids: 465x465
    (30x30), DAVIS 1080p (64x113) and 720p (43x76), both heads. Each pass
    gives every multiprocessor a block (a wave's worth of blocks) where a
    tile of 1 row or more can, and two passes run for dv > 128 only."""
    (b, h, hgt, wid, d, dv), want = PLANS[name]
    plan = lwa.launch_plan(b, h, hgt, wid, d, dv, 7, SMS)
    assert (plan.passes, plan.rows, plan.blocks,
            4 * plan.scratch_floats) == want
    z = (1, -(-dv // lwa.VALUE_TILE))
    for i, (rows, blocks) in enumerate(zip(plan.rows, plan.blocks)):
        tiles = -(-wid // lwa.TILE_X) * -(-hgt // rows)
        assert blocks == tiles * b * h * z[i]
        assert blocks >= SMS or rows == 1
    assert plan.args() == (plan.rows + (0,))[:2]


@pytest.mark.parametrize("d", [8, 128, 512])
def test_launch_plan_fits_every_width(d):
    """Every d the kernel takes (MAX_D), at both heads' value widths: one
    pass up to d = dv = 128, else two; a 4-row tile only where a block's
    values are 32 columns (the one pass at dv <= 32, or the scores); the
    score tile's q rows within TILE_CHANNELS, so its shared memory fits."""
    for dv in (8, 64, 1024):
        assert lwa.shape_error(d, dv, 7) is None
        for hgt in (9, 64):
            plan = lwa.launch_plan(1, 1, hgt, 113, d, dv, 7, SMS)
            assert plan.passes == (2 if max(d, dv) > lwa.ONE_PASS_MAX else 1)
            assert plan.rows[0] * d <= lwa.TILE_CHANNELS
            assert plan.rows[-1] <= (4 if plan.passes == 1 and dv <= 32
                                     else 2)
