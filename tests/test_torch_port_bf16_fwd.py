"""The bf16 forward kernels of the port (csrc/local_window_attn_bf16.cu,
csrc/flash_attn_fwd_bf16.cu), emulated in plain PyTorch on the CPU, and
their launch plans (csrc/local_window_attn_bf16_plan.h,
csrc/flash_attn_fwd_bf16_plan.h, each built here alone with the host C++
compiler, as the wrappers read them through ctypes).

The emulations compute what each kernel computes, in its decomposition, on
bf16 inputs (fp64 where the kernel's sums are exact or fp32-accurate):
  local  the plan's tiles (rows x 16 queries, 32-key halo rows, value
         tiles of 32/128/256 columns): S = q k^T of the widened operands
         then scaled, rel_bias and the masked softmax in fp32, P split into
         a bf16 high and low part for two bf16 products against V, the
         rel_v product in fp32, the output rounded to bf16 once;
  flash  the plan's key splits and value tiles: per value tile the online
         softmax over 64-key tiles (fp32 m, l; S scaled after), P rounded
         to bf16 for P V, O summed in the tensor core's accumulator (the
         sum of each 16-key step rounded toward zero into it) and rescaled
         in fp32, the splits' (out_i, lse_i) merged in split order.
Each is held to the JAX package's Pallas kernels at bf16 in interpret mode
(local_window_attention_flat / _wide, _flash_fwd_raw) and to the port's
plain versions. Tolerance: 2^-7 of the largest entry, against the card's
gate of 1e-2 (chip_smoke.py phase 19). Measured: the local emulation
1.1-2.2e-3 (one bf16 step of the output at its largest entries: the
emulation and the TPU kernel each round their fp32 result once, their fp32
sums in another order); the flash emulation 3.3-4.9e-3, as the plain
version's own distance from the TPU kernel (3.9-6.6e-3): P is rounded to
bf16 relative to the running max, which moves at the kernel's 64-key tile
boundaries, the TPU kernel's 128-key ones and, in the plain version, not
at all. chip_smoke.py holds the kernels themselves to the plain versions
on the card.

test_p_split_keeps_the_tpu_function records why the local kernel splits P.
"""

import ctypes
import functools
import math
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aot_tpu.ops.pallas.flash_attn_vjp import _flash_fwd_raw
from aot_tpu.ops.pallas.local_window_attn import (local_window_attention_flat,
                                                   local_window_attention_wide)
from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import local_window_attn as lwa

BF16 = torch.bfloat16
TOL = 2.0 ** -7        # of the largest entry: two bf16 roundings
SMS = 132              # an H100 SXM's multiprocessors
CSRC = Path(lwa.__file__).resolve().parents[2] / "csrc"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def host_lib(header: str) -> ctypes.CDLL:
    """A plan header built alone as a shared library (the host compiler,
    once a process)."""
    out = Path(tempfile.mkdtemp(prefix="bf16_plan_")) / "plan.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-std=c++17", "-O1",
                    "-shared", "-fPIC", "-x", "c++", str(CSRC / header), "-o",
                    str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn in ("lwa_bf16_plan", "fwd_bf16_plan"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, fn).restype = ctypes.c_longlong
    return lib


def local_plan(b, h, hgt, wid, d, dv, max_dis, rel_v, sms=SMS):
    """The bf16 local kernel's plan by field name (and the smem bytes)."""
    lib = host_lib("local_window_attn_bf16_plan.h")
    plan = (ctypes.c_longlong * lib.lwa_bf16_plan_len())(
        b, h, hgt, wid, d, dv, max_dis, int(rel_v))
    smem = lib.lwa_bf16_plan(plan, sms)
    got = {n: lwa.bf16_plan_value(plan, n) for n in lwa.BF16_PLAN_OUTPUTS}
    return got, smem


def flash_plan(b, h, lq, lk, d, dv, sms=SMS):
    """The bf16 flash forward's plan by field name (and the workspace)."""
    lib = host_lib("flash_attn_fwd_bf16_plan.h")
    plan = (ctypes.c_longlong * lib.fwd_bf16_plan_len())(b, h, lq, lk, d, dv)
    work = lib.fwd_bf16_plan(plan, sms)
    got = {n: fa.bf16_plan_value(plan, n) for n in fa.BF16_PLAN_OUTPUTS}
    return got, work


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).to(x.dtype)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, rounded toward zero: how the tensor core writes its
    fp32 accumulator after each product."""
    x32 = x.float()
    over = x32.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def rel(got, want) -> float:
    got, want = (torch.as_tensor(np.array(x, np.float32)).double()
                 for x in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


# --- the local-window kernel ----------------------------------------------


def _local_inputs(b, hgt, wid, h, d, dv, m, with_rv, seed):
    """bf16-exact q, k, v (as float32), rel_bias, rel_v."""
    rng = np.random.RandomState(seed)
    hw, win2 = hgt * wid, (2 * m + 1) ** 2
    qkv = [rng.randn(b, hw, h * c).astype(np.float32) for c in (d, d, dv)]
    qkv = [bf16_round(torch.from_numpy(x)).numpy() for x in qkv]
    rb = (0.3 * rng.randn(b, h, hw, win2)).astype(np.float32)
    rv = (0.3 * rng.randn(h, dv, win2)).astype(np.float32) if with_rv else None
    return (*qkv, rb, rv)


def _halo(img, ky, x0, m):
    """(N, 32, C): the 32 halo keys of image row ky from column x0 - m,
    zero off the image (img: (N, H, W, C))."""
    n, _, wid, c = img.shape
    out = img.new_zeros(n, 32, c)
    lo, hi = max(0, x0 - m), min(wid, x0 - m + 32)
    if hi > lo:
        out[:, lo - (x0 - m):hi - (x0 - m)] = img[:, ky, lo:hi]
    return out


def emulate_local(q, k, v, rel_bias, rel_v, *, num_heads, size_2d, max_dis,
                  p_split=True, round_out=True):
    """The bf16 local kernel's function in its decomposition. p_split False
    rounds P to bf16 once instead of splitting it; round_out False returns
    the fp32 result before the output's bf16 rounding."""
    hgt, wid = size_2d
    b, hw = q.shape[:2]
    h, m = num_heads, max_dis
    d, dv = q.shape[-1] // h, v.shape[-1] // h
    win, tx = 2 * m + 1, 16
    win2 = win * win
    plan, _ = local_plan(b, h, hgt, wid, d, dv, m, rel_v is not None)
    rows, vt = plan["ROWS"], plan["VALUE_TILE"]
    img = lambda x, c: (x.double().reshape(b, hgt, wid, h, c)
                        .permute(0, 3, 1, 2, 4).reshape(b * h, hgt, wid, c))
    qi, ki, vi = img(q, d), img(k, d), img(v, dv)
    rb = rel_bias.float().reshape(b * h, hgt, wid, win2)
    col = torch.arange(tx)[:, None] + torch.arange(win)      # x + dx
    band = torch.arange(32) - torch.arange(tx)[:, None]      # c - x
    on_band = (band >= 0) & (band < win)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b * h, hgt, wid, dv, dtype=torch.float64)
    seen = torch.zeros(hgt, wid, dv, dtype=torch.int64)
    for y0 in range(0, hgt, rows):
        r_lo, r_hi = max(0, m - y0), min(rows + 2 * m, hgt - y0 + m)
        for x0 in range(0, wid, tx):
            nx = min(tx, wid - x0)
            for c0 in range(0, dv, vt):     # one block a value tile
                cols = slice(c0, min(dv, c0 + vt))
                for qrow in range(min(rows, hgt - y0)):
                    y = y0 + qrow
                    q_row = qi.new_zeros(b * h, tx, d)
                    q_row[:, :nx] = qi[:, y, x0:x0 + nx]
                    sc = torch.zeros(b * h, tx, win2, dtype=torch.float32)
                    for r in range(r_lo, r_hi):
                        dy = r - qrow
                        if not 0 <= dy < win:
                            continue
                        # exact products of bf16 values, summed, in fp32;
                        # scaled after
                        s = (q_row @ _halo(ki, y0 - m + r, x0, m)
                             .transpose(1, 2)).float() * scale
                        sc[:, :, dy * win:(dy + 1) * win] = torch.gather(
                            s[:, :, :], 2, col.expand(b * h, tx, win))
                    ky = y + torch.arange(win).repeat_interleave(win) - m
                    kx = (x0 + torch.arange(tx))[:, None] + torch.arange(
                        win).repeat(win) - m
                    ok = (ky >= 0) & (ky < hgt) & (kx >= 0) & (kx < wid)
                    sc = sc[:, :nx] + rb[:, y, x0:x0 + nx]
                    sc = sc.masked_fill(~ok[:nx], -math.inf)
                    p = torch.softmax(sc, -1)                  # fp32
                    hi = bf16_round(p)
                    lo = bf16_round(p - hi) if p_split else torch.zeros_like(p)
                    pp = (hi.double() + lo.double())
                    pfull = pp.new_zeros(b * h, tx, win2)
                    pfull[:, :nx] = pp
                    acc = out.new_zeros(b * h, tx, cols.stop - c0)
                    for r in range(r_lo, r_hi):
                        dy = r - qrow
                        if not 0 <= dy < win:
                            continue
                        a_band = torch.gather(
                            pfull[:, :, dy * win:(dy + 1) * win], 2,
                            band.clamp(0, win - 1).expand(b * h, tx, 32))
                        acc += (a_band * on_band) @ _halo(
                            vi, y0 - m + r, x0, m)[..., cols]
                    if rel_v is not None:
                        rv = rel_v.double()[:, cols].repeat(b, 1, 1)
                        pv = torch.zeros_like(pfull)
                        pv[:, :nx] = p.double()    # rel_v reads P in fp32
                        acc += pv @ rv.transpose(1, 2)
                    out[:, y, x0:x0 + nx, cols] = acc[:, :nx]
                    seen[y, x0:x0 + nx, cols] += 1
    assert torch.all(seen == 1)     # every query and column once
    out = (out.reshape(b, h, hw, dv).permute(0, 2, 1, 3)
           .reshape(b, hw, h * dv).float())
    return bf16_round(out) if round_out else out


# (B, H, W, heads, d, dv, max_dis, rel_v): the AOT head (rel_v, 32-column
# value tile, 4-row tiles at B=4), a DeAOT-like head (two value tiles of
# 256 columns, the second partial), a grid narrower than the halo
LOCAL_CASES = {
    "aot_B1": (1, 9, 20, 2, 32, 32, 3, True),
    "aot_B4": (4, 7, 17, 2, 32, 32, 2, True),
    "deaot": (1, 6, 18, 1, 16, 320, 2, False),
    "narrow": (2, 5, 3, 1, 8, 8, 1, True),
}


@functools.lru_cache(maxsize=None)
def _local_case(name):
    """(inputs, kwargs, the Pallas flat and wide kernels' outputs at bf16);
    computed once a process."""
    b, hgt, wid, h, d, dv, m, rv = LOCAL_CASES[name]
    args = _local_inputs(b, hgt, wid, h, d, dv, m, rv, seed=hgt * wid + dv)
    kw = dict(num_heads=h, size_2d=(hgt, wid), max_dis=m)
    j = [None if a is None else
         jnp.asarray(a, jnp.bfloat16 if i < 3 else jnp.float32)
         for i, a in enumerate(args)]
    flat = np.asarray(local_window_attention_flat(*j, **kw, d_att=d,
                                                  interpret=True)
                      .astype(jnp.float32))
    wide = np.asarray(local_window_attention_wide(*j, **kw, d_att=d,
                                                  rows_per_band=4,
                                                  interpret=True)
                      .astype(jnp.float32))
    t = [None if a is None else torch.from_numpy(a) for a in args]
    t[:3] = [x.to(BF16) for x in t[:3]]
    return t, kw, flat, wide


@pytest.mark.parametrize("name", list(LOCAL_CASES))
def test_local_emulation_matches_pallas_and_plain(name):
    t, kw, flat, wide = _local_case(name)
    got = emulate_local(*t, **kw)
    plain = lwa.local_window_attention_plain(*t, **kw)
    assert plain.dtype == BF16
    for want in (flat, wide, plain.float()):
        assert rel(got, want) <= TOL


def test_p_split_keeps_the_tpu_function():
    """Why the local kernel splits P into two bf16 parts: before the
    output's rounding, the split form computes the TPU kernel's fp32
    result (P V of the fp32 P; here the plain version on the widened
    inputs in fp64) to 3.2e-6 of the largest entry, one bf16 rounding of P
    only to 2.1e-3, the output's own rounding step. After rounding both
    hold the card's 1e-2 gate against the Pallas kernel (2.2e-3 and
    4.4e-3), but the single rounding moves the output's bf16 rounding on
    13,702 of 34,560 entries against the split's 80: it is another
    function. The split costs a second product a value step."""
    t, kw, flat, _ = _local_case("deaot")
    widened = [None if x is None else x.double() for x in t]
    exact = lwa.local_window_attention_plain(*widened, **kw)
    split = emulate_local(*t, **kw, round_out=False)
    single = emulate_local(*t, **kw, p_split=False, round_out=False)
    err_split, err_single = rel(split, exact), rel(single, exact)
    assert err_split <= 2.0 ** -14
    assert err_single >= 2.0 ** -11 > 8 * err_split
    flips = [int((bf16_round(x) != torch.from_numpy(flat)).sum())
             for x in (split, single)]
    assert flips[1] > 2 * flips[0]
    for x in (split, single):
        assert rel(bf16_round(x), flat) <= 1e-2


# (B, h, H, W, d, dv, rel_v): rows a tile, value tile, value tiles, blocks
LOCAL_PLANS = {
    "aot_30x30": ((1, 8, 30, 30, 32, 32, 1), (2, 32, 1, 240)),
    "aot_30x30_B4": ((4, 8, 30, 30, 32, 32, 1), (4, 32, 1, 512)),
    "deaot_30x30": ((1, 1, 30, 30, 128, 1024, 0), (1, 256, 4, 240)),
    "deaot_30x30_B4": ((4, 1, 30, 30, 128, 1024, 0), (2, 256, 4, 480)),
    "aot_64x113": ((1, 8, 64, 113, 32, 32, 1), (4, 32, 1, 1024)),
    "deaot_64x113": ((1, 1, 64, 113, 128, 1024, 0), (2, 256, 4, 1024)),
}


@pytest.mark.parametrize("name", list(LOCAL_PLANS))
def test_launch_plan_bf16_local(name):
    """The bf16 local kernel's tiles at phase 19's shapes: the tallest tile
    whose grid still gives every multiprocessor a block (4 rows only at a
    32-column value tile), 256-column value tiles at dv = 1024, and a
    shared-memory layout that fits two blocks a multiprocessor."""
    (b, h, hgt, wid, d, dv, rv), want = LOCAL_PLANS[name]
    plan, smem = local_plan(b, h, hgt, wid, d, dv, 7, rv)
    assert (plan["ROWS"], plan["VALUE_TILE"], plan["VALUE_TILES"],
            plan["BLOCKS"]) == want
    assert plan["BLOCKS"] == (-(-wid // 16) * -(-hgt // plan["ROWS"]) * b * h
                              * plan["VALUE_TILES"])
    assert plan["BLOCKS"] >= SMS or plan["ROWS"] == 1
    assert plan["WARPS"] == plan["ROWS"] * (2 if plan["ROWS"] == 4 else 4)
    assert smem == plan["SMEM"] <= 232448 // 2
    assert plan["Q_OFF"] % 128 == 0 and plan["REGION_OFF"] % 128 == 0
    assert plan["LD_S"] % 32 == 9 and plan["LD_Q"] == plan["D_PAD"] + 8
    assert plan["COPY"] == 8      # 16-byte copies: d, dv multiples of 8


@pytest.mark.parametrize("d", [4, 128, 512])
def test_launch_plan_bf16_local_fits_every_width(d):
    """Every d the kernel takes, at each value tile: a plan whose shared
    memory fits a block, a tile within 512 q/k channels x rows; a shape the
    kernel does not take gets none."""
    for dv in (4, 64, 1024):
        for hgt in (9, 64):
            plan, smem = local_plan(1, 1, hgt, 113, d, dv, 7, True)
            assert 0 < smem <= 232448
            assert plan["ROWS"] * plan["D_PAD"] <= 512 or plan["ROWS"] == 1
            assert plan["VALUE_TILE"] == (
                32 if dv <= 32 and d <= 128 else 128 if dv <= 128 else 256)
            assert plan["COPY"] == (8 if d % 8 == 0 and dv % 8 == 0 else 4)
    for bad in ((1, 1, 9, 9, 6, 32, 7, 0), (1, 1, 9, 9, 32, 32, 8, 0),
                (1, 1, 9, 9, 516, 32, 7, 0)):
        lib = host_lib("local_window_attn_bf16_plan.h")
        plan = (ctypes.c_longlong * lib.lwa_bf16_plan_len())(*bad)
        assert lib.lwa_bf16_plan(plan, SMS) == -1


# --- the flash forward ----------------------------------------------------


def emulate_flash(q, k, v, valid_len, num_heads):
    """The bf16 flash forward's function in its decomposition: (out bf16,
    lse fp32)."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    h = num_heads
    d, dv = q.shape[-1] // h, v.shape[-1] // h
    plan, _ = flash_plan(b, h, lq, lk, d, dv)
    vt, splits, per = (plan["VALUE_TILE"], plan["SPLITS"],
                       plan["TILES_PER_SPLIT"])
    live = ([lk] * b if valid_len is None else
            [min(lk, int(n)) for n in torch.as_tensor(valid_len).reshape(-1)
             .expand(b)])
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, lq, h * dv)
    lse = torch.zeros(b * h, lq)
    for bi in range(b):
        for hd in range(h):
            qh = q[bi, :, hd * d:(hd + 1) * d].double()
            kh = k[bi, :, hd * d:(hd + 1) * d].double()
            vh = v[bi, :, hd * dv:(hd + 1) * dv].double()
            parts = []
            for sp in range(splits):
                k_begin = sp * per * 64
                k_end = min(live[bi], k_begin + per * 64)
                o_tiles, m_sp, l_sp = [], None, None
                for c0 in range(0, dv, vt):   # one block a value tile
                    m = torch.full((lq, 1), fa.NEG_INF)
                    l = torch.zeros(lq, 1)
                    o = torch.zeros(lq, min(vt, dv - c0))
                    for k0 in range(k_begin, k_end, 64):
                        k1 = min(k0 + 64, k_end)
                        s = (qh @ kh[k0:k1].T).float() * scale
                        m_new = torch.maximum(m, s.amax(1, keepdim=True))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new)
                        l = l * alpha + p.sum(1, keepdim=True)
                        o = o * alpha
                        pb = bf16_round(p).double()
                        for j in range(k0, k1, 16):     # one k-step each
                            o = round_toward_zero(
                                o.double() + pb[:, j - k0:j - k0 + 16]
                                @ vh[j:min(j + 16, k1), c0:c0 + vt])
                        m = m_new
                    if m_sp is not None:   # every value tile: the same m, l
                        assert torch.equal(m, m_sp) and torch.equal(l, l_sp)
                    m_sp, l_sp = m, l
                    empty = l == 0
                    o_tiles.append(torch.where(empty, 0.0, o / torch.where(
                        empty, 1.0, l)))
                lse_i = torch.where(l_sp == 0, fa.NEG_INF,
                                    m_sp + torch.log(l_sp))
                parts.append((torch.cat(o_tiles, 1), lse_i))
            if splits == 1:
                o_h, lse_h = parts[0]
            else:   # merge_kernel, in split order
                mx = torch.stack([p[1] for p in parts]).amax(0)
                ok = mx > -1e29
                total = mx + torch.log(sum(torch.exp(p[1] - mx)
                                           for p in parts))
                total = torch.where(ok, total, fa.NEG_INF)
                o_h = sum(torch.exp(p[1] - total) * p[0] for p in parts)
                o_h = torch.where(ok, o_h, 0.0)
                lse_h = total
            out[bi, :, hd * dv:(hd + 1) * dv] = o_h
            lse[bi * h + hd] = lse_h[:, 0]
    return bf16_round(out), lse


# (B, Lq, Lk, h, d, dv, valid): the AOT head over a ragged ring (key
# splits), two value tiles with a partial one, an element with no live key
FLASH_CASES = {
    "aot_ring": (2, 130, 300, 2, 32, 32, [300, 87]),
    "two_value_tiles": (1, 70, 200, 1, 16, 320, None),
    "empty_element": (2, 64, 130, 1, 32, 40, [0, 70]),
}


@functools.lru_cache(maxsize=None)
def _flash_case(name):
    """(bf16 inputs, valid_len, the Pallas kernel's out and lse at bf16);
    computed once a process."""
    b, lq, lk, h, d, dv, valid = FLASH_CASES[name]
    rng = np.random.RandomState(lq + lk + dv)
    q, k, v = (bf16_round(torch.from_numpy(
        rng.randn(b, n, h * c).astype(np.float32))).to(BF16)
        for n, c in ((lq, d), (lk, d), (lk, dv)))
    vl = None if valid is None else torch.tensor(valid)
    block = 128

    def heads(x, dd):
        x = x.float().numpy().reshape(b, -1, h, dd).transpose(0, 2, 1, 3)
        x = x.reshape(b * h, -1, dd)
        return jnp.asarray(np.pad(x, ((0, 0), (0, (-x.shape[1]) % block),
                                      (0, 0))), jnp.bfloat16)

    live = np.full((b,), lk) if valid is None else np.asarray(valid)
    o, lse = _flash_fwd_raw(heads(q, d), heads(k, d), heads(v, dv),
                            jnp.asarray(np.repeat(live, h).astype(np.int32)),
                            scale=1.0 / math.sqrt(d), block_q=block,
                            block_k=block, interpret=True)
    o = np.asarray(o.astype(jnp.float32))[:, :lq].reshape(b, h, lq, dv)
    o = o.transpose(0, 2, 1, 3).reshape(b, lq, h * dv)
    return (q, k, v), vl, o, np.asarray(lse)[:, :lq, 0]


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_emulation_matches_pallas_and_plain(name):
    (q, k, v), vl, o_tpu, lse_tpu = _flash_case(name)
    h = FLASH_CASES[name][3]
    out, lse = emulate_flash(q, k, v, vl, h)
    plain, plain_lse = fa.flash_attention_plain(q, k, v, vl, h)
    for want, want_lse in ((o_tpu, lse_tpu), (plain.float(), plain_lse)):
        assert rel(out, want) <= TOL
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=1e-4, rtol=1e-5)
    if name == "empty_element":   # out 0 and lse -1e30, as the TPU kernel
        assert torch.all(out[0] == 0) and torch.all(lse[0] == fa.NEG_INF)


def test_flash_accumulator_rounding_is_inside_bf16():
    """Why O stays in the wgmma accumulator across key tiles: rounding each
    16-key step's sum toward zero into it (19,800 keys, DeAOTL's longest
    memory: ~1,240 steps, all one way) moves P V by ~1e-4 of its scale,
    against the output's bf16 rounding of up to 2^-9 (2.0e-3)."""
    rng = np.random.RandomState(9)
    lk = 19800
    p = bf16_round(torch.tensor(rng.rand(8, lk) / lk, dtype=torch.float32))
    v = bf16_round(torch.tensor(rng.randn(lk, 64), dtype=torch.float32))
    want = p.double() @ v.double()
    acc = torch.zeros(8, 64)
    for j in range(0, lk, 16):
        acc = round_toward_zero(acc.double() + p[:, j:j + 16].double()
                                @ v[j:j + 16].double())
    err = ((acc.double() - want).abs().max() / want.abs().max()).item()
    assert err < 2.0 ** -9 / 4


# (B, h, Lq, Lk, d, dv): d_pad, value tile, value tiles, splits, blocks,
# box columns
FLASH_PLANS = {
    "deaotl_lt": ((1, 1, 900, 19800, 128, 1024), (128, 256, 4, 4, 128, 64)),
    "deaotl_lt_B4": ((4, 1, 900, 19800, 128, 1024),
                     (128, 256, 4, 1, 128, 64)),
    "aott_ring": ((1, 8, 900, 7200, 32, 32), (32, 32, 1, 4, 256, 32)),
    "aott_training": ((16, 8, 900, 900, 32, 32), (32, 32, 1, 1, 1024, 32)),
    "gpm_training": ((16, 1, 900, 900, 128, 1024),
                     (128, 256, 4, 1, 512, 64)),
    "lt_read_training": ((16, 1, 900, 2700, 128, 1024),
                         (128, 256, 4, 1, 512, 64)),
    "d256": ((2, 1, 300, 1000, 256, 256), (256, 128, 2, 16, 192, 64)),
    "narrow_head": ((2, 2, 130, 200, 16, 48), (32, 128, 1, 4, 32, 8)),
}


@pytest.mark.parametrize("name", list(FLASH_PLANS))
def test_forward_plan_bf16(name):
    """The bf16 flash forward's plan at phase 19's shapes (and two widths
    off the paths): 128 query rows and one value tile a block, key splits
    only where the grid is under the blocks the card holds at once (one a
    multiprocessor at a 256-column value tile, two below), never past
    them, none empty by count; copy boxes 64 wide (128-byte swizzle) at
    DeAOT's heads, 32 (64-byte swizzle) at AOT's, 8 otherwise; the
    workspace holds the splits' fp32 out and lse partials."""
    (b, h, lq, lk, d, dv), want = FLASH_PLANS[name]
    plan, work = flash_plan(b, h, lq, lk, d, dv)
    assert (plan["D_PAD"], plan["VALUE_TILE"], plan["VALUE_TILES"],
            plan["SPLITS"], plan["BLOCKS"], plan["BOX_COLS"]) == want
    # a copy box lies inside one head's channels and value columns
    assert d % plan["BOX_COLS"] == 0 and dv % plan["BOX_COLS"] == 0
    base = b * h * -(-lq // 128) * plan["VALUE_TILES"]
    slots = (1 if plan["VALUE_TILE"] == 256 else 2) * SMS
    assert plan["BLOCKS"] == base * plan["SPLITS"]
    assert plan["SPLITS"] == 1 or plan["BLOCKS"] <= slots
    tiles = -(-lk // 64)
    assert (plan["SPLITS"] - 1) * plan["TILES_PER_SPLIT"] < tiles
    assert plan["SMEM"] <= 232448 and plan["STAGES"] in (3, 4)
    if plan["SPLITS"] > 1:
        n_out, n_lse = b * lq * h * dv, b * h * lq
        assert (plan["PART_LSE"]
                == plan["PART_OUT"] + 4 * plan["SPLITS"] * n_out)
        assert work == plan["WORKSPACE"] == (plan["PART_LSE"]
                                             + 4 * plan["SPLITS"] * n_lse)
    else:
        assert work == 0 and plan["PART_OUT"] == plan["PART_LSE"] == -1


def test_plan_fields_in_the_order_the_sources_read_them():
    """Both headers' PlanField enums name the wrappers' fields in order; a
    shape the kernels do not take gets no plan; the wrappers make each
    plan once a shape, against the headers built here."""
    import re

    for header, fields in (
            ("local_window_attn_bf16_plan.h",
             lwa.BF16_PLAN_FIELDS + lwa.BF16_PLAN_OUTPUTS),
            ("flash_attn_fwd_bf16_plan.h",
             fa.BF16_PLAN_FIELDS + fa.BF16_PLAN_OUTPUTS)):
        body = re.search(r"enum PlanField : int \{(.*?)\};",
                         (CSRC / header).read_text(), re.S).group(1)
        names = [x.strip() for x in re.sub(r"//[^\n]*", "", body).split(",")
                 if x.strip()]
        assert names[-1] == "kPlanLen"
        norm = lambda s: s.replace("_", "").lower()
        assert [norm(n[1:]) for n in names[:-1]] == [norm(f) for f in fields]
    lib = host_lib("flash_attn_fwd_bf16_plan.h")
    plan = (ctypes.c_longlong * lib.fwd_bf16_plan_len())(1, 1, 10, 10, 12, 8)
    assert lib.fwd_bf16_plan(plan, SMS) == -1          # d % 8 != 0


def test_wrappers_make_each_plan_once(monkeypatch):
    monkeypatch.setattr(lwa, "_bf16_lib",
                        lambda: host_lib("local_window_attn_bf16_plan.h"))
    monkeypatch.setattr(fa, "_bf16_lib",
                        lambda: host_lib("flash_attn_fwd_bf16_plan.h"))
    lwa.bf16_launch_plan.cache_clear()
    fa.bf16_launch_plan.cache_clear()
    try:
        inputs = (4, 1, 30, 30, 128, 1024, 7, 0)
        plan = lwa.bf16_launch_plan(inputs, SMS)
        assert lwa.bf16_launch_plan(inputs, SMS) is plan
        assert lwa.bf16_plan_value(plan, "ROWS") == 2
        fplan, work = fa.bf16_launch_plan((1, 1, 900, 19800, 128, 1024), SMS)
        assert fa.bf16_launch_plan((1, 1, 900, 19800, 128, 1024),
                                   SMS)[0] is fplan
        assert work == fa.bf16_plan_value(fplan, "WORKSPACE") > 0
        with pytest.raises(ValueError):
            lwa.bf16_launch_plan((1, 1, 9, 9, 6, 32, 7, 0), SMS)
    finally:
        lwa.bf16_launch_plan.cache_clear()
        fa.bf16_launch_plan.cache_clear()
