"""The launch plan of the flash backward's Hopper kernels
(csrc/flash_attn_bwd_plan.h, which alone owns it; ops/kernels/flash_attn_bwd.py
reads it through ctypes): the header is built here alone with the host C++
compiler, and the plan it fills is held on the CPU — the fields in the
order the wrapper writes and reads them, the workspace regions (aligned,
disjoint, within the workspace the plan returns), the one-pass and
two-pass forms and their padding, the slab budget, dQ's splits, and the
wrapper's plan made once a shape. No kernel runs here; chip_smoke.py
phases 8 and 23 hold the kernels against their plain version on the card.
"""

import ctypes
import functools
import os
import re
import subprocess
import tempfile
from pathlib import Path

import pytest
import torch

from aot_tpu_torch.ops.kernels import flash_attn as fa
from aot_tpu_torch.ops.kernels import flash_attn_bwd as fab

HEADER = (Path(fab.__file__).resolve().parents[2] / "csrc"
          / "flash_attn_bwd_plan.h")
ARRAYS = ("Q", "K", "V", "DO", "QT", "KT", "DOT", "PT", "DST", "DS")


@functools.lru_cache(maxsize=None)
def host_lib() -> ctypes.CDLL:
    """The plan header built alone as a shared library (the host compiler,
    once a process), bound as the wrapper binds the card's library."""
    out = Path(tempfile.mkdtemp(prefix="bwd_plan_")) / "plan.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-std=c++17", "-O1",
                    "-shared", "-fPIC", "-x", "c++", str(HEADER), "-o",
                    str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.flash_attn_bwd_plan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_longlong]
    lib.flash_attn_bwd_plan.restype = ctypes.c_longlong
    return lib


def c_plan(b, lq, lk, h, d, dv, dtype=torch.float32, sms=132):
    """The plan the header fills for a shape: its PLAN_OUTPUTS by name, and
    for each packed array (hi offset, lo offset, rows, columns)."""
    lib = host_lib()
    plan = (ctypes.c_longlong * lib.flash_attn_bwd_plan_len())(
        b, h, lq, lk, d, dv, lk, *range(8))
    work = lib.flash_attn_bwd_plan(plan, int(dtype == torch.bfloat16), sms,
                                   fa.SLAB_FLOATS)
    got = {name: fab.plan_value(plan, name) for name in fab.PLAN_OUTPUTS}
    assert got["WORKSPACE"] == work
    base = len(fab.PLAN_FIELDS) + len(fab.PLAN_OUTPUTS)
    for i, name in enumerate(ARRAYS):
        got[name] = tuple(plan[base + 4 * i:base + 4 * i + 4])
    return got


def _enum(name: str):
    """The identifiers of `enum name : int { ... }` in the header."""
    body = re.search(r"enum %s : int \{(.*?)\};" % name,
                     HEADER.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [x.strip() for x in body.split(",") if x.strip()]


def _norm(name: str) -> str:
    return name.replace("_", "").lower()


def test_plan_fields_in_the_order_the_source_reads_them():
    fields = _enum("PlanField")
    assert fields[-1] == "kArrays"
    assert [_norm(f[1:]) for f in fields[:-1]] == [
        _norm(f) for f in fab.PLAN_FIELDS + fab.PLAN_OUTPUTS]
    arrays = _enum("Array")
    assert arrays[-1] == "kNumArrays"
    assert [_norm(a[1:]) for a in arrays[:-1]] == [_norm(a) for a in ARRAYS]
    assert host_lib().flash_attn_bwd_plan_len() == len(fields) - 1 + 4 * len(
        ARRAYS)
    # the inputs stay as written; the strides pass through
    lib = host_lib()
    plan = (ctypes.c_longlong * lib.flash_attn_bwd_plan_len())(
        2, 2, 130, 200, 32, 32, 200, *range(8))
    work = lib.flash_attn_bwd_plan(plan, 0, 132, fa.SLAB_FLOATS)
    assert list(plan[:len(fab.PLAN_FIELDS)]) == [2, 2, 130, 200, 32, 32, 200,
                                                 *range(8)]
    assert fab.plan_value(plan, "FORM") == 0
    assert fab.plan_value(plan, "WORKSPACE") == work > 0
    # a shape the kernels do not take gets no plan
    plan[0] = 0
    assert lib.flash_attn_bwd_plan(plan, 0, 132, fa.SLAB_FLOATS) == -1


SHAPES = [(16, 900, 900, 8, 32, 32), (2, 130, 200, 2, 32, 32),
          (2, 333, 1000, 8, 32, 32), (16, 900, 900, 1, 128, 1024),
          (16, 900, 2700, 1, 128, 1024), (1, 900, 19800, 1, 128, 1024),
          (1, 7232, 14464, 1, 128, 1024), (2, 300, 1000, 2, 64, 64),
          (1, 100, 7, 1, 256, 256), (2, 64, 64, 1, 16, 48)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d,dv", SHAPES)
def test_workspace_regions(b, lq, lk, h, d, dv, dtype):
    plan = c_plan(b, lq, lk, h, d, dv, dtype)
    elem = 4 if dtype == torch.float32 else 2
    kc = 128 // elem        # columns of one 128-byte chunk
    one_pass = plan["FORM"] == 0
    assert one_pass == (d <= 32 and dv <= 32)
    regions = []
    for name in ARRAYS:
        hi, lo, rows, cols = plan[name]
        size = b * h * rows * cols * elem
        assert (lo == -1) == (dtype == torch.bfloat16)
        regions += [(hi, size)] + ([(lo, size)] if lo >= 0 else [])
        if size:
            assert cols % kc == 0
    splits = plan["SPLITS"]
    if plan["DQ_PART"] >= 0:
        regions.append((plan["DQ_PART"], splits * b * lq * h * d * 4))
    if plan["ACC"] >= 0:
        regions.append((plan["ACC"], b * lk * h * (dv + d) * 4))
    regions.append((plan["DELTA"], b * h * lq * 4))
    regions = sorted(r for r in regions if r[1])
    for (a, n), (c, _) in zip(regions, regions[1:]):
        assert a % 128 == 0 and a + n <= c
    assert regions[-1][0] + regions[-1][1] <= plan["WORKSPACE"]
    lqp, lkp = -(-lq // 128) * 128, -(-lk // 128) * 128
    assert plan["Q"][2] == lqp and plan["K"][2] == lkp
    assert plan["QT"][3] == lqp and plan["KT"][3] == lkp
    assert (splits > 1) == (plan["DQ_PART"] >= 0)
    assert 1 <= splits <= 32
    slab = plan["SLAB"]
    if one_pass:
        # the one-pass kernels' transposed tiles: 32 channel rows
        assert plan["QT"][2] == plan["DOT"][2] == 32
        assert slab == 0 and plan["PT"][2:] == (0, 0)
    else:
        assert slab % 128 == 0 and plan["GROUPS"] >= 1
        assert plan["PT"][2:] == plan["DST"][2:] == (lkp, slab)
        assert plan["DS"][2:] == (slab, lkp)
        assert b * h * slab * lkp <= max(fa.SLAB_FLOATS, b * h * 128 * lkp)
        assert plan["DOT"][2] % 128 == 0
        assert plan["QT"][2] % 128 == 0
        assert (plan["ACC"] >= 0) == (dtype == torch.bfloat16 and lq > slab)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grids_fill_two_waves(sms, dtype):
    """Key splits and the scores kernel's groups bring a small grid toward
    two blocks a multiprocessor without passing it, and never split a grid
    that fills them (dQ's splits in the two-pass form follow the slab)."""
    for b, lq, lk, h, d, dv in SHAPES:
        plan = c_plan(b, lq, lk, h, d, dv, dtype, sms)
        if plan["FORM"] == 0:
            blocks = b * h * -(-lq // 64)
            assert plan["SPLITS"] == 1 or blocks * plan["SPLITS"] <= 2 * sms
            assert plan["SPLITS"] <= max(1, 2 * sms // blocks)
            assert plan["GROUPS"] == 0
        else:
            blocks = b * h * -(-min(plan["SLAB"], lq) // 128)
            assert plan["GROUPS"] * blocks <= max(blocks, 2 * sms)
            assert 1 <= plan["GROUPS"] <= -(-lk // 64)


def test_plan_is_made_once_a_shape(monkeypatch):
    """The wrapper's launch_plan, against the header built here: the plan
    the header fills, made once a shape, its workspace what it returned."""
    monkeypatch.setattr(fab, "_lib", host_lib)
    fab.launch_plan.cache_clear()
    inputs = (16, 8, 900, 900, 32, 32, 900, 1, 2, 3, 4, 5, 6, 7, 8)
    plan, work = fab.launch_plan(inputs, torch.bfloat16, 132)
    assert fab.launch_plan(inputs, torch.bfloat16, 132)[0] is plan
    assert work == fab.plan_value(plan, "WORKSPACE")
    assert fab.plan_value(plan, "SPLITS") == c_plan(
        16, 900, 900, 8, 32, 32, torch.bfloat16)["SPLITS"]
    fab.launch_plan.cache_clear()
