"""aot_tpu_torch stays free of JAX: importing every module of the package
leaves jax and flax out of sys.modules, and neither the package nor
chip_smoke.py has a JAX import. chip_smoke.py refuses to run without a
card, and outside a checkout of the repository."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "aot_tpu_torch"
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aot_tpu_torch.__path__,
                                               "aot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "flax")))
"""


def _clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_importing_every_module_leaves_jax_out():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=_clean_env())
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.split(" ", 1)
    assert int(count) >= 20
    assert loaded.strip() == "[]"


def test_no_jax_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if JAX_IMPORT.search(f.read_text())]
    assert not offenders


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=300, env=_clean_env())
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
