"""aot_tpu_torch stands alone: importing every module of the package in a
clean process leaves jax, flax and the JAX package aot_tpu (and anything
under it) out of sys.modules, and no source of the package nor
chip_smoke.py imports any of them. chip_smoke.py refuses to run without a
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
PACKAGE_IMPORT = re.compile(r"^\s*(from|import)\s+aot_tpu(\.|\s|$)", re.M)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aot_tpu_torch.__path__,
                                               "aot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "flax", "aot_tpu")))
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


def test_no_aot_tpu_import_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if PACKAGE_IMPORT.search(f.read_text())]
    assert not offenders
    assert PACKAGE_IMPORT.search("from aot_tpu.data import X")
    assert PACKAGE_IMPORT.search("    import aot_tpu")
    assert not PACKAGE_IMPORT.search("from aot_tpu_torch.data import X")


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


_RUN_HELP = """
import runpy, sys
sys.argv = [{name!r}, "--help"]
try:
    runpy.run_module({name!r}, run_name="__main__")
except SystemExit as exit_:
    assert exit_.code == 0, exit_.code
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "aot_tpu")))
"""


@pytest.mark.parametrize("name", ["aot_tpu_torch.tools.demo",
                                  "aot_tpu_torch.tools.score",
                                  "aot_tpu_torch.tools.overfit_check"])
def test_tool_entry_points_run_without_jax(name):
    """`python -m <tool> --help` parses its arguments, exits 0 and leaves
    jax, flax and aot_tpu unimported."""
    out = subprocess.run([sys.executable, "-c", _RUN_HELP.format(name=name)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=_clean_env())
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_scripts_call_the_port():
    """aot_tpu_torch/scripts/*.sh run the port's modules, each of which
    exists, and nothing under tools/."""
    scripts = sorted((PKG / "scripts").glob("*.sh"))
    assert [s.name for s in scripts] == ["inference.sh", "train_eval.sh"]
    for script in scripts:
        text = script.read_text()
        mods = re.findall(r"python -m (\S+)", text)
        assert mods and "tools/" not in text, script.name
        for mod in mods:
            path = ROOT / Path(*mod.split("."))
            assert (path.with_suffix(".py").is_file()
                    or (path / "__main__.py").is_file()), mod
