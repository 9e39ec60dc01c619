"""Builds the CUDA sources under aot_tpu_torch/csrc/ into shared libraries
with a plain C interface, loaded with ctypes.

Each library is compiled at first use with nvcc for sm_90a into
`build/aot_tpu_torch/` at the repository root, keyed by a hash of its
source, the csrc/ headers it includes and the flags, so a changed source
or header rebuilds what includes it and
an unchanged one loads at once. An engine built on a card builds and
loads the libraries its reads can launch then, before its first frame
(ops.attention.load_serving_kernels). Nothing here runs at import time:
the CPU tests import the package on machines without nvcc. Each nvcc
build counts `build.<name>` and its seconds `build.<name>.s`, each library
loaded `load.<name>` (utils/tracing.py counters).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

from aot_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parents[2]          # aot_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aot_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^#include "([^"]+)"', re.MULTILINE)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}   # name -> nvcc/ptxas output of this process


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of aot_tpu_torch are built from source at first use")
    return found


def build(*names: str) -> List[Path]:
    """Compile csrc/<name>.cu for each name not built yet — one nvcc
    process per source, all started together — and return the .so paths in
    the order of `names`. Raises if any build fails."""
    outs, jobs = [], []
    for name in names:
        src = CSRC / f"{name}.cu"
        text = src.read_bytes()
        # the csrc/ headers the source includes are part of its key
        headers = b"".join((CSRC / h).read_bytes()
                           for h in _INCLUDE.findall(text.decode()))
        digest = hashlib.sha256(text + headers
                                + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        outs.append(out)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cmd, tmp, out, proc, time.perf_counter()))
    failed = []
    for name, cmd, tmp, out, proc, t0 in jobs:
        BUILD_LOGS[name] = proc.communicate()[0]
        tracing.count(f"build.{name}")
        tracing.count(f"build.{name}.s", time.perf_counter() - t0)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{BUILD_LOGS[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
        tracing.count(f"load.{name}")
    return lib
