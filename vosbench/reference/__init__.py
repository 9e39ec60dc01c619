"""The plain reference (`model.py`, `stream.py`, `encoders/<name>.py`).

A cell reaches it through its own root with `load(root)`, never by a fixed
import, so that a copy of the benchmark folder runs the files it holds: a
configuration whose encoder the shipped files lack brings
`encoders/<MODEL_ENCODER>.py` and nothing else.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root) -> types.ModuleType:
    """The reference package under `root` (a benchmark folder), with its
    `model` and `stream` modules loaded: this package where `root` is the
    folder it lies in, else root/reference loaded by path as a package of
    its own (named from its path, loaded once a process)."""
    path = (Path(root) / "reference").resolve()
    if path == HERE:
        pkg = sys.modules[__name__]
    else:
        name = ("vosbench_reference_"
                + hashlib.sha1(str(path).encode()).hexdigest()[:12])
        pkg = sys.modules.get(name)
        if pkg is None:
            spec = importlib.util.spec_from_file_location(
                name, path / "__init__.py",
                submodule_search_locations=[str(path)])
            pkg = importlib.util.module_from_spec(spec)
            sys.modules[name] = pkg
            spec.loader.exec_module(pkg)
    for module in ("model", "stream"):
        importlib.import_module(f"{pkg.__name__}.{module}")
    return pkg
