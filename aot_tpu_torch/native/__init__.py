"""Native (C++) CPU kernels for the data pipeline (the port's copy of
aot_tpu/native/; plain host C++, not a device kernel).

Builds `augkit.cpp` with the system g++ on first use (cached as
`build/aot_tpu_torch/_augkit_<hash>.so` at the repository root, beside the
CUDA libraries and outside the package, rebuilt when the source changes)
and exposes it through ctypes.
Everything degrades gracefully: if no compiler is available or the build
fails, `available()` returns False and callers fall back to the PIL path.

Disable explicitly with AOT_TPU_NATIVE_AUG=0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "augkit.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "aot_tpu_torch")

_lock = threading.Lock()
_lib = None
_tried = False


def _build_and_load():
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"_augkit_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # each process builds to a name of its own and renames it into
        # place atomically: processes that build at once (test workers on a
        # fresh checkout) never load or overwrite one another's half-written
        # library
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
               "-fPIC", "-std=c++17", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so_path)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    i, i64, f64 = ctypes.c_int, ctypes.c_int64, ctypes.c_double
    lib.warp_affine_u8.argtypes = [u8p, i, i, i, f64p, u8p, i, i, u8p, i]
    lib.brightness_u8.argtypes = [u8p, i64, f64]
    lib.contrast_u8.argtypes = [u8p, i64, f64]
    lib.saturation_u8.argtypes = [u8p, i64, f64]
    lib.hue_u8.argtypes = [u8p, i64, i]
    lib.grayscale_u8.argtypes = [u8p, i64]
    lib.relabel_u8.argtypes = [u8p, i64, u8p, i, u8p]
    for fn in (lib.warp_affine_u8, lib.brightness_u8, lib.contrast_u8,
               lib.saturation_u8, lib.hue_u8, lib.grayscale_u8,
               lib.relabel_u8):
        fn.restype = None
    return lib


def _get():
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _tried = True
                if os.environ.get("AOT_TPU_NATIVE_AUG", "1") != "0":
                    try:
                        _lib = _build_and_load()
                    except Exception:
                        _lib = None
    return _lib


def available() -> bool:
    return _get() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def warp_affine(src: np.ndarray, matrix, out_hw, fill=(0, 0, 0),
                bilinear: bool = True) -> np.ndarray:
    """Inverse-map affine warp of an HxWxC (or HxW) uint8 image.

    `matrix` is the 2x3 output->input map in PIL Image.transform
    convention (acts on pixel-corner coordinates x+0.5, y+0.5).
    """
    lib = _get()
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dh, dw = out_hw
    dst = np.empty((dh, dw, ch), np.uint8)
    m = np.ascontiguousarray(matrix, np.float64).reshape(6)
    fill_arr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(fill, np.uint8).reshape(-1), (ch,)))
    lib.warp_affine_u8(_u8(src), sh, sw, ch,
                       m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       _u8(dst), dh, dw, _u8(fill_arr), int(bilinear))
    return dst[..., 0] if squeeze else dst


def brightness(img: np.ndarray, f: float) -> None:
    _get().brightness_u8(_u8(img), img.shape[0] * img.shape[1], f)


def contrast(img: np.ndarray, f: float) -> None:
    _get().contrast_u8(_u8(img), img.shape[0] * img.shape[1], f)


def saturation(img: np.ndarray, f: float) -> None:
    _get().saturation_u8(_u8(img), img.shape[0] * img.shape[1], f)


def hue(img: np.ndarray, factor: float) -> None:
    """factor in [-0.5, 0.5] of a full hue wheel (PIL uint8 H channel)."""
    _get().hue_u8(_u8(img), img.shape[0] * img.shape[1], int(factor * 255))


def grayscale(img: np.ndarray) -> None:
    _get().grayscale_u8(_u8(img), img.shape[0] * img.shape[1])


def relabel(mask: np.ndarray, obj_list) -> np.ndarray:
    lib = _get()
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty_like(mask)
    objs = np.ascontiguousarray(np.asarray(obj_list, np.uint8))
    lib.relabel_u8(_u8(mask), mask.size, _u8(objs), len(objs), _u8(out))
    return out
