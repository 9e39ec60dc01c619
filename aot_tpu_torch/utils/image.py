"""Mask/image IO (reference: utils/image.py).

Masks are saved as palettised PNGs in a background thread; the palette is
the VOS-standard 22-color table followed by a grayscale ramp (reference
_palette, utils/image.py:6-58).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
from PIL import Image

_BASE_COLORS = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (128, 128, 128),
    (64, 0, 0), (191, 0, 0), (64, 128, 0), (191, 128, 0),
    (64, 0, 128), (191, 0, 128), (64, 128, 128), (191, 128, 128),
    (0, 64, 0), (128, 64, 0), (0, 191, 0), (128, 191, 0),
    (0, 64, 128), (128, 64, 128),
]


def vos_palette() -> List[int]:
    pal = []
    for c in _BASE_COLORS:
        pal.extend(c)
    for i in range(len(_BASE_COLORS), 256):
        pal.extend((i, i, i))
    return pal


_PALETTE = vos_palette()


def label2colormap(label: np.ndarray) -> np.ndarray:
    """Bit-interleaved color map for logging overlays
    (reference: utils/image.py:61-66)."""
    m = label.astype(np.uint8)
    r, c = m.shape
    cmap = np.zeros((r, c, 3), dtype=np.uint8)
    cmap[:, :, 0] = (m & 1) << 7 | (m & 8) << 3 | (m & 64) >> 1
    cmap[:, :, 1] = (m & 2) << 6 | (m & 16) << 2 | (m & 128) >> 2
    cmap[:, :, 2] = (m & 4) << 5 | (m & 32) << 1
    return cmap


def _write_mask(mask: np.ndarray, path: str,
                squeeze_idx: Optional[List[int]] = None) -> None:
    if squeeze_idx is not None:
        out = np.zeros_like(mask)
        for idx in range(1, len(squeeze_idx)):
            out[mask == idx] = squeeze_idx[idx]
        mask = out
    im = Image.fromarray(mask.astype(np.uint8)).convert("P")
    im.putpalette(_PALETTE)
    im.save(path)


def save_mask_async(mask: np.ndarray, path: str,
                    squeeze_idx: Optional[List[int]] = None) -> threading.Thread:
    """PNG write off the hot loop (reference: utils/image.py:103-105)."""
    t = threading.Thread(target=_write_mask, args=(mask, path, squeeze_idx))
    t.start()
    return t


def masked_image(image: np.ndarray, colored_mask: np.ndarray,
                 mask: np.ndarray, alpha: float = 0.7) -> np.ndarray:
    """Overlay for demo videos (reference: utils/image.py:77-83), HWC."""
    m = (mask > 0)[..., None]
    blend = image * alpha + colored_mask * (1 - alpha)
    return np.where(m, blend, image)
