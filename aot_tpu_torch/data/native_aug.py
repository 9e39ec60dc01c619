"""Fused native (C++) per-frame augmentation for static-image pretraining.

The PIL pipeline (reference: dataloaders/train_datasets.py:177-229) runs,
per frame, at FULL source resolution:

    affine transform -> 4-op color jitter (6 PIL mode converts for the hue
    shift alone) -> crop + resize to the output size

The native path composes the affine map and the crop/resize map into ONE
2x3 inverse matrix, warps straight to output resolution (bilinear image /
nearest mask, aot_tpu_torch/native/augkit.cpp), and applies the color jitter as
single in-place passes over the OUTPUT pixels. Same parameter
distributions (the samplers are shared with the PIL classes); the pixel
values differ only in resampling order — one bilinear resample instead of
two bicubic ones, and jitter applied post-warp (brightness/contrast/
saturation are affine in pixel value, so they commute with bilinear
sampling up to rounding).

~6x fewer pixels touched per frame at typical source sizes, no PIL
intermediates: measured 4.8x end-to-end on StaticTrain (see
PERFORMANCE.md "Data pipeline").
"""

from __future__ import annotations

import random

import numpy as np

from aot_tpu_torch import native
from aot_tpu_torch.data import FILL_COLOR
from aot_tpu_torch.data.image_aug import ColorJitter, GaussianBlur


def compose(a, b):
    """2x3 inverse-map composition (corner coords): out -> b -> a."""
    return [
        a[0] * b[0] + a[1] * b[3],
        a[0] * b[1] + a[1] * b[4],
        a[0] * b[2] + a[1] * b[5] + a[2],
        a[3] * b[0] + a[4] * b[3],
        a[3] * b[1] + a[4] * b[4],
        a[3] * b[2] + a[4] * b[5] + a[5],
    ]


class NativeFrameAug:
    """One fused warp + in-place jitter per frame.

    Shares the parameter samplers of the PIL classes (RandomAffine.
    sample_matrix, RandomResizedCrop.get_params, ColorJitter.sample_ops)
    so both backends draw from identical augmentation distributions.
    """

    def __init__(self, output_size, random_affine, random_resize_crop,
                 color_jitter: ColorJitter, gray_scale=None, blur=None,
                 fill=FILL_COLOR):
        self.output_size = tuple(output_size)  # (H, W)
        self.affine = random_affine
        self.rrc = random_resize_crop
        self.jitter = color_jitter
        self.gray_scale = gray_scale  # RandomGrayscale or None (v2)
        self.blur = blur              # RandomApply(GaussianBlur) or None (v2)
        self.fill = fill

    def __call__(self, img: np.ndarray, mask: np.ndarray, do_affine: bool,
                 hflip: bool = False):
        """img: (H,W,3) uint8, mask: (H,W) uint8 full-resolution sources.
        Returns (out_img uint8 (Ho,Wo,3), out_mask uint8 (Ho,Wo))."""
        h, w = img.shape[:2]
        Ho, Wo = self.output_size

        # crop/resize inverse map: out corner (x+.5, y+.5) -> source corner
        i, j, ch, cw = self.rrc.get_params(w, h)
        m = [cw / Wo, 0.0, float(j), 0.0, ch / Ho, float(i)]
        if do_affine:
            m = compose(self.affine.sample_matrix(w, h), m)
        if hflip:
            # flip applied to the SOURCE before everything else, so its
            # inverse runs last: x_src -> w - x_src (corner coordinates)
            m = compose([-1.0, 0.0, float(w), 0.0, 1.0, 0.0], m)

        out_img = native.warp_affine(img, m, (Ho, Wo), fill=self.fill,
                                     bilinear=True)
        out_mask = native.warp_affine(mask, m, (Ho, Wo), fill=0,
                                      bilinear=False)

        for name, f in self._sample_jitter_ops():
            if name == "brightness":
                native.brightness(out_img, f)
            elif name == "contrast":
                native.contrast(out_img, f)
            elif name == "saturation":
                native.saturation(out_img, f)
            elif name == "hue":
                native.hue(out_img, f)

        if self.gray_scale is not None and random.random() < self.gray_scale.p:
            native.grayscale(out_img)
        if self.blur is not None and random.random() < self.blur.p:
            out_img = _box3_blur(out_img, self.blur.fn)

        return out_img, out_mask

    def _sample_jitter_ops(self):
        jit = self.jitter
        # v2 wraps ColorJitter in RandomApply
        if hasattr(jit, "fn"):
            if random.random() >= jit.p:
                return []
            jit = jit.fn
        return jit.sample_ops()


def _box3_blur(img: np.ndarray, gaussian: GaussianBlur) -> np.ndarray:
    """Gaussian blur at output resolution via PIL (rare: v2 aug, p=0.3 —
    not worth a native kernel; at 465x465 it is ~8 ms)."""
    from PIL import Image
    return np.asarray(gaussian(Image.fromarray(img)), np.uint8)
