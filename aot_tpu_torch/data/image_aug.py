"""PIL-level pairwise (image, mask) augmentations for static-image
pretraining (reference: dataloaders/image_transforms.py). torchvision-free:
affine/crop math and color jitter are implemented directly.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter

from aot_tpu_torch.data import FILL_COLOR


def pair_hflip(img: Image.Image, mask: Image.Image, p: float):
    if random.random() < p:
        return (img.transpose(Image.FLIP_LEFT_RIGHT),
                mask.transpose(Image.FLIP_LEFT_RIGHT))
    return img, mask


def _inv_affine_matrix(center, angle, translate, scale, shear):
    """PIL Image.transform needs the INVERSE map (output->input); same math
    as torchvision's _get_inverse_affine_matrix."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate

    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    # inverse of scale * rotation/shear
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    # apply inverse of translation + center
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


class RandomAffine:
    """Rotation/translation/scale/shear keeping the center invariant
    (reference: image_transforms.py:94-260). Mask resampled NEAREST."""

    def __init__(self, degrees=20, translate=(0.1, 0.1), scale=(0.9, 1.1),
                 shear=10, resample=Image.BICUBIC, fillcolor=FILL_COLOR):
        self.degrees = (-degrees, degrees) if not isinstance(
            degrees, (tuple, list)) else degrees
        self.translate = translate
        self.scale = scale
        self.shear = ([-shear, shear, 0.0, 0.0] if not isinstance(
            shear, (tuple, list)) else list(shear))
        self.resample = resample
        self.fillcolor = fillcolor

    def sample_matrix(self, w: int, h: int):
        """Sample affine params and return the 2x3 inverse (output->input)
        map — shared by the PIL path and the native fused-warp path."""
        angle = random.uniform(*self.degrees)
        if self.translate is not None:
            max_dx, max_dy = self.translate[0] * w, self.translate[1] * h
            translate = (round(random.uniform(-max_dx, max_dx)),
                         round(random.uniform(-max_dy, max_dy)))
        else:
            translate = (0, 0)
        scale = random.uniform(*self.scale) if self.scale else 1.0
        shear = [random.uniform(self.shear[0], self.shear[1]),
                 random.uniform(self.shear[2], self.shear[3])]
        center = (w * 0.5, h * 0.5)
        return _inv_affine_matrix(center, angle, translate, scale, shear)

    def __call__(self, img: Image.Image, mask: Image.Image):
        w, h = img.size
        m = self.sample_matrix(w, h)
        img = img.transform((w, h), Image.AFFINE, m, self.resample,
                            fillcolor=self.fillcolor)
        mask = mask.transform((w, h), Image.AFFINE, m, Image.NEAREST,
                              fillcolor=0)
        return img, mask


class RandomResizedCrop:
    """Random-area crop resized to a fixed size
    (reference: image_transforms.py:344-437)."""

    def __init__(self, size, scale=(0.8, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=Image.BICUBIC):
        self.size = tuple(size)  # (h, w)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def get_params(self, w: int, h: int):
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                return i, j, ch, cw
        in_ratio = w / h
        if in_ratio < min(self.ratio):
            cw = w
            ch = int(round(cw / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            ch = h
            cw = int(round(ch * max(self.ratio)))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def __call__(self, img: Image.Image, mask: Image.Image):
        w, h = img.size
        i, j, ch, cw = self.get_params(w, h)
        box = (j, i, j + cw, i + ch)
        out = (self.size[1], self.size[0])
        img = img.resize(out, self.interpolation, box=box)
        mask = mask.resize(out, Image.NEAREST, box=box)
        return img, mask


class ColorJitter:
    """brightness/contrast/saturation multiplicative jitter + hue shift,
    applied in random order (torchvision ColorJitter semantics; the
    reference uses TF.ColorJitter, train_datasets.py:143-148)."""

    def __init__(self, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.03):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _hue_shift(img: Image.Image, factor: float) -> Image.Image:
        if factor == 0:
            return img
        h, s, v = img.convert("HSV").split()
        arr = np.array(h, np.uint8)
        arr = (arr.astype(np.int16) + int(factor * 255)) % 256
        h = Image.fromarray(arr.astype(np.uint8), "L")
        return Image.merge("HSV", (h, s, v)).convert("RGB")

    def sample_ops(self):
        """Sample (name, factor) pairs in a random application order —
        shared by the PIL path and the native single-pass path."""
        ops = []
        if self.brightness > 0:
            ops.append(("brightness", random.uniform(
                max(0, 1 - self.brightness), 1 + self.brightness)))
        if self.contrast > 0:
            ops.append(("contrast", random.uniform(
                max(0, 1 - self.contrast), 1 + self.contrast)))
        if self.saturation > 0:
            ops.append(("saturation", random.uniform(
                max(0, 1 - self.saturation), 1 + self.saturation)))
        if self.hue > 0:
            ops.append(("hue", random.uniform(-self.hue, self.hue)))
        random.shuffle(ops)
        return ops

    _PIL_OPS = {
        "brightness": lambda im, f: ImageEnhance.Brightness(im).enhance(f),
        "contrast": lambda im, f: ImageEnhance.Contrast(im).enhance(f),
        "saturation": lambda im, f: ImageEnhance.Color(im).enhance(f),
    }

    def __call__(self, img: Image.Image) -> Image.Image:
        for name, f in self.sample_ops():
            if name == "hue":
                img = self._hue_shift(img, f)
            else:
                img = self._PIL_OPS[name](img, f)
        return img


class RandomApply:
    def __init__(self, fn, p: float):
        self.fn = fn
        self.p = p

    def __call__(self, img):
        return self.fn(img) if random.random() < self.p else img


class RandomGrayscale:
    def __init__(self, p: float = 0.2):
        self.p = p

    def __call__(self, img: Image.Image) -> Image.Image:
        if random.random() < self.p:
            return img.convert("L").convert("RGB")
        return img


class GaussianBlur:
    """SimCLR-style (reference: image_transforms.py:83-91)."""

    def __init__(self, sigma=(0.1, 2.0)):
        self.sigma = sigma

    def __call__(self, img: Image.Image) -> Image.Image:
        s = random.uniform(*self.sigma)
        return img.filter(ImageFilter.GaussianBlur(radius=s))


def to_onehot_relabel(mask: np.ndarray, max_obj_n: int, shuffle: bool,
                      obj_list: Optional[List[int]] = None):
    """Compact + optionally shuffle object ids (reference ToOnehot,
    image_transforms.py:443-485). Returns (relabelled mask, obj_list)."""
    if obj_list is None:
        obj_list = [int(i) for i in np.unique(mask) if i != 0]
        if shuffle:
            random.shuffle(obj_list)
        obj_list = obj_list[:max_obj_n]
    from aot_tpu_torch import native
    if native.available():
        return native.relabel(mask, obj_list), obj_list
    out = np.zeros_like(mask, np.uint8)
    for new_id, obj in enumerate(obj_list, start=1):
        out[mask == obj] = new_id
    return out, obj_list
