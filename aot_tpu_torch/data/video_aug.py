"""Clip-level augmentations for video training and the eval-time TTA
expansion (reference: dataloaders/video_transforms.py).

Clip samples are dicts:
  frames: list of T float32 (H, W, 3) arrays, raw 0..255
  labels: list of T uint8 (H, W) arrays
  obj_num: int
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
from PIL import Image

from aot_tpu_torch.data import FILL_COLOR, IMAGENET_MEAN, IMAGENET_STD
from aot_tpu_torch.data import image_aug as IA

cv2.setNumThreads(0)

Clip = Dict


def _resize_all(clip: Clip, fx=None, fy=None, size=None) -> Clip:
    frames = [cv2.resize(f, dsize=size, fx=fx, fy=fy,
                         interpolation=cv2.INTER_CUBIC)
              for f in clip["frames"]]
    labels = [cv2.resize(l, dsize=size, fx=fx, fy=fy,
                         interpolation=cv2.INTER_NEAREST)
              for l in clip["labels"]]
    return dict(clip, frames=frames, labels=labels)


class RandomScale:
    """Scale factor x short-edge alignment (reference:
    video_transforms.py:235-286; the short edge is aligned to
    DATA_SHORT_EDGE_LEN before the random factor)."""

    def __init__(self, min_scale=0.7, max_scale=1.3, short_edge=480):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.short_edge = short_edge

    def __call__(self, clip: Clip) -> Clip:
        sc = np.random.uniform(self.min_scale, self.max_scale)
        if self.short_edge is not None:
            h, w = clip["frames"][0].shape[:2]
            sc *= self.short_edge / min(h, w)
        return _resize_all(clip, fx=sc, fy=sc)


class BalancedRandomCrop:
    """Random crop retried until the reference frame keeps a >min_pixels
    object; relabels ids compactly (reference: video_transforms.py:122-232).
    """

    def __init__(self, output_size: Tuple[int, int], max_step=5,
                 max_obj_num=10, min_obj_pixel_num=100):
        self.output_size = tuple(output_size)
        self.max_step = max_step
        self.max_obj_num = max_obj_num
        self.min_obj_pixel_num = min_obj_pixel_num

    def __call__(self, clip: Clip) -> Clip:
        h, w = clip["frames"][0].shape[:2]
        new_h = min(self.output_size[0], h)
        new_w = min(self.output_size[1], w)
        labels = clip["labels"]

        top = left = 0
        keep_objs: List[int] = []
        for _ in range(self.max_step):
            top = np.random.randint(0, h - new_h + 1)
            left = np.random.randint(0, w - new_w + 1)
            ref_crop = labels[0][top:top + new_h, left:left + new_w]
            objs = [int(o) for o in np.unique(ref_crop) if o != 0]
            keep_objs = [o for o in objs
                         if (ref_crop == o).sum() > self.min_obj_pixel_num]
            if keep_objs:
                break
        if len(keep_objs) > self.max_obj_num:
            random.shuffle(keep_objs)
            keep_objs = keep_objs[:self.max_obj_num]

        new_labels = []
        for lab in labels:
            crop = lab[top:top + new_h, left:left + new_w]
            out = np.zeros_like(crop)
            for new_id, obj in enumerate(keep_objs, start=1):
                out[crop == obj] = new_id
            new_labels.append(out)
        new_frames = [f[top:top + new_h, left:left + new_w]
                      for f in clip["frames"]]
        return dict(clip, frames=new_frames, labels=new_labels,
                    obj_num=len(keep_objs))


class RandomHorizontalFlipClip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, clip: Clip) -> Clip:
        if random.random() < self.p:
            return dict(clip,
                        frames=[f[:, ::-1].copy() for f in clip["frames"]],
                        labels=[l[:, ::-1].copy() for l in clip["labels"]])
        return clip


class PadToSize:
    """Pad to output size with a random top/left split (reference Resize
    use_padding, video_transforms.py:69-119)."""

    def __init__(self, output_size: Tuple[int, int]):
        self.output_size = tuple(output_size)

    def __call__(self, clip: Clip) -> Clip:
        h, w = clip["frames"][0].shape[:2]
        nh, nw = self.output_size
        if (h, w) == (nh, nw):
            return clip
        t = np.random.randint(0, nh - h + 1)
        b = nh - h - t
        l = np.random.randint(0, nw - w + 1)
        r = nw - w - l
        frames = [cv2.copyMakeBorder(f, t, b, l, r, cv2.BORDER_CONSTANT,
                                     value=FILL_COLOR)
                  for f in clip["frames"]]
        labels = [cv2.copyMakeBorder(lab, t, b, l, r, cv2.BORDER_CONSTANT,
                                     value=0)
                  for lab in clip["labels"]]
        return dict(clip, frames=frames, labels=labels)


class _PerFramePIL:
    """Apply a PIL op to every frame (labels untouched)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, clip: Clip) -> Clip:
        frames = []
        for f in clip["frames"]:
            img = Image.fromarray(np.uint8(np.clip(f, 0, 255)))
            frames.append(np.asarray(self.fn(img), np.float32))
        return dict(clip, frames=frames)


class _NativeJitterClip:
    """Per-frame RandomApply(ColorJitter) via the C++ single-pass kernels
    (same per-frame sampling as the PIL path: fresh factors every frame)."""

    def __init__(self, p, jitter):
        self.p = p
        self.jitter = jitter

    def __call__(self, clip: Clip) -> Clip:
        import random

        from aot_tpu_torch import native

        frames = []
        for f in clip["frames"]:
            if random.random() < self.p:
                img = np.ascontiguousarray(np.clip(f, 0, 255), np.uint8)
                for name, fac in self.jitter.sample_ops():
                    getattr(native, name)(img, fac)
                f = np.asarray(img, np.float32)
            frames.append(f)
        return dict(clip, frames=frames)


class _NativeGrayClip:
    def __init__(self, p):
        self.p = p

    def __call__(self, clip: Clip) -> Clip:
        import random

        from aot_tpu_torch import native

        frames = []
        for f in clip["frames"]:
            if random.random() < self.p:
                img = np.ascontiguousarray(np.clip(f, 0, 255), np.uint8)
                native.grayscale(img)
                f = np.asarray(img, np.float32)
            frames.append(f)
        return dict(clip, frames=frames)


def RandomColorJitterClip(p=0.8, brightness=0.4, contrast=0.4,
                          saturation=0.2, hue=0.1):
    from aot_tpu_torch import native
    jit = IA.ColorJitter(brightness, contrast, saturation, hue)
    if native.available():
        return _NativeJitterClip(p, jit)
    return _PerFramePIL(IA.RandomApply(jit, p))


def RandomGrayScaleClip(p=0.2):
    from aot_tpu_torch import native
    if native.available():
        return _NativeGrayClip(p)
    return _PerFramePIL(IA.RandomGrayscale(p))


def RandomGaussianBlurClip(p=0.3, sigma=(0.1, 2.0)):
    return _PerFramePIL(IA.RandomApply(IA.GaussianBlur(sigma), p))


def normalize_frames(frames: List[np.ndarray]) -> np.ndarray:
    """(T, H, W, 3) float32, ImageNet-normalised."""
    arr = np.stack(frames).astype(np.float32) / 255.0
    arr -= np.asarray(IMAGENET_MEAN, np.float32)
    arr /= np.asarray(IMAGENET_STD, np.float32)
    return arr


def finalize_clip(clip: Clip, uint8: bool = True) -> Dict[str, np.ndarray]:
    """-> {'frames': (T,H,W,3) raw uint8 (normalised on device; 4x less
    host->device traffic) or f32 normalised, 'labels': (T,H,W) i32,
    'obj_num': int32}."""
    if uint8:
        frames = np.clip(np.stack(clip["frames"]), 0, 255).astype(np.uint8)
    else:
        frames = normalize_frames(clip["frames"])
    return {
        "frames": frames,
        "labels": np.stack(clip["labels"]).astype(np.int32),
        "obj_num": np.int32(clip.get("obj_num", int(clip["labels"][0].max()))),
    }


class ComposeClip:
    """Picklable sequential composition — spawn dataloader workers pickle
    the dataset, which holds the transform, so it cannot be a closure."""

    def __init__(self, steps):
        self.steps = steps

    def __call__(self, clip: Clip) -> Clip:
        for s in self.steps:
            clip = s(clip)
        return clip


def build_train_transform(cfg):
    """v1/v2 train-time pipelines (reference: trainer.py:262-287)."""
    steps = [
        RandomScale(cfg.DATA_MIN_SCALE_FACTOR, cfg.DATA_MAX_SCALE_FACTOR,
                    cfg.DATA_SHORT_EDGE_LEN),
        BalancedRandomCrop(cfg.DATA_RANDOMCROP,
                           max_obj_num=cfg.MODEL_MAX_OBJ_NUM),
    ]
    if cfg.TRAIN_AUG_TYPE == "v2":
        steps += [RandomColorJitterClip(), RandomGrayScaleClip(),
                  RandomGaussianBlurClip()]
    steps += [
        RandomHorizontalFlipClip(cfg.DATA_RANDOMFLIP),
        PadToSize(cfg.DATA_RANDOMCROP),
    ]
    return ComposeClip(steps)


# --- eval-time TTA expansion -------------------------------------------------


def restrict_size(h: int, w: int, scale: float, max_short_edge,
                  max_long_edge, align_corners: bool,
                  max_stride: int = 16) -> Tuple[int, int]:
    """Stride-16-snapped eval size (reference MultiRestrictSize,
    video_transforms.py:609-655): align_corners sizes are =1 (mod 16),
    otherwise =0 (mod 16)."""
    sc = 1.0
    if max_short_edge is not None and min(h, w) > max_short_edge:
        sc = max_short_edge / min(h, w)
    nh, nw = sc * h, sc * w
    sc = 1.0
    if max_long_edge is not None and max(nh, nw) > max_long_edge:
        sc = max_long_edge / max(nh, nw)
    nh, nw = int(nh * sc * scale), int(nw * sc * scale)
    if align_corners:
        if (nh - 1) % max_stride != 0:
            nh = int(round((nh - 1) / max_stride) * max_stride + 1)
        if (nw - 1) % max_stride != 0:
            nw = int(round((nw - 1) / max_stride) * max_stride + 1)
    else:
        if nh % max_stride != 0:
            nh = int(round(nh / max_stride) * max_stride)
        if nw % max_stride != 0:
            nw = int(round(nw / max_stride) * max_stride)
    return nh, nw


def multi_restrict_size(image: np.ndarray,
                        label: Optional[np.ndarray],
                        multi_scale=(1.0,),
                        flip: bool = False,
                        max_short_edge=None,
                        max_long_edge=800 * 1.3,
                        align_corners: bool = True):
    """Expand one eval frame into TTA variants: per scale a resized image
    (label kept at original size), plus flipped copies. Returns a list of
    dicts {image (H',W',3) normalised, label or None, flip: bool}."""
    h, w = image.shape[:2]
    out = []
    for scale in multi_scale:
        nh, nw = restrict_size(h, w, scale, max_short_edge, max_long_edge,
                               align_corners)
        if (nh, nw) != (h, w):
            img = cv2.resize(image, dsize=(nw, nh),
                             interpolation=cv2.INTER_CUBIC)
        else:
            img = image
        norm = (img.astype(np.float32) / 255.0 -
                np.asarray(IMAGENET_MEAN, np.float32)) / \
            np.asarray(IMAGENET_STD, np.float32)
        out.append({"image": norm, "label": label, "flip": False})
        if flip:
            out.append({"image": norm[:, ::-1].copy(),
                        "label": None if label is None else
                        label[:, ::-1].copy(),
                        "flip": True})
    return out
