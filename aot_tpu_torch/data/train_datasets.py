"""Training datasets (reference: dataloaders/train_datasets.py).

Samples are clip dicts (see video_aug) finalised to stacked numpy arrays.
Covers: StaticTrain (5-frame clips synthesised from one image), VOSTrain
(DAVIS/YouTube-VOS clip sampling with random gaps/reversal/consistency
retries), dynamic copy-paste merging, and the synthetic TEST fixture.
"""

from __future__ import annotations

import json
import os
import random
from glob import glob
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np
from PIL import Image

from aot_tpu_torch.data import image_aug as IA
from aot_tpu_torch.data import video_aug as VA

cv2.setNumThreads(0)


def merge_clips(c1: Dict, c2: Dict, min_obj_pixels: int = 100,
                max_obj_n: int = 10) -> Dict:
    """Copy-paste merge: c2's foreground pasted over c1, ids offset then
    re-compacted; small objects dropped; capped at max_obj_n
    (reference: _merge_sample, train_datasets.py:27-84)."""
    t = len(c1["frames"])
    merged_f, merged_l = [], []
    keep: Optional[List[int]] = None
    lut = None
    for i in range(t):
        f1, f2 = c1["frames"][i], c2["frames"][i]
        # ids are <= max_obj_n and the offset sum <= 2*max_obj_n: uint8-safe
        l1 = np.asarray(c1["labels"][i], np.uint8)
        l2 = np.asarray(c2["labels"][i], np.uint8)
        fg2 = (l2 > 0)
        img = np.where(fg2[..., None], f2, f1)
        lab = np.where(fg2, l2 + np.uint8(max_obj_n), l1)
        if i == 0:
            ids, counts = np.unique(lab, return_counts=True)
            keep = [int(o) for o, c in zip(ids, counts)
                    if o != 0 and c > min_obj_pixels]
            if len(keep) > max_obj_n:
                random.shuffle(keep)
                keep = keep[:max_obj_n]
            lut = np.zeros(256, np.uint8)
            for new_id, obj in enumerate(keep, start=1):
                lut[obj] = new_id
        merged_f.append(img)
        merged_l.append(lut[lab])
    return dict(frames=merged_f, labels=merged_l, obj_num=len(keep))


class StaticTrain:
    """5-frame pseudo-videos from single annotated images
    (reference: train_datasets.py:87-249)."""

    DATASET_NAMES = ["COCO", "ECSSD", "MSRA10K", "PASCAL-S", "PASCALVOC2012"]

    def __init__(self, root: str, output_size, seq_len=5, max_obj_n=10,
                 dynamic_merge=True, merge_prob=1.0, aug_type="v1",
                 aug_backend="auto"):
        self.root = root
        self.clip_n = seq_len
        self.output_size = tuple(output_size)
        self.max_obj_n = max_obj_n
        self.dynamic_merge = dynamic_merge
        self.merge_prob = merge_prob
        self.aug_type = aug_type

        self.img_list: List[str] = []
        self.mask_list: List[str] = []
        for name in self.DATASET_NAMES:
            img_dir = os.path.join(root, "JPEGImages", name)
            mask_dir = os.path.join(root, "Annotations", name)
            imgs = sorted(glob(os.path.join(img_dir, "*.jpg"))) + \
                sorted(glob(os.path.join(img_dir, "*.png")))
            masks = sorted(glob(os.path.join(mask_dir, "*.png")))
            if imgs and len(imgs) == len(masks):
                self.img_list += imgs
                self.mask_list += masks

        self.pre_hflip_p = 0.5
        self.frame_hflip_p = 0.3
        if aug_type == "v1":
            self.color_jitter = IA.ColorJitter(0.1, 0.1, 0.1, 0.03)
            self.gray_scale = None
            self.blur = None
        else:  # v2
            self.color_jitter = IA.RandomApply(
                IA.ColorJitter(0.4, 0.4, 0.2, 0.1), 0.8)
            self.gray_scale = IA.RandomGrayscale(0.2)
            self.blur = IA.RandomApply(IA.GaussianBlur((0.1, 2.0)), 0.3)
        self.random_affine = IA.RandomAffine(
            degrees=20, translate=(0.1, 0.1), scale=(0.9, 1.1), shear=10)
        base_ratio = self.output_size[1] / self.output_size[0]
        self.random_resize_crop = IA.RandomResizedCrop(
            self.output_size, (0.8, 1.0),
            ratio=(base_ratio * 3 / 4, base_ratio * 4 / 3))

        # 'auto': fused C++ warp+jitter when the native lib builds
        # (aot_tpu_torch/native/augkit.cpp — 4.8x faster per sample); 'pil'
        # forces the reference-shaped PIL chain; 'native' fails loudly.
        self.native_aug = None
        if aug_backend != "pil":
            from aot_tpu_torch import native
            if native.available():
                from aot_tpu_torch.data.native_aug import NativeFrameAug
                self.native_aug = NativeFrameAug(
                    self.output_size, self.random_affine,
                    self.random_resize_crop, self.color_jitter,
                    self.gray_scale, self.blur)
            elif aug_backend == "native":
                raise RuntimeError("aug_backend='native' but the augkit "
                                   "library failed to build/load")

    def __len__(self):
        return len(self.img_list)

    def _load(self, idx):
        img = Image.open(self.img_list[idx])
        img.load()
        mask = Image.open(self.mask_list[idx])
        mask.load()
        return img.convert("RGB"), mask.convert("P")

    def _sample_clip_native(self, idx) -> Dict:
        """Fused-warp variant of sample_clip: same chain, same parameter
        distributions, one C++ warp per frame (aot_tpu_torch/data/native_aug.py)."""
        img_pil, mask_pil = self._load(idx)
        img_np = np.asarray(img_pil, np.uint8)
        mask_np = np.asarray(mask_pil, np.uint8)
        if random.random() < self.pre_hflip_p:
            img_np, mask_np = img_np[:, ::-1], mask_np[:, ::-1]
        img_np = np.ascontiguousarray(img_np)
        mask_np = np.ascontiguousarray(mask_np)

        frames, labels = [], []
        obj_list = None
        for i in range(self.clip_n):
            hflip = i > 0 and random.random() < self.frame_hflip_p
            f_img, f_mask = self.native_aug(img_np, mask_np,
                                            do_affine=i > 0, hflip=hflip)
            m, obj_list = IA.to_onehot_relabel(
                f_mask, self.max_obj_n, shuffle=True,
                obj_list=obj_list if i > 0 else None)
            frames.append(f_img)  # uint8; finalize_clip stacks + clips
            labels.append(m)
        return dict(frames=frames, labels=labels, obj_num=len(obj_list))

    def sample_clip(self, idx) -> Dict:
        if self.native_aug is not None:
            return self._sample_clip_native(idx)
        img_pil, mask_pil = self._load(idx)
        img_pil, mask_pil = IA.pair_hflip(img_pil, mask_pil, self.pre_hflip_p)

        frames, labels = [], []
        obj_list = None
        for i in range(self.clip_n):
            img, mask = img_pil, mask_pil
            if i > 0:
                img, mask = IA.pair_hflip(img, mask, self.frame_hflip_p)
                img, mask = self.random_affine(img, mask)
            img = self.color_jitter(img)
            img, mask = self.random_resize_crop(img, mask)
            if self.aug_type == "v2":
                img = self.gray_scale(img)
                img = self.blur(img)
            m = np.array(mask, np.uint8)
            m, obj_list = IA.to_onehot_relabel(
                m, self.max_obj_n, shuffle=True,
                obj_list=obj_list if i > 0 else None)
            frames.append(np.asarray(img, np.float32))
            labels.append(m)
        return dict(frames=frames, labels=labels, obj_num=len(obj_list))

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        c1 = self.sample_clip(idx)
        if self.dynamic_merge and (c1["obj_num"] == 0
                                   or random.random() < self.merge_prob):
            rand_idx = np.random.randint(len(self))
            while rand_idx == idx:
                rand_idx = np.random.randint(len(self))
            c1 = merge_clips(c1, self.sample_clip(rand_idx),
                             max_obj_n=self.max_obj_n)
        return VA.finalize_clip(c1)


class VOSTrain:
    """Video clip sampling with random inter-frame gaps, boundary
    reflection, sequence reversal, and object-consistency retries
    (reference: train_datasets.py:252-583)."""

    def __init__(self, image_root, label_root, imglistdic, transform,
                 repeat_time=1, rand_gap=3, seq_len=5, rand_reverse=True,
                 dynamic_merge=True, merge_prob=0.3, max_obj_n=10,
                 rgb=True, enable_prev_frame=False):
        self.image_root = image_root
        self.label_root = label_root
        self.imglistdic = imglistdic
        self.transform = transform
        self.repeat_time = repeat_time
        self.rand_gap = rand_gap
        self.seq_len = seq_len
        self.rand_reverse = rand_reverse
        self.dynamic_merge = dynamic_merge
        self.merge_prob = merge_prob
        self.max_obj_n = max_obj_n
        self.rgb = rgb
        self.enable_prev_frame = enable_prev_frame
        self.seqs = list(imglistdic.keys())

    def __len__(self):
        return int(len(self.seqs) * self.repeat_time)

    # --- index sampling helpers (reference: train_datasets.py:345-422) ---
    def _ref_index(self, seqname, lablist, min_fg_pixels=200, max_try=20,
                   total_gap=0):
        search_range = len(lablist) - total_gap
        if search_range <= 1:
            return 0
        for _ in range(max_try):
            idx = np.random.randint(search_range)
            path = os.path.join(self.label_root, seqname, lablist[idx])
            if not os.path.exists(path):
                continue
            try:
                lab = np.array(Image.open(path), np.uint8)
            except Exception:
                continue
            if (lab > 0).sum() > min_fg_pixels:
                return idx
        return 0

    def _gaps(self, n, max_try=10, max_gap=999):
        for _ in range(max_try):
            gaps = [int(np.random.randint(self.rand_gap) + 1)
                    for _ in range(n)]
            if sum(gaps) <= max_gap:
                break
        return gaps, sum(gaps)

    @staticmethod
    def _reflect(total_len, index):
        if total_len <= 1:
            return 0
        while index < 0 or index >= total_len:
            if index < 0:
                index = -index
            else:
                index = 2 * (total_len - 1) - index
        return index

    def _read(self, seqname, imagelist, lablist, index):
        img_path = os.path.join(self.image_root, seqname, imagelist[index])
        image = cv2.imread(img_path).astype(np.float32)
        if self.rgb:
            image = image[:, :, ::-1].copy()
        lab_path = os.path.join(self.label_root, seqname, lablist[index])
        if not os.path.exists(lab_path):
            for alt in lablist:
                p = os.path.join(self.label_root, seqname, alt)
                if os.path.exists(p):
                    lab_path = p
                    break
        label = np.array(Image.open(lab_path), np.uint8)
        return image, label

    def sample_clip(self, idx) -> Dict:
        idx = idx % len(self.seqs)
        seqname = self.seqs[idx]
        imagelist, lablist = self.imglistdic[seqname]
        imagelist, lablist = list(imagelist), list(lablist)
        if self.rand_reverse and np.random.randint(2) == 1:
            imagelist, lablist = imagelist[::-1], lablist[::-1]

        frames = labels = None
        for _ in range(5):  # consistency retries
            if self.enable_prev_frame:
                # prev frame sampled independently; ref picked outside the
                # [prev, last-curr] span (reference:
                # train_datasets.py:476-508)
                gaps, total = self._gaps(self.seq_len - 2)
                search = len(lablist) - total
                prev_index = (np.random.randint(search) if search > 1 else 0)
                prev_img, prev_lab = self._read(seqname, imagelist, lablist,
                                                prev_index)
                mid = [(prev_img, prev_lab)]
                objs: set = set(np.unique(prev_lab).tolist())
                now = prev_index
                end_index = prev_index
                for g in gaps:
                    now = self._reflect(len(lablist), now + g)
                    end_index = max(end_index, now)
                    img, lab = self._read(seqname, imagelist, lablist, now)
                    mid.append((img, lab))
                    objs |= set(np.unique(lab).tolist())
                ref_index = self._ref_index(seqname, lablist)
                for _try in range(5):
                    if not (prev_index < ref_index <= end_index):
                        break
                    ref_index = self._ref_index(seqname, lablist)
                ref_img, ref_lab = self._read(seqname, imagelist, lablist,
                                              ref_index)
                ref_objs = set(np.unique(ref_lab).tolist())
                frames = [ref_img] + [m[0] for m in mid]
                labels = [ref_lab] + [m[1] for m in mid]
            else:
                gaps, _total = self._gaps(self.seq_len - 1)
                ref_index = self._ref_index(seqname, lablist)
                ref_img, ref_lab = self._read(seqname, imagelist, lablist,
                                              ref_index)
                ref_objs = set(np.unique(ref_lab).tolist())

                frames, labels = [ref_img], [ref_lab]
                objs = set()
                now = ref_index
                for g in gaps:
                    now = self._reflect(len(lablist), now + g)
                    img, lab = self._read(seqname, imagelist, lablist, now)
                    frames.append(img)
                    labels.append(lab)
                    objs |= set(np.unique(lab).tolist())
            if all(o in ref_objs for o in objs if o != 0):
                break

        obj_num = int(np.sort(list(ref_objs))[-1])
        clip = dict(frames=frames, labels=labels, obj_num=obj_num)
        if self.transform is not None:
            clip = self.transform(clip)
        return clip

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        c1 = self.sample_clip(idx)
        if self.dynamic_merge and (c1["obj_num"] == 0
                                   or random.random() < self.merge_prob):
            rand_idx = np.random.randint(len(self.seqs))
            while rand_idx == (idx % len(self.seqs)):
                rand_idx = np.random.randint(len(self.seqs))
            c1 = merge_clips(c1, self.sample_clip(rand_idx),
                             max_obj_n=self.max_obj_n)
        return VA.finalize_clip(c1)


class DAVIS2017_Train(VOSTrain):
    """(reference: train_datasets.py:585-645)."""

    def __init__(self, root="./DAVIS", split=("train",), transform=None,
                 full_resolution=False, year=2017, repeat_time=1,
                 rand_gap=12, seq_len=5, rand_reverse=True,
                 dynamic_merge=True, merge_prob=0.3, max_obj_n=10,
                 enable_prev_frame=False):
        resolution = "Full-Resolution" if full_resolution else "480p"
        if full_resolution and not os.path.exists(
                os.path.join(root, "JPEGImages", resolution)):
            resolution = "480p"
        image_root = os.path.join(root, "JPEGImages", resolution)
        label_root = os.path.join(root, "Annotations", resolution)
        seq_names = []
        for spt in split:
            with open(os.path.join(root, "ImageSets", str(year),
                                   spt + ".txt")) as f:
                seq_names += [s.strip() for s in f.readlines() if s.strip()]
        imglistdic = {}
        for seq in seq_names:
            images = sorted(os.listdir(os.path.join(image_root, seq)))
            labels = sorted(os.listdir(os.path.join(label_root, seq)))
            imglistdic[seq] = (images, labels)
        super().__init__(image_root, label_root, imglistdic, transform,
                         repeat_time=repeat_time, rand_gap=rand_gap,
                         seq_len=seq_len, rand_reverse=rand_reverse,
                         dynamic_merge=dynamic_merge, merge_prob=merge_prob,
                         max_obj_n=max_obj_n,
                         enable_prev_frame=enable_prev_frame)


class YOUTUBEVOS_Train(VOSTrain):
    """meta.json-driven per-object frame lists
    (reference: train_datasets.py:648-701)."""

    def __init__(self, root="./datasets/YTB", year=2019, transform=None,
                 rand_gap=3, seq_len=5, rand_reverse=True,
                 dynamic_merge=True, merge_prob=0.3, max_obj_n=10,
                 enable_prev_frame=False):
        root = os.path.join(root, str(year), "train")
        image_root = os.path.join(root, "JPEGImages")
        label_root = os.path.join(root, "Annotations")
        with open(os.path.join(root, "meta.json")) as f:
            ann = json.load(f)["videos"]
        imglistdic = {}
        for seq, info in ann.items():
            images, labels = [], []
            for obj_n, data in info["objects"].items():
                if len(data["frames"]) < 2:
                    continue
                images += [x + ".jpg" for x in data["frames"]]
                labels += [x + ".png" for x in data["frames"]]
            images = sorted(set(images))
            labels = sorted(set(labels))
            if len(images) < 2:
                continue
            imglistdic[seq] = (images, labels)
        super().__init__(image_root, label_root, imglistdic, transform,
                         repeat_time=1, rand_gap=rand_gap, seq_len=seq_len,
                         rand_reverse=rand_reverse, dynamic_merge=dynamic_merge,
                         merge_prob=merge_prob, max_obj_n=max_obj_n,
                         enable_prev_frame=enable_prev_frame)


class TEST:
    """Synthetic fixture exercising the full training loop without data on
    disk (reference: train_datasets.py:704-738)."""

    def __init__(self, seq_len=5, obj_num=3, transform=None, size=800,
                 length=3000):
        self.seq_len = seq_len
        self.obj_num = obj_num
        self.transform = transform
        self.size = size
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        img = np.zeros((self.size, self.size, 3), np.uint8)
        lab = np.ones((self.size, self.size), np.uint8)
        clip = dict(frames=[img] * self.seq_len,
                    labels=[lab] * self.seq_len,
                    obj_num=self.obj_num)
        if self.transform is not None:
            clip = self.transform(clip)
        clip["obj_num"] = self.obj_num
        return VA.finalize_clip(clip) | {"obj_num": np.int32(self.obj_num)}


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


def build_train_dataset(cfg):
    """(reference: trainer.py:290-341)."""
    transform = VA.build_train_transform(cfg)
    enable_prev = cfg.TRAIN_ENABLE_PREV_FRAME and "static" not in cfg.DATASETS
    datasets = []
    if "static" in cfg.DATASETS:
        datasets.append(StaticTrain(
            cfg.DIR_STATIC, cfg.DATA_RANDOMCROP, seq_len=cfg.DATA_SEQ_LEN,
            merge_prob=cfg.DATA_DYNAMIC_MERGE_PROB,
            max_obj_n=cfg.MODEL_MAX_OBJ_NUM, aug_type=cfg.TRAIN_AUG_TYPE,
            aug_backend=getattr(cfg, "DATA_AUG_BACKEND", "auto")))
    if "davis2017" in cfg.DATASETS:
        datasets.append(DAVIS2017_Train(
            root=cfg.DIR_DAVIS,
            full_resolution=cfg.TRAIN_DATASET_FULL_RESOLUTION,
            transform=transform, repeat_time=cfg.DATA_DAVIS_REPEAT,
            seq_len=cfg.DATA_SEQ_LEN, rand_gap=cfg.DATA_RANDOM_GAP_DAVIS,
            rand_reverse=cfg.DATA_RANDOM_REVERSE_SEQ,
            merge_prob=cfg.DATA_DYNAMIC_MERGE_PROB,
            max_obj_n=cfg.MODEL_MAX_OBJ_NUM,
            enable_prev_frame=enable_prev))
    if "youtubevos" in cfg.DATASETS:
        datasets.append(YOUTUBEVOS_Train(
            root=cfg.DIR_YTB, transform=transform, seq_len=cfg.DATA_SEQ_LEN,
            rand_gap=cfg.DATA_RANDOM_GAP_YTB,
            rand_reverse=cfg.DATA_RANDOM_REVERSE_SEQ,
            merge_prob=cfg.DATA_DYNAMIC_MERGE_PROB,
            max_obj_n=cfg.MODEL_MAX_OBJ_NUM,
            enable_prev_frame=enable_prev))
    if "test" in cfg.DATASETS:
        datasets.append(TEST(seq_len=cfg.DATA_SEQ_LEN,
                             transform=VA.build_train_transform(cfg)))
    if not datasets:
        raise ValueError(f"no datasets resolved from {cfg.DATASETS}")
    return datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
