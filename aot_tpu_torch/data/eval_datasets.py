"""Evaluation datasets (reference: dataloaders/eval_datasets.py).

Per-sequence iterables producing raw frames + sparse ground-truth labels,
with the object-arrival bookkeeping the online engine needs (obj_nums /
obj_indices per frame, sparse-id squeezing for YouTube-VOS).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import cv2
import numpy as np
from PIL import Image

cv2.setNumThreads(0)


class VOSTestSequence:
    """One video: iterate frames in order; frame dicts carry the image,
    optional label (at original resolution), and meta
    (reference: VOSTest, eval_datasets.py:14-118)."""

    def __init__(self, image_root, label_root, seq_name, images, labels,
                 rgb=True, single_obj=False, resolution=None):
        self.image_root = image_root
        self.label_root = label_root
        self.seq_name = seq_name
        self.images = list(images)
        self.labels = list(labels)
        self.rgb = rgb
        self.single_obj = single_obj
        self.resolution = resolution
        self.num_frames = len(self.images)

        # object arrival bookkeeping (eval_datasets.py:40-52)
        self.obj_nums: List[int] = []
        self.obj_indices: List[List[int]] = []
        curr_objs = [0]
        for img_name in self.images:
            self.obj_nums.append(len(curr_objs) - 1)
            lab_name = os.path.splitext(img_name)[0] + ".png"
            if lab_name in self.labels:
                lab = self.read_label(lab_name)
                for o in np.unique(lab):
                    if int(o) not in curr_objs:
                        curr_objs.append(int(o))
            self.obj_indices.append(curr_objs.copy())
        if len(self.obj_nums) > 1:
            self.obj_nums[0] = self.obj_nums[1]

    def __len__(self):
        return self.num_frames

    def read_image(self, idx) -> np.ndarray:
        path = os.path.join(self.image_root, self.seq_name, self.images[idx])
        img = cv2.imread(path).astype(np.float32)
        if self.rgb:
            img = img[:, :, ::-1].copy()
        return img

    def read_label(self, lab_name, squeeze_idx=None) -> np.ndarray:
        path = os.path.join(self.label_root, self.seq_name, lab_name)
        lab = np.array(Image.open(path), np.uint8)
        if self.single_obj:
            lab = (lab > 0).astype(np.uint8)
        elif squeeze_idx is not None:
            out = np.zeros_like(lab)
            for new_id, obj in enumerate(squeeze_idx):
                if obj == 0:
                    continue
                out[lab == obj] = new_id
            lab = out
        return lab

    def __getitem__(self, idx) -> Dict:
        img_name = self.images[idx]
        image = self.read_image(idx)
        h, w = image.shape[:2]
        if self.resolution is not None:
            w = int(np.ceil(w * self.resolution / h))
            h = int(self.resolution)
        lab_name = os.path.splitext(img_name)[0] + ".png"
        label = None
        if lab_name in self.labels:
            label = self.read_label(lab_name, self.obj_indices[idx])
        return {
            "image": image,
            "label": label,
            "meta": {
                "seq_name": self.seq_name,
                "frame_num": self.num_frames,
                "obj_num": self.obj_nums[idx],
                "current_name": img_name,
                "height": h,
                "width": w,
                "obj_idx": self.obj_indices[idx],
            },
        }


class YOUTUBEVOS_Test:
    """(reference: eval_datasets.py:121-187); copies the first annotation
    into the result dir per the submission protocol."""

    def __init__(self, root="./datasets/YTB", year=2018, split="val",
                 result_root=None, rgb=True):
        split = "valid" if split == "val" else split
        root = os.path.join(root, str(year), split)
        self.result_root = result_root
        self.rgb = rgb
        with open(os.path.join(root, "meta.json")) as f:
            self.ann = json.load(f)["videos"]
        self.seqs = list(self.ann.keys())
        self.image_root = os.path.join(root, "JPEGImages")
        self.label_root = os.path.join(root, "Annotations")

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx) -> VOSTestSequence:
        seq = self.seqs[idx]
        data = self.ann[seq]["objects"]
        images, labels = [], []
        for obj_n, d in data.items():
            images += [x + ".jpg" for x in d["frames"]]
            labels.append(d["frames"][0] + ".png")
        images = sorted(set(images))
        labels = sorted(set(labels))
        if self.result_root is not None:
            dst = os.path.join(self.result_root, seq)
            os.makedirs(dst, exist_ok=True)
            if not os.path.isfile(os.path.join(dst, labels[0])):
                shutil.copy(os.path.join(self.label_root, seq, labels[0]),
                            os.path.join(dst, labels[0]))
        return VOSTestSequence(self.image_root, self.label_root, seq,
                               images, labels, rgb=self.rgb)


class YOUTUBEVOS_DenseTest:
    """All-frames 30fps split windowed to the sparse annotated range
    (reference: eval_datasets.py:190-266)."""

    def __init__(self, root="./datasets/YTB", year=2018, split="val",
                 result_root=None, rgb=True):
        split = "valid" if split == "val" else split
        sparse = os.path.join(root, str(year), split)
        dense = sparse + "_all_frames"
        self.result_root = result_root
        self.rgb = rgb
        with open(os.path.join(sparse, "meta.json")) as f:
            self.ann = json.load(f)["videos"]
        self.seqs = list(self.ann.keys())
        self.image_root = os.path.join(dense, "JPEGImages")
        self.label_root = os.path.join(sparse, "Annotations")

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx) -> VOSTestSequence:
        seq = self.seqs[idx]
        data = self.ann[seq]["objects"]
        images_sparse, labels = [], []
        for obj_n, d in data.items():
            images_sparse += [x + ".jpg" for x in d["frames"]]
            labels.append(d["frames"][0] + ".png")
        images_sparse = sorted(set(images_sparse))
        labels = sorted(set(labels))
        # window all frames to [first, last] of the sparse range
        all_images = sorted(os.listdir(os.path.join(self.image_root, seq)))
        start, end = images_sparse[0], images_sparse[-1]
        images = [x for x in all_images if start <= x <= end]
        if self.result_root is not None:
            dst = os.path.join(self.result_root, seq)
            os.makedirs(dst, exist_ok=True)
            if not os.path.isfile(os.path.join(dst, labels[0])):
                shutil.copy(os.path.join(self.label_root, seq, labels[0]),
                            os.path.join(dst, labels[0]))
        seq_ds = VOSTestSequence(self.image_root, self.label_root, seq,
                                 images, labels, rgb=self.rgb)
        seq_ds.images_sparse = images_sparse
        return seq_ds


class DAVIS_Test:
    """(reference: eval_datasets.py:269-351): 2016 binarises to one object."""

    def __init__(self, root="./DAVIS", year=2017, split="val",
                 full_resolution=False, result_root=None, rgb=True):
        resolution = "Full-Resolution" if full_resolution else "480p"
        self.image_root = os.path.join(root, "JPEGImages", resolution)
        self.label_root = os.path.join(root, "Annotations", resolution)
        self.single_obj = (year == 2016)
        self.rgb = rgb
        self.result_root = result_root
        seq_names = []
        splits = [split] if isinstance(split, str) else split
        for spt in splits:
            spt = "val" if spt == "validation" else spt
            with open(os.path.join(root, "ImageSets", str(year),
                                   spt + ".txt")) as f:
                seq_names += [s.strip() for s in f.readlines() if s.strip()]
        self.seqs = seq_names

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx) -> VOSTestSequence:
        seq = self.seqs[idx]
        images = sorted(os.listdir(os.path.join(self.image_root, seq)))
        labels = [os.path.splitext(images[0])[0] + ".png"]
        if self.result_root is not None:
            os.makedirs(os.path.join(self.result_root, seq), exist_ok=True)
        return VOSTestSequence(self.image_root, self.label_root, seq,
                               images, labels, rgb=self.rgb,
                               single_obj=self.single_obj)


class DemoTest:
    """datasets/Demo layout: images/<seq>/*.jpg + masks/<seq>/<first>.png
    (reference: tools/demo.py:146-179)."""

    def __init__(self, root, seq_names=None, rgb=True):
        self.image_root = os.path.join(root, "images")
        self.label_root = os.path.join(root, "masks")
        self.seqs = seq_names or sorted(os.listdir(self.image_root))
        self.rgb = rgb

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx) -> VOSTestSequence:
        seq = self.seqs[idx]
        images = sorted(os.listdir(os.path.join(self.image_root, seq)))
        labels = sorted(os.listdir(os.path.join(self.label_root, seq)))
        return VOSTestSequence(self.image_root, self.label_root, seq,
                               images, labels, rgb=self.rgb)


class EvalTestFixture:
    """Synthetic eval smoke fixture: 3 fake 10-frame sequences of 400x400,
    2 objects (reference: _EVAL_TEST/EVAL_TEST, eval_datasets.py:354-411)."""

    def __init__(self, result_root=None, n_seqs=3, n_frames=10, size=400):
        self.seqs = [f"test{i}" for i in range(n_seqs)]
        self.n_frames = n_frames
        self.size = size
        self.result_root = result_root

    def __len__(self):
        return len(self.seqs)

    def __getitem__(self, idx):
        return _SyntheticSequence(self.seqs[idx], self.n_frames, self.size)


class _SyntheticSequence:
    def __init__(self, name, n_frames, size):
        self.seq_name = name
        self.num_frames = n_frames
        self.size = size
        self.obj_nums = [2] * n_frames
        self.obj_indices = [[0, 1, 2]] * n_frames
        self.images = [f"{i:05d}.jpg" for i in range(n_frames)]
        self.labels = ["00000.png"]

    def __len__(self):
        return self.num_frames

    def __getitem__(self, idx):
        s = self.size
        image = np.zeros((s, s, 3), np.float32)
        label = None
        if idx == 0:
            label = np.zeros((s, s), np.uint8)
            label[50:150, 50:150] = 1
            label[200:300, 200:300] = 2
        return {
            "image": image,
            "label": label,
            "meta": {
                "seq_name": self.seq_name,
                "frame_num": self.num_frames,
                "obj_num": 2,
                "current_name": self.images[idx],
                "height": s,
                "width": s,
                "obj_idx": [0, 1, 2],
            },
        }


def build_eval_dataset(cfg, result_root=None):
    """(reference: evaluator.py:100-203 dataset dispatch)."""
    name = cfg.TEST_DATASET
    split = cfg.TEST_DATASET_SPLIT
    if name == "youtubevos":
        return YOUTUBEVOS_Test(cfg.DIR_YTB, 2018, split, result_root)
    if name == "youtubevos2019":
        return YOUTUBEVOS_Test(cfg.DIR_YTB, 2019, split, result_root)
    if name in ("youtubevos_dense", "youtubevos_all"):
        return YOUTUBEVOS_DenseTest(cfg.DIR_YTB, 2018, split, result_root)
    if name == "davis2017":
        return DAVIS_Test(cfg.DIR_DAVIS, 2017, split,
                          cfg.TEST_DATASET_FULL_RESOLUTION, result_root)
    if name == "davis2016":
        return DAVIS_Test(cfg.DIR_DAVIS, 2016, split,
                          cfg.TEST_DATASET_FULL_RESOLUTION, result_root)
    if name == "demo":
        return DemoTest(os.path.join(cfg.DIR_DATA, "Demo"))
    if name == "test":
        return EvalTestFixture(result_root)
    raise NotImplementedError(name)
