"""Built-in DAVIS-style J&F evaluation.

The reference relies on the external DAVIS toolkit / CodaLab servers for
scoring (SURVEY §4.4); this module implements the official semi-supervised
protocol locally (davis2017-evaluation semantics):

  J (region similarity): per-object IoU per frame.
  F (boundary accuracy): precision/recall of mask boundaries matched within
    a distance of bound_th * image diagonal (morphological dilation), with
    F = 2PR / (P + R).
  Per-sequence scores average frames 1..N-2 (first frame is given, last is
  excluded, matching the official evaluator).

Host-side numpy/cv2 — runs on prediction PNGs against ground-truth dirs.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import cv2
import numpy as np

cv2.setNumThreads(0)


def binary_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return float(inter) / float(union)


def _seg_boundary(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (pixels whose 4-neighbourhood leaves
    the mask — equivalent to the official seg2bmap up to the border pixel
    convention)."""
    m = mask.astype(np.uint8)
    if m.sum() == 0:
        return np.zeros_like(m, bool)
    er = cv2.erode(m, np.ones((3, 3), np.uint8), iterations=1)
    return (m - er).astype(bool)


def boundary_f_measure(pred: np.ndarray, gt: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """(official db_eval_boundary semantics)."""
    h, w = gt.shape
    bound_pix = max(1, int(math.ceil(bound_th * math.sqrt(h * h + w * w))))
    fg_b = _seg_boundary(pred)
    gt_b = _seg_boundary(gt)
    if fg_b.sum() == 0 and gt_b.sum() == 0:
        return 1.0
    if fg_b.sum() == 0 or gt_b.sum() == 0:
        return 0.0
    kernel = cv2.getStructuringElement(
        cv2.MORPH_ELLIPSE, (2 * bound_pix + 1, 2 * bound_pix + 1))
    fg_dil = cv2.dilate(fg_b.astype(np.uint8), kernel).astype(bool)
    gt_dil = cv2.dilate(gt_b.astype(np.uint8), kernel).astype(bool)
    precision = np.logical_and(fg_b, gt_dil).sum() / fg_b.sum()
    recall = np.logical_and(gt_b, fg_dil).sum() / gt_b.sum()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_sequence(
    pred_masks: List[np.ndarray],
    gt_masks: List[np.ndarray],
    object_ids: Optional[List[int]] = None,
) -> Dict[str, float]:
    """Frame lists of integer label maps -> per-sequence J/F means over
    frames [1, N-2] and all objects."""
    assert len(pred_masks) == len(gt_masks)
    if object_ids is None:
        ids = set()
        for g in gt_masks:
            ids |= set(np.unique(g).tolist())
        object_ids = sorted(i for i in ids if i != 0)
    j_scores, f_scores = [], []
    lo, hi = 1, len(gt_masks) - 1  # official: skip first and last frames
    for obj in object_ids:
        js, fs = [], []
        for t in range(lo, hi):
            p = pred_masks[t] == obj
            g = gt_masks[t] == obj
            js.append(binary_iou(p, g))
            fs.append(boundary_f_measure(p, g))
        if js:
            j_scores.append(float(np.mean(js)))
            f_scores.append(float(np.mean(fs)))
    j = float(np.mean(j_scores)) if j_scores else 1.0
    f = float(np.mean(f_scores)) if f_scores else 1.0
    return {"J": j, "F": f, "J&F": (j + f) / 2,
            "n_objects": len(object_ids)}


def evaluate_davis(results_root: str, gt_root: str,
                   seq_names: Optional[List[str]] = None,
                   verbose: bool = True) -> Dict[str, float]:
    """Score a results directory (per-sequence PNG dirs) against a DAVIS
    Annotations directory. Returns the global mean J / F / J&F."""
    from PIL import Image

    seqs = seq_names or sorted(
        d for d in os.listdir(gt_root)
        if os.path.isdir(os.path.join(gt_root, d)))
    per_seq = {}
    for seq in seqs:
        gt_files = sorted(f for f in os.listdir(os.path.join(gt_root, seq))
                          if f.endswith(".png"))
        preds, gts = [], []
        for f in gt_files:
            gts.append(np.array(Image.open(os.path.join(gt_root, seq, f))))
            pf = os.path.join(results_root, seq, f)
            if os.path.exists(pf):
                preds.append(np.array(Image.open(pf)))
            else:
                preds.append(np.zeros_like(gts[-1]))
        per_seq[seq] = evaluate_sequence(preds, gts)
        if verbose:
            s = per_seq[seq]
            print(f"  {seq}: J {s['J']:.4f} F {s['F']:.4f} "
                  f"J&F {s['J&F']:.4f}")
    j = float(np.mean([s["J"] for s in per_seq.values()]))
    f = float(np.mean([s["F"] for s in per_seq.values()]))
    out = {"J": j, "F": f, "J&F": (j + f) / 2, "sequences": len(per_seq)}
    if verbose:
        print(f"global: J {j:.4f} F {f:.4f} J&F {out['J&F']:.4f}")
    return out
