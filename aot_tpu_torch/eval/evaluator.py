"""Evaluator: fully-online frame-by-frame multi-object VOS inference (port
of aot_tpu/eval/evaluator.py:38-559; reference:
networks/managers/evaluator.py).

Per video and TTA variant (scale x flip) an independent EngineState runs;
per frame:
  propagate -> decode logits at the ORIGINAL resolution -> (unflip) ->
  softmax; TTA-mean -> argmax = prediction; ground truth arriving mid-video
  overwrites the prediction and re-references every variant
  (evaluator.py:363-399); otherwise each variant's own label (nearest-
  downsampled to its input size), or with MODEL_USE_PREV_PROB its soft
  probabilities, is written into memory. The LT ring grows just in time
  from a host mirror of its write schedule (`LTShadow`). Mask PNGs are
  written by background threads.

Plain eager PyTorch under torch.inference_mode() on an explicit device
(cuda:0 unless the caller asks for another). A frame's time runs from the
upload of its first variant to the end of the copy of its uint8 mask to
the host, which waits for the device. The chunked, batched and bf16
serving variants (TEST_FRAME_CHUNK > 1, TEST_VIDEO_BATCH > 1, TEST_DTYPE
bfloat16) rest on engine modes the port does not have yet and raise
(`check_supported`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aot_tpu_torch.data.eval_datasets import build_eval_dataset
from aot_tpu_torch.data.video_aug import multi_restrict_size
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.ops.image import (flip_horizontal, interpolate_bilinear,
                                     interpolate_nearest)
from aot_tpu_torch.utils.device import resolve_device
from aot_tpu_torch.utils.eval_pack import zip_folder
from aot_tpu_torch.utils.image import save_mask_async

_NOT_PORTED = ("rests on a serving variant the port does not have yet "
               "(ROADMAP.md, Queue 1 item 7: step_chunk, step_videos and "
               "bf16 serving)")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the knobs whose engine modes are not
    ported: chunked stepping, batched multi-video serving, bf16."""
    if int(cfg.get("TEST_FRAME_CHUNK", 1)) > 1:
        raise NotImplementedError(
            f"TEST_FRAME_CHUNK={cfg.TEST_FRAME_CHUNK} (--frame_chunk) "
            f"{_NOT_PORTED}")
    if int(cfg.get("TEST_VIDEO_BATCH", 1)) > 1:
        raise NotImplementedError(
            f"TEST_VIDEO_BATCH={cfg.TEST_VIDEO_BATCH} (--video_batch) "
            f"{_NOT_PORTED}")
    if str(cfg.get("TEST_DTYPE", "float32")) != "float32":
        raise NotImplementedError(
            f"TEST_DTYPE={cfg.TEST_DTYPE!r} (--amp) {_NOT_PORTED}")


class Evaluator:
    """Single-process evaluator driving one device; sequences are strided
    over processes by (rank, world), as the JAX package does."""

    def __init__(self, cfg, model, rank: int = 0, world: int = 1,
                 result_root: Optional[str] = None, device=None,
                 cudnn_benchmark: bool = True):
        check_supported(cfg)
        self.cfg = cfg
        # torch.backends.cudnn.benchmark for the length of evaluate(): cuDNN
        # times its convolution algorithms at each new input size (the
        # first frame of a size pays for it) instead of taking its default
        # choice, which is several times slower on a full-resolution frame
        # (PERF.md, "Where the time goes")
        self.cudnn_benchmark = cudnn_benchmark
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.rank = rank
        self.world = world
        self.engine = build_infer_engine(self.model, cfg)
        self.result_root = result_root

    # --- the per-frame pieces (the JAX package's jitted closures) --------
    def _upload(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image[None])).to(
            self.device)

    def _label(self, label_orig: torch.Tensor,
               input_size: Tuple[int, int]) -> torch.Tensor:
        """(1, H, W) label at the original size -> (1, h, w) int64 at the
        variant's input size (nearest)."""
        lab = interpolate_nearest(label_orig[..., None].float(), input_size)
        return lab[..., 0].long()

    def _prop_decode(self, state, img: torch.Tensor,
                     orig_size: Tuple[int, int], flip: bool):
        eng = self.engine
        state = eng.propagate(state, img)
        logits = eng.decode_logits(state, output_size=None)
        logits = interpolate_bilinear(logits, orig_size,
                                      align_corners=eng.engine.align_corners)
        if flip:
            logits = flip_horizontal(logits)
        return state, torch.softmax(logits.float(), dim=-1)

    def _update_prob(self, state, prob_orig: torch.Tensor,
                     input_size: Tuple[int, int]):
        """MODEL_USE_PREV_PROB: write soft probabilities instead of hard
        labels into memory (reference: evaluator.py:428-446). prob_orig:
        (1, H, W, 1 + G*M) aggregated; regrouped per engine group."""
        max_obj = self.engine.max_obj_num
        fg = interpolate_nearest(prob_orig, input_size)[..., 1:]
        groups = []
        for gi in range(state.batch):
            sl = fg[..., gi * max_obj:(gi + 1) * max_obj]
            bg = 1.0 - sl.sum(dim=-1, keepdim=True)
            groups.append(torch.cat([bg, sl], dim=-1))
        return self.engine.engine.update_memory(
            state, prob=torch.cat(groups, dim=0))

    # --- per-video loop ---------------------------------------------------
    @torch.inference_mode()
    def eval_sequence(self, seq) -> Dict:
        cfg = self.cfg
        eng = self.engine
        scales = list(cfg.TEST_MULTISCALE)
        use_flip = cfg.TEST_FLIP

        states: List = [None] * (len(scales) * (2 if use_flip else 1))
        flips: List[bool] = []
        input_sizes: List[Tuple[int, int]] = []
        pending_writes = []
        obj_num = 0
        frame_times = []
        result_dir = os.path.join(self.result_root or ".", seq.seq_name)
        os.makedirs(result_dir, exist_ok=True)
        # host mirror of the LT write schedule: grows the ring just in time,
        # giving the reference's unbounded memory (aot_engine.py:291-305)
        shadow = eng.make_shadow()

        def emit_mask(mask_np: np.ndarray, meta: Dict):
            fname = os.path.splitext(meta["current_name"])[0] + ".png"
            squeeze_idx = meta.get("obj_idx")
            squeeze = list(squeeze_idx) if squeeze_idx else None
            pending_writes.append(save_mask_async(
                mask_np, os.path.join(result_dir, fname), squeeze))
            # dense (all-frames) eval also exports the sparse 6fps subset
            # for the submission server (reference: evaluator.py:457-477)
            images_sparse = getattr(seq, "images_sparse", None)
            if images_sparse and meta["current_name"] in images_sparse:
                sparse_dir = (self.result_root or ".").rstrip("/") + "_sparse"
                os.makedirs(os.path.join(sparse_dir, seq.seq_name),
                            exist_ok=True)
                pending_writes.append(save_mask_async(
                    mask_np, os.path.join(sparse_dir, seq.seq_name, fname),
                    squeeze))

        for frame_idx in range(len(seq)):
            sample = seq[frame_idx]
            label = sample["label"]
            meta = sample["meta"]
            orig_size = (meta["height"], meta["width"])
            variants = multi_restrict_size(
                sample["image"], label, multi_scale=scales, flip=use_flip,
                max_short_edge=cfg.TEST_MAX_SHORT_EDGE,
                max_long_edge=cfg.TEST_MAX_LONG_EDGE,
                align_corners=cfg.MODEL_ALIGN_CORNERS)

            if frame_idx == 0:
                obj_num = int(meta["obj_num"])
                flips = [v["flip"] for v in variants]
                input_sizes = [tuple(v["image"].shape[:2]) for v in variants]
                lab = torch.from_numpy(label[None].astype(np.int64)).to(
                    self.device)
                for vi, v in enumerate(variants):
                    vlab = flip_horizontal(lab) if v["flip"] else lab
                    states[vi] = eng.add_reference_frame(
                        self._upload(v["image"]),
                        self._label(vlab, input_sizes[vi]), obj_num)
                shadow.add_ref(0)
                continue

            t0 = time.perf_counter()
            imgs, probs = [], []
            for vi, v in enumerate(variants):
                imgs.append(self._upload(v["image"]))
                states[vi], prob = self._prop_decode(
                    states[vi], imgs[vi], orig_size, flips[vi])
                probs.append(prob)

            mean_prob = probs[0] if len(probs) == 1 else (
                sum(probs) / len(probs))
            pred_label = mean_prob.argmax(dim=-1)
            per_variant_labels = (
                [pred_label] if len(probs) == 1 else
                [p.argmax(dim=-1) for p in probs])

            needed = shadow.count + 1
            if label is not None:      # GT arriving mid-video (unflipped)
                gt = torch.from_numpy(label[None].astype(np.int64)).to(
                    self.device)
                keep = gt == 0
                pred_label = torch.where(keep, pred_label, gt)
                per_variant_labels = [torch.where(keep, lab, gt)
                                      for lab in per_variant_labels]
                obj_num = int(pred_label.max())
                for vi in range(len(variants)):
                    lab_v = per_variant_labels[
                        min(vi, len(per_variant_labels) - 1)]
                    if flips[vi]:
                        lab_v = flip_horizontal(lab_v)
                    lab_v = self._label(lab_v, input_sizes[vi])
                    st = eng.ensure_lt_capacity(states[vi], needed)
                    st = eng.add_reference_frame(imgs[vi], lab_v, obj_num,
                                                 state=st,
                                                 frame_step=frame_idx)
                    # the reference also refreshes short-term memory with
                    # the merged label right after re-referencing
                    # (evaluator.py:397-399)
                    states[vi] = eng.update_memory(st, lab_v)
                shadow.add_ref(frame_idx)
                shadow.update(frame_idx)
            else:
                for vi in range(len(variants)):
                    if shadow.will_write(frame_idx):
                        states[vi] = eng.ensure_lt_capacity(states[vi],
                                                            needed)
                    if cfg.MODEL_USE_PREV_PROB:
                        p = probs[min(vi, len(probs) - 1)]
                        if flips[vi]:
                            p = flip_horizontal(p)
                        states[vi] = self._update_prob(states[vi], p,
                                                       input_sizes[vi])
                    else:
                        lab_v = per_variant_labels[
                            min(vi, len(per_variant_labels) - 1)]
                        if flips[vi]:
                            lab_v = flip_horizontal(lab_v)
                        states[vi] = eng.update_memory(
                            states[vi], self._label(lab_v, input_sizes[vi]))
                shadow.update(frame_idx)

            # the copy to the host waits for the device: the frame's end
            mask_np = pred_label.to(torch.uint8).cpu().numpy()[0]
            frame_times.append(time.perf_counter() - t0)
            emit_mask(mask_np, meta)

        for t in pending_writes:
            t.join()
        total = sum(frame_times) if frame_times else 1e-9
        return {
            "seq_name": seq.seq_name,
            "frames": len(seq),
            "timed_frames": len(frame_times),
            "time": total,
            "fps": len(frame_times) / total,
            "frame_times": frame_times,
            "input_sizes": input_sizes,
        }

    def evaluate(self) -> Dict:
        prev = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = self.cudnn_benchmark
        try:
            return self._evaluate()
        finally:
            torch.backends.cudnn.benchmark = prev

    def _evaluate(self) -> Dict:
        cfg = self.cfg
        dataset = build_eval_dataset(cfg, result_root=self.result_root)
        stats = []
        t_start = time.time()
        for i in range(len(dataset)):
            if i % self.world != self.rank:
                continue
            s = self.eval_sequence(dataset[i])
            stats.append(s)
            print(f"[eval rank {self.rank}] {s['seq_name']}: "
                  f"{s['timed_frames']} frames, {s['fps']:.1f} FPS",
                  flush=True)
        total_time = sum(s["time"] for s in stats) or 1e-9
        total_frames = sum(s["timed_frames"] for s in stats)
        summary = {
            "sequences": len(stats),
            "total_frames": total_frames,
            "fps": total_frames / total_time,
            "wall_time": time.time() - t_start,
        }
        print(f"[eval rank {self.rank}] done: {summary}", flush=True)
        summary["per_sequence"] = stats
        return summary

    def package_submission(self, zip_path: str) -> None:
        """Zip Annotations for the benchmark server
        (reference: evaluator.py:538-542)."""
        zip_folder(self.result_root, zip_path)
