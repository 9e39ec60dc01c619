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

Two serving modes sit on the engine's batched and chunked steps, for
single-variant hard-label evaluation (no TTA, no MODEL_USE_PREV_PROB):
  - TEST_VIDEO_BATCH > 1: videos of one original size, all objects given
    at frame 0 and at most max_obj_num of them, are bucketed and advanced
    N at a time (`eval_sequences_batched`, VOSInferEngine.step_videos);
    ragged videos replay their last frame and that output is dropped;
  - TEST_FRAME_CHUNK > 1: runs of label-free frames go through
    VOSInferEngine.step_chunk in power-of-two chunks of at most that many
    frames (an annotated frame ends a run), the masks fed back on the
    device and read back once a chunk, packed two to a byte when there are
    at most 15 ids.
TEST_DTYPE (float32 or bfloat16) is the model's compute dtype
(models/aot.py build_vos_model).

Plain eager PyTorch under torch.inference_mode() on an explicit device
(cuda:0 unless the caller asks for another). A frame's time runs from the
upload of its first variant to the end of the copy of its uint8 mask to
the host, which waits for the device; a chunk's or a batched step's time
is shared by its frames.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aot_tpu_torch.data.eval_datasets import build_eval_dataset
from aot_tpu_torch.data.video_aug import multi_restrict_size
from aot_tpu_torch.engine import build_infer_engine
from aot_tpu_torch.ops.image import (flip_horizontal, interpolate_bilinear,
                                     interpolate_nearest, nearest_labels,
                                     pack_labels_4bit, unpack_labels_4bit_np)
from aot_tpu_torch.utils.device import resolve_device
from aot_tpu_torch.utils.eval_pack import zip_folder
from aot_tpu_torch.utils.image import save_mask_async


class Evaluator:
    """Single-process evaluator driving one device; sequences are strided
    over processes by (rank, world), as the JAX package does."""

    def __init__(self, cfg, model, rank: int = 0, world: int = 1,
                 result_root: Optional[str] = None, device=None,
                 cudnn_benchmark: bool = True):
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

    def _emit_mask(self, seq, result_dir: str, pending_writes: List,
                   mask_np: np.ndarray, meta: Dict) -> None:
        """Write a frame's uint8 mask PNG in the background."""
        fname = os.path.splitext(meta["current_name"])[0] + ".png"
        squeeze_idx = meta.get("obj_idx")
        squeeze = list(squeeze_idx) if squeeze_idx else None
        pending_writes.append(save_mask_async(
            mask_np, os.path.join(result_dir, fname), squeeze))
        # dense (all-frames) eval also exports the sparse 6fps subset for
        # the submission server (reference: evaluator.py:457-477)
        images_sparse = getattr(seq, "images_sparse", None)
        if images_sparse and meta["current_name"] in images_sparse:
            sparse_dir = (self.result_root or ".").rstrip("/") + "_sparse"
            os.makedirs(os.path.join(sparse_dir, seq.seq_name), exist_ok=True)
            pending_writes.append(save_mask_async(
                mask_np, os.path.join(sparse_dir, seq.seq_name, fname),
                squeeze))

    def _result_dir(self, seq) -> str:
        d = os.path.join(self.result_root or ".", seq.seq_name)
        os.makedirs(d, exist_ok=True)
        return d

    def _snap(self, image: np.ndarray) -> np.ndarray:
        """The single variant's input image (no TTA)."""
        cfg = self.cfg
        return multi_restrict_size(
            image, None, multi_scale=list(cfg.TEST_MULTISCALE), flip=False,
            max_short_edge=cfg.TEST_MAX_SHORT_EDGE,
            max_long_edge=cfg.TEST_MAX_LONG_EDGE,
            align_corners=cfg.MODEL_ALIGN_CORNERS)[0]["image"]

    def _single_variant(self) -> bool:
        """Hard-label evaluation of one variant: what the batched and the
        chunked modes serve (TTA and MODEL_USE_PREV_PROB bypass both)."""
        cfg = self.cfg
        return (len(cfg.TEST_MULTISCALE) == 1 and not cfg.TEST_FLIP
                and not cfg.MODEL_USE_PREV_PROB)

    # --- batched multi-video serving ----------------------------------------
    def _batchable(self, seq) -> bool:
        """Eligible for step_videos: a single variant, and every object
        annotated at frame 0 (a video re-referenced mid-stream takes the
        scalar path)."""
        labels = list(getattr(seq, "labels", ()))
        return (self._single_variant() and len(labels) == 1 and
                os.path.splitext(seq.images[0])[0] + ".png" in labels)

    @torch.inference_mode()
    def eval_sequences_batched(self, seqs) -> List[Dict]:
        """Advance N videos a frame per step (VOSInferEngine.step_videos).
        All share one original and input size (the caller buckets); ragged
        lengths replay the last frame of finished videos and drop those
        outputs. Per video the masks are the scalar path's
        (aot_tpu/eval/evaluator.py:173-280)."""
        eng = self.engine
        n = len(seqs)
        firsts = [seq[0] for seq in seqs]
        metas = [s["meta"] for s in firsts]
        orig_size = (metas[0]["height"], metas[0]["width"])
        last_imgs = [self._snap(s["image"]) for s in firsts]
        input_size = tuple(last_imgs[0].shape[:2])
        if any((m["height"], m["width"]) != orig_size for m in metas) or any(
                tuple(im.shape[:2]) != input_size for im in last_imgs):
            raise ValueError("eval_sequences_batched: the videos of a batch "
                             "share one original and one input size")
        result_dirs = [self._result_dir(seq) for seq in seqs]
        pending_writes: List = []

        labels0 = torch.from_numpy(np.stack(
            [s["label"] for s in firsts]).astype(np.int64)).to(self.device)
        state = eng.add_reference_frames_videos(
            torch.from_numpy(np.stack(last_imgs)).to(self.device),
            nearest_labels(labels0, input_size),
            [int(m["obj_num"]) for m in metas])
        shadow = eng.make_shadow()
        shadow.add_ref(0)

        lens = [len(seq) for seq in seqs]
        frame_times: List[List[float]] = [[] for _ in range(n)]
        for t in range(1, max(lens)):
            t0 = time.perf_counter()
            metas_t = {}
            for vi, seq in enumerate(seqs):
                if t < lens[vi]:
                    sample = seq[t]
                    last_imgs[vi] = self._snap(sample["image"])
                    metas_t[vi] = sample["meta"]
            if shadow.will_write(t):
                state = eng.ensure_lt_capacity(state, shadow.count + 1)
            state, preds, _ = eng.step_videos(
                state, torch.from_numpy(np.stack(last_imgs)).to(self.device),
                orig_size, input_size)
            shadow.update(t)
            # the copy to the host waits for the device: the step's end
            preds_np = preds.to(torch.uint8).cpu().numpy()     # (N, H, W)
            dt = time.perf_counter() - t0
            for vi, meta in metas_t.items():
                frame_times[vi].append(dt / len(metas_t))
                self._emit_mask(seqs[vi], result_dirs[vi], pending_writes,
                                preds_np[vi], meta)

        for th in pending_writes:
            th.join()
        stats = []
        for vi, seq in enumerate(seqs):
            total = sum(frame_times[vi]) or 1e-9
            stats.append({
                "seq_name": seq.seq_name,
                "frames": lens[vi],
                "timed_frames": len(frame_times[vi]),
                "time": total,
                "fps": len(frame_times[vi]) / total,
                "frame_times": frame_times[vi],
                "input_sizes": [input_size],
            })
        return stats

    # --- chunked stepping ---------------------------------------------------
    def _step_chunk(self, samples: List[Dict], start: int, state,
                    input_size, shadow, obj_num: int):
        """The label-free frames `samples` (from frame `start` on) in one
        step_chunk: one upload of k frames, one readback of k masks,
        packed two a byte when obj_num <= 15 (aot_tpu/eval/evaluator.py:
        326-384). Returns (state, masks (k, H, W) uint8)."""
        eng = self.engine
        k = len(samples)
        meta = samples[0]["meta"]
        orig_size = (meta["height"], meta["width"])
        imgs = torch.from_numpy(np.stack(
            [self._snap(s["image"])[None] for s in samples])).to(self.device)
        # grow the LT ring for every write of the chunk beforehand: the
        # write schedule is known on the host
        sh = copy.copy(shadow)
        for j in range(k):
            sh.update(start + j)
        state = eng.ensure_lt_capacity(state, sh.count)
        state, preds = eng.step_chunk(state, imgs, orig_size, input_size)
        if obj_num <= 15:
            masks = unpack_labels_4bit_np(
                pack_labels_4bit(preds).cpu().numpy(), orig_size[1])
        else:
            masks = preds.cpu().numpy()
        for j in range(k):
            shadow.update(start + j)
        return state, masks[:, 0]

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
        pending_writes: List = []
        obj_num = 0
        frame_times = []
        result_dir = self._result_dir(seq)
        # host mirror of the LT write schedule: grows the ring just in time,
        # giving the reference's unbounded memory (aot_engine.py:291-305)
        shadow = eng.make_shadow()

        def emit_mask(mask_np: np.ndarray, meta: Dict):
            self._emit_mask(seq, result_dir, pending_writes, mask_np, meta)

        # chunked stepping: runs of label-free frames, in power-of-two
        # chunks of at most TEST_FRAME_CHUNK frames
        chunk_max = int(cfg.get("TEST_FRAME_CHUNK", 1))
        chunkable = chunk_max > 1 and self._single_variant()
        labels = getattr(seq, "labels", ())

        def label_free(i: int) -> bool:
            return os.path.splitext(seq.images[i])[0] + ".png" not in labels

        frame_idx = -1
        while frame_idx + 1 < len(seq):
            frame_idx += 1
            if chunkable and frame_idx > 0:
                run = 0
                while (run < chunk_max and frame_idx + run < len(seq)
                       and label_free(frame_idx + run)):
                    run += 1
                k = 1 << (run.bit_length() - 1) if run else 0
                if k >= 2:
                    samples = [seq[frame_idx + j] for j in range(k)]
                    t0 = time.perf_counter()
                    states[0], masks = self._step_chunk(
                        samples, frame_idx, states[0], input_sizes[0],
                        shadow, obj_num)
                    frame_times.extend([(time.perf_counter() - t0) / k] * k)
                    for j, s in enumerate(samples):
                        emit_mask(masks[j], s["meta"])
                    frame_idx += k - 1
                    continue

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
                        nearest_labels(vlab, input_sizes[vi]), obj_num)
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
                    lab_v = nearest_labels(lab_v, input_sizes[vi])
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
                            states[vi], nearest_labels(lab_v, input_sizes[vi]))
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

    def _buckets(self, seqs) -> Tuple[List[List], List]:
        """TEST_VIDEO_BATCH > 1: batches of at most that many batchable
        videos of one original size (at most max_obj_num objects each),
        shortest first so a ragged tail wastes little; every other video
        (and a batch of one) goes to the scalar path
        (aot_tpu/eval/evaluator.py:511-538)."""
        vb = int(self.cfg.get("TEST_VIDEO_BATCH", 1))
        if vb <= 1:
            return [], list(seqs)
        by_size: Dict[Tuple[int, int], List] = {}
        scalar = []
        max_obj = self.engine.max_obj_num
        for seq in seqs:
            obj0 = (seq.obj_nums[0]
                    if getattr(seq, "obj_nums", None) else max_obj + 1)
            if not (self._batchable(seq) and obj0 <= max_obj):
                scalar.append(seq)
                continue
            m = seq[0]["meta"]
            by_size.setdefault((m["height"], m["width"]), []).append(seq)
        batches = []
        for group in by_size.values():
            group.sort(key=len)
            for i in range(0, len(group), vb):
                chunk = group[i:i + vb]
                if len(chunk) == 1:
                    scalar.extend(chunk)
                else:
                    batches.append(chunk)
        return batches, scalar

    def _evaluate(self) -> Dict:
        cfg = self.cfg
        dataset = build_eval_dataset(cfg, result_root=self.result_root)
        stats = []
        t_start = time.time()
        mine = [dataset[i] for i in range(len(dataset))
                if i % self.world == self.rank]
        batches, scalar = self._buckets(mine)
        for batch in batches:
            for s in self.eval_sequences_batched(batch):
                stats.append(s)
                print(f"[eval rank {self.rank}] {s['seq_name']}: "
                      f"{s['timed_frames']} frames, {s['fps']:.1f} FPS "
                      f"(batched x{len(batch)})", flush=True)
        for seq in scalar:
            s = self.eval_sequence(seq)
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
