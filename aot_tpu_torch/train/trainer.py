"""Trainer: the training loop (port of aot_tpu/train/trainer.py:34-247;
reference: networks/managers/trainer.py).

Covers model, engine, optimizer and EMA construction, auto-resume and
pretrained weights, the sequential-training curriculum (`use_prev_pred` from
TRAIN_SEQ_TRAINING_START_RATIO on), logging (the log line, the
`metrics.jsonl` stream and TensorBoard, the prediction image log), and the
raw and EMA checkpoint streams with their backup directory. Trains both
MODEL_VOS families (AOT and DeAOT) in the config's TRAIN_DTYPE (bfloat16 by
default, or float32): the forward in that dtype, the parameters, their
gradients, Adam's moments and the EMA in fp32; with MODEL_FREEZE_BN=False
the encoder's BNs train with global-batch moments.

Data parallel: a Trainer made inside a live process group of W ranks
(parallel.launch, as `python -m aot_tpu_torch.train --gpu_num W` starts
them) trains 1/W of TRAIN_BATCH_SIZE on its rank's device, and the step
averages the gradients (train/step.py). Each rank loads its own shard of
every global batch (TrainLoader's shard of the shared epoch permutation,
as the reference's DistributedSampler gives it; augmentation seeded by
(seed, rank)); only rank 0 prints, logs and writes checkpoints. Without a
group it trains on one device; MESH_DP_SIZE above 1 then raises. It runs
on cuda:0 unless given another device, and raises when there is no card.
The batches come from the port's copy of the JAX package's loader
(aot_tpu_torch.data.loader.TrainLoader).
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from aot_tpu_torch import parallel
from aot_tpu_torch.data.loader import TrainLoader
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.train.step import create_train_state, make_train_step
from aot_tpu_torch.utils import checkpoint as ckpt_lib
from aot_tpu_torch.utils.device import resolve_device
from aot_tpu_torch.utils.logging import MetricsLogger, save_pred_image_log
from aot_tpu_torch.utils.meters import AverageMeter

StepHook = Callable[[int, Dict[str, torch.Tensor]], None]


class RankLoader(TrainLoader):
    """Rank `rank`'s TrainLoader: its `batch` clips of every global batch
    of the epoch permutation seeded by `seed` (the same on every rank), its
    augmentation seeded by (seed, rank): the workers' generators, or this
    process's when it loads in place. Rank 0 of one is TrainLoader(dataset,
    batch, workers, seed) as it is."""

    def __init__(self, dataset, batch: int, workers: int, seed: int,
                 rank: int, world: int):
        aug_seed = seed + 1000 * rank
        # TrainLoader seeds its workers with its seed: the rank's
        super().__init__(dataset, batch, num_workers=workers, seed=aug_seed,
                         shard_id=rank, num_shards=world)
        self.seed = seed        # the epoch permutation's, every rank's
        if workers == 0 and world > 1:
            random.seed(aug_seed)
            np.random.seed(aug_seed)


class Trainer:
    def __init__(self, cfg, seed: int = 0, device=None):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.rank, self.world = parallel.rank(), parallel.world_size()
        want = int(cfg.MESH_DP_SIZE)
        if want > 0 and want != self.world:
            raise ValueError(
                f"MESH_DP_SIZE={want} but {self.world} rank(s) are live: "
                "start the ranks with aot_tpu_torch.parallel.launch "
                f"(python -m aot_tpu_torch.train --gpu_num {want})")
        self.batch = parallel.local_batch(cfg.TRAIN_BATCH_SIZE, self.world)
        # every rank draws the same weights from the seed
        model = build_vos_model(cfg, device=self.device, train=True,
                                generator=torch.Generator().manual_seed(seed))
        self.engine = build_train_engine(model, cfg)
        self.state = create_train_state(cfg, model)
        self.train_step = make_train_step(cfg, self.engine)
        n = sum(p.numel() for p in model.parameters())
        self.print_log(f"{cfg.MODEL_NAME} on {self.device}, "
                       f"{cfg.TRAIN_DTYPE}, ranks: {self.world}, global "
                       f"batch: {cfg.TRAIN_BATCH_SIZE}, params: "
                       f"{n / 1e6:.2f}M")
        self.start_step = 0
        self.process_pretrained_model()

    @property
    def model(self):
        return self.state.model

    def print_log(self, msg: str) -> None:
        if self.rank == 0:
            print(f"[trainer] {msg}", flush=True)

    def process_pretrained_model(self) -> None:
        """Auto-resume > resume > pretrained weights
        (aot_tpu/train/trainer.py:80); every rank reads the same file."""
        cfg = self.cfg
        if cfg.TRAIN_AUTO_RESUME:
            latest = ckpt_lib.latest_checkpoint(cfg.DIR_CKPT)
            if latest is not None:
                self._resume(latest)
                self.print_log(f"auto-resumed {latest} @ {self.start_step}")
                return
        if cfg.TRAIN_RESUME and cfg.TRAIN_RESUME_CKPT:
            self._resume(cfg.TRAIN_RESUME_CKPT)
            return
        if cfg.PRETRAIN and cfg.PRETRAIN_MODEL:
            self._load_pretrained(str(cfg.PRETRAIN_MODEL))

    def _resume(self, path: str) -> None:
        self.state.load_state_dict(ckpt_lib.load_checkpoint(path, self.device))
        self.start_step = self.state.step

    def _load_pretrained(self, path: str) -> None:
        """A reference-keyed .pth (a state dict, or {'state_dict': ...}),
        or the newest checkpoint of a directory; the whole model with
        PRETRAIN_FULL, else the encoder."""
        cfg = self.cfg
        if os.path.isdir(path):
            resolved = ckpt_lib.latest_checkpoint(path)
            if resolved is None:
                raise FileNotFoundError(
                    f"PRETRAIN_MODEL directory {path} has no checkpoints")
            path = resolved
        elif not os.path.exists(path):
            if cfg.PRETRAIN_FULL:
                raise FileNotFoundError(f"PRETRAIN_MODEL {path} does not exist")
            self.print_log(f"encoder pretrain {path} not found — random init")
            return
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"PRETRAIN_MODEL {path}: aot_tpu_torch loads .pth state dicts")
        blob = ckpt_lib.load_checkpoint(path, self.device)
        sd = blob.get("state_dict", blob.get("model", blob))
        if not cfg.PRETRAIN_FULL:   # torchvision files lack the prefix
            sd = {k if k.startswith("encoder.") else f"encoder.{k}": v
                  for k, v in sd.items()}
            sd = {k: v for k, v in sd.items() if k.startswith("encoder.")}
        missing, _ = self.model.load_state_dict(sd, strict=False)
        if self.state.ema is not None:
            self.state.ema.load_shadow(dict(self.model.named_parameters()), 0)
        self.print_log(f"loaded pretrain {path} ({len(missing)} keys missing)")

    def _upload(self, batch):
        """A host batch onto the device: through pinned memory and
        non_blocking on a card, so the copy overlaps the step in flight."""
        card = self.device.type == "cuda"
        out = []
        for key in ("frames", "labels", "obj_nums"):
            t = torch.from_numpy(batch[key])
            if card:
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=card))
        return out

    def sequential_training(self, max_steps: Optional[int] = None,
                            dataset=None,
                            on_step: Optional[StepHook] = None) -> None:
        """Train to TRAIN_TOTAL_STEPS (or max_steps) (reference:
        trainer.py:356-593; aot_tpu/train/trainer.py:127-222). `dataset`:
        the clip source, by default
        aot_tpu_torch.data.train_datasets.build_train_dataset(cfg).
        `on_step`, if given, is called after every step with (step,
        stats)."""
        cfg = self.cfg
        total = cfg.TRAIN_TOTAL_STEPS if max_steps is None else max_steps
        seq_start = int(cfg.TRAIN_SEQ_TRAINING_START_RATIO
                        * cfg.TRAIN_TOTAL_STEPS)
        if dataset is None:
            from aot_tpu_torch.data.train_datasets import build_train_dataset

            dataset = build_train_dataset(cfg)
        loader = RankLoader(dataset, self.batch, cfg.DATA_WORKERS,
                            self.seed, self.rank, self.world)
        generator = torch.Generator().manual_seed(self.seed + 1)
        lead = self.rank == 0
        metrics = MetricsLogger(cfg.DIR_LOG, tb=cfg.TRAIN_TBLOG) if lead \
            else None
        loss_meter, iou_meter = AverageMeter(), AverageMeter()
        step = self.start_step
        t_last = time.perf_counter()
        batches = iter(loader)
        try:
            host = next(batches)
            dev = self._upload(host)
            while step < total:
                frames, labels, obj_nums = dev
                cur = host
                stats = self.train_step(self.state, frames, labels, obj_nums,
                                        generator, step >= seq_start)
                step += 1
                if step < total:
                    host = next(batches)
                    dev = self._upload(host)    # overlaps the step in flight
                if on_step is not None:
                    on_step(step, stats)
                if (lead and cfg.TRAIN_IMG_LOG
                        and step % cfg.TRAIN_TBLOG_STEP == 0):
                    # (image | gt | pred) of sample 0's last frame
                    # (reference: trainer.py:599-686)
                    save_pred_image_log(
                        cfg.DIR_IMG_LOG, step, cur["frames"][-1][0],
                        cur["labels"][-1][0],
                        stats["last_pred"][0].cpu().numpy())
                if step % cfg.TRAIN_LOG_STEP == 0 or step == total:
                    t_last = self._log(step, total, stats, t_last, metrics,
                                       loss_meter, iou_meter)
                if step % cfg.TRAIN_SAVE_STEP == 0 or step == total:
                    self.save_checkpoints(step)
        finally:
            loader.close()
            if metrics is not None:
                metrics.close()

    def _log(self, step: int, total: int, stats, t_last: float, metrics,
             loss_meter: AverageMeter, iou_meter: AverageMeter) -> float:
        """The log line and the metrics stream (aot_tpu/train/trainer.py:
        199-218), on rank 0. Returns the new interval start."""
        cfg = self.cfg
        if metrics is None:
            return time.perf_counter()
        s = {k: float(stats[k]) for k in
             ("loss", "aux_loss", "pred_loss", "iou", "grad_norm")}
        loss_meter.update(s["loss"])
        iou_meter.update(s["iou"])
        dt = (time.perf_counter() - t_last) / cfg.TRAIN_LOG_STEP
        eta_h = dt * (total - step) / 3600
        self.print_log(
            f"step {step}/{total} loss {s['loss']:.4f} "
            f"(avg {loss_meter.moving_avg:.4f}) iou {s['iou']:.4f} grad "
            f"{s['grad_norm']:.2f} {dt:.2f}s/it eta {eta_h:.2f}h")
        metrics.log(step, dict(s, sec_per_it=dt))
        return time.perf_counter()

    def save_checkpoints(self, step: int) -> None:
        """Raw + EMA streams, on rank 0 (reference: trainer.py:553-591);
        a failed write goes to ./backup/{EXP_NAME}/{STAGE_NAME}/."""
        if self.rank != 0:
            return
        cfg = self.cfg
        backup = os.path.join("./backup", cfg.EXP_NAME, cfg.STAGE_NAME)
        ckpt_lib.save_checkpoint(cfg.DIR_CKPT, step, self.state.state_dict(),
                                 max_keep=cfg.TRAIN_MAX_KEEP_CKPT,
                                 backup_dir=os.path.join(backup, "ckpt"))
        if self.state.ema is not None:
            ckpt_lib.save_checkpoint(
                cfg.DIR_EMA_CKPT, step,
                {"state_dict": self.state.ema.state_dict(self.model)},
                max_keep=cfg.TRAIN_MAX_KEEP_CKPT,
                backup_dir=os.path.join(backup, "ema_ckpt"))
        self.print_log(f"saved checkpoints @ {step}")


def train_rank(device: torch.device, cfg, seed: int = 0,
               max_steps: Optional[int] = None, dataset=None) -> None:
    """One rank of a data-parallel run (parallel.launch's fn): a Trainer on
    `device` trained to TRAIN_TOTAL_STEPS (or max_steps)."""
    Trainer(cfg, seed=seed, device=device).sequential_training(
        max_steps, dataset=dataset)
