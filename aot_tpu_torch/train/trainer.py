"""Trainer: the training loop on one device (port of
aot_tpu/train/trainer.py:34-247; reference: networks/managers/trainer.py).

Covers model, engine, optimizer and EMA construction, auto-resume and
pretrained weights, the sequential-training curriculum (`use_prev_pred` from
TRAIN_SEQ_TRAINING_START_RATIO on), logging, and the raw and EMA checkpoint
streams. Trains both MODEL_VOS families (AOT and DeAOT) in the config's
TRAIN_DTYPE (bfloat16 by default, or float32): the forward in that dtype,
the parameters, their gradients, Adam's moments and the EMA in fp32. One
device only: data parallelism over several is later work (ROADMAP.md,
Queue 1) and raises. It runs on cuda:0 unless given another device, and
raises when there is no card. The batches come from the port's copy of the
JAX package's loader (aot_tpu_torch.data.loader.TrainLoader).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch

from aot_tpu_torch.data.loader import TrainLoader
from aot_tpu_torch.engine.train import build_train_engine
from aot_tpu_torch.models import build_vos_model
from aot_tpu_torch.train.step import create_train_state, make_train_step
from aot_tpu_torch.utils import checkpoint as ckpt_lib
from aot_tpu_torch.utils.device import resolve_device

StepHook = Callable[[int, Dict[str, torch.Tensor]], None]


class Trainer:
    def __init__(self, cfg, seed: int = 0, device=None):
        if int(cfg.MESH_DP_SIZE) > 1:
            raise NotImplementedError(
                f"MESH_DP_SIZE={cfg.MESH_DP_SIZE}: aot_tpu_torch trains on "
                "one device; data parallelism is ROADMAP.md Queue 1")
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        model = build_vos_model(cfg, device=self.device, train=True,
                                generator=torch.Generator().manual_seed(seed))
        self.engine = build_train_engine(model, cfg)
        self.state = create_train_state(cfg, model)
        self.train_step = make_train_step(cfg, self.engine)
        n = sum(p.numel() for p in model.parameters())
        self.print_log(f"{cfg.MODEL_NAME} on {self.device}, "
                       f"{cfg.TRAIN_DTYPE}, batch: {cfg.TRAIN_BATCH_SIZE}, "
                       f"params: {n / 1e6:.2f}M")
        self.start_step = 0
        self.process_pretrained_model()

    @property
    def model(self):
        return self.state.model

    def print_log(self, msg: str) -> None:
        print(f"[trainer] {msg}", flush=True)

    def process_pretrained_model(self) -> None:
        """Auto-resume > resume > pretrained weights
        (aot_tpu/train/trainer.py:80)."""
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

    def sequential_training(self, max_steps: Optional[int] = None,
                            dataset=None,
                            on_step: Optional[StepHook] = None) -> None:
        """Train to TRAIN_TOTAL_STEPS (or max_steps) (reference:
        trainer.py:356-593). `dataset`: the clip source, by default
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
        loader = TrainLoader(dataset, cfg.TRAIN_BATCH_SIZE,
                             num_workers=cfg.DATA_WORKERS, seed=self.seed)
        generator = torch.Generator().manual_seed(self.seed + 1)
        dev = self.device
        step = self.start_step
        t_last = time.perf_counter()
        batches = iter(loader)
        try:
            while step < total:
                batch = next(batches)
                frames = torch.from_numpy(batch["frames"]).to(dev)
                labels = torch.from_numpy(batch["labels"]).to(dev)
                obj_nums = torch.from_numpy(batch["obj_nums"]).to(dev)
                stats = self.train_step(self.state, frames, labels, obj_nums,
                                        generator, step >= seq_start)
                step += 1
                if on_step is not None:
                    on_step(step, stats)
                if step % cfg.TRAIN_LOG_STEP == 0 or step == total:
                    dt = (time.perf_counter() - t_last) / cfg.TRAIN_LOG_STEP
                    self.print_log(
                        f"step {step}/{total} loss {float(stats['loss']):.4f} "
                        f"iou {float(stats['iou']):.4f} grad "
                        f"{float(stats['grad_norm']):.2f} {dt:.2f}s/it")
                    t_last = time.perf_counter()
                if step % cfg.TRAIN_SAVE_STEP == 0 or step == total:
                    self.save_checkpoints(step)
        finally:
            loader.close()

    def save_checkpoints(self, step: int) -> None:
        """Raw + EMA streams (reference: trainer.py:553-591)."""
        cfg = self.cfg
        ckpt_lib.save_checkpoint(cfg.DIR_CKPT, step, self.state.state_dict(),
                                 max_keep=cfg.TRAIN_MAX_KEEP_CKPT)
        if self.state.ema is not None:
            ckpt_lib.save_checkpoint(
                cfg.DIR_EMA_CKPT, step,
                {"state_dict": self.state.ema.state_dict(self.model)},
                max_keep=cfg.TRAIN_MAX_KEEP_CKPT)
        self.print_log(f"saved checkpoints @ {step}")
