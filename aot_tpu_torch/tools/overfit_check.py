"""Overfit-one-batch convergence diagnostic (the counterpart of
tools/overfit_check.py).

Takes ONE batch from the Static-pretrain pipeline (or an npz) and steps the
port's training step (train/step.py, through a Trainer) on it repeatedly.
If model, loss and optimizer are sound, the IoU climbs within a few
hundred steps: this isolates the training math from data-pipeline
variance.

    cd <run dir with datasets/Static> && \\
        python -m aot_tpu_torch.tools.overfit_check [--steps 300] \\
            [--model aott] [--batch 4] [--batch_npz batch.npz]

tools/overfit_check.py's flags, config overrides, npz layout (keys
`frames`, `labels`, `obj_nums`, as the loader collates them; a batch or a
stream written by either tool loads in the other) and JSON lines: the
batch's `obj_nums`, then {step, loss, iou, grad, sec_per_it} every
--log_step steps, then the verdict {verdict, final_iou} at its 0.25 bar.
Runs on cuda:0 unless --device names another (`--device cpu`, which
replaces the JAX tool's --cpu), and raises when there is no card.
--init_pth loads a .pth strictly (utils/weights.load_weights_file: every
key of the model, no other); --perturb draws its noise from a seeded
torch.Generator.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Overfit one batch (PyTorch)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--model", default="aott")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--crop", type=int, default=257)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--log_step", type=int, default=25)
    ap.add_argument("--max_objs", type=int, default=0,
                    help="cap objects per sample (0 = leave as sampled)")
    ap.add_argument("--no_id_shuffle", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--no_droppath", action="store_true")
    ap.add_argument("--batch_npz", default="",
                    help="load the fixed batch from this npz instead of "
                         "sampling")
    ap.add_argument("--dump_batch", default="",
                    help="save the sampled batch to this npz and exit")
    ap.add_argument("--stream_npz", default="",
                    help="npz of K pre-sampled batches (leading K axis), "
                         "cycled batches[step %% K]")
    ap.add_argument("--dump_stream", type=int, default=0,
                    help="sample K batches from the pipeline, save to "
                         "--dump_batch path, and exit")
    ap.add_argument("--jsonl", default="", help="also append metrics here")
    ap.add_argument("--init_pth", default="",
                    help="state dict to initialise from, loaded strictly")
    ap.add_argument("--no_seq_freeze", action="store_true",
                    help="disable the step>=50%% id-bank seq-training "
                         "freeze (train/optim.py)")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="relative init perturbation (e.g. 1e-7): a chaos "
                         "control for convergence A/B runs")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda:0; raises without "
                         "a card unless --device cpu)")
    return ap


def main(argv=None) -> float:
    """Run the check; returns the last logged IoU."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.data.loader import TrainLoader
    from aot_tpu_torch.data.train_datasets import build_train_dataset
    from aot_tpu_torch.train.step import make_train_step
    from aot_tpu_torch.train.trainer import Trainer
    from aot_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(stage="pre", model=args.model, exp_name="overfit")
    cfg.TRAIN_BATCH_SIZE = args.batch
    cfg.DATA_RANDOMCROP = (args.crop, args.crop)
    cfg.TRAIN_LR = args.lr
    cfg.TRAIN_TOTAL_STEPS = args.steps
    cfg.DATA_WORKERS = 0
    cfg.TRAIN_AUTO_RESUME = False
    if args.no_droppath:
        cfg.TRAIN_LSTT_DROPPATH = 0.0
    if args.no_seq_freeze:
        cfg.TRAIN_SEQ_TRAINING_START_RATIO = 10.0  # never reached
    if args.fp32:
        cfg.TRAIN_DTYPE = "float32"
        cfg.TRAIN_MATMUL_PRECISION = "high"
    os.makedirs(cfg.DIR_CKPT, exist_ok=True)
    os.makedirs(cfg.DIR_LOG, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cap_objs(b):
        if args.max_objs <= 0:
            return b
        lab = np.asarray(b["labels"])
        return {"frames": b["frames"],
                "labels": np.where(lab <= args.max_objs, lab, 0),
                "obj_nums": np.minimum(np.asarray(b["obj_nums"]),
                                       args.max_objs)}

    def sample(n):
        loader = TrainLoader(build_train_dataset(cfg), cfg.TRAIN_BATCH_SIZE,
                             num_workers=0, seed=0)
        try:
            it = iter(loader)
            return [next(it) for _ in range(n)]
        finally:
            loader.close()

    if args.dump_stream > 0:
        batches = [cap_objs(b) for b in sample(args.dump_stream)]
        np.savez(args.dump_batch,
                 **{k: np.stack([np.asarray(b[k]) for b in batches])
                    for k in ("frames", "labels", "obj_nums")})
        print(json.dumps({"dumped_stream": args.dump_batch,
                          "k": args.dump_stream}))
        return 0.0

    stream = None
    if args.stream_npz:
        d = np.load(args.stream_npz)
        stream = {k: d[k] for k in ("frames", "labels", "obj_nums")}
        batch = {k: v[0] for k, v in stream.items()}
    elif args.batch_npz:
        d = np.load(args.batch_npz)
        batch = {k: d[k] for k in ("frames", "labels", "obj_nums")}
    else:
        batch = sample(1)[0]
    batch = cap_objs(batch)
    if args.dump_batch:
        np.savez(args.dump_batch, **batch)
        print(json.dumps({"dumped": args.dump_batch,
                          "obj_nums": [int(x) for x in batch["obj_nums"]]}))
        return 0.0

    trainer = Trainer(cfg, device=device)
    model, ema = trainer.model, trainer.state.ema
    if args.init_pth:
        from aot_tpu_torch.utils.weights import load_weights_file

        load_weights_file(model, args.init_pth)
        if ema is not None:
            ema.load_shadow(dict(model.named_parameters()), 0)
        print(json.dumps({"init_pth": args.init_pth, "unexpected": 0}),
              flush=True)
    if args.perturb > 0.0:
        gen = torch.Generator().manual_seed(123)
        with torch.no_grad():
            for p in model.parameters():
                noise = torch.randn(p.shape, generator=gen)
                p.mul_(1.0 + args.perturb * noise.to(p.device))
        if ema is not None:
            ema.load_shadow(dict(model.named_parameters()), 0)
        print(json.dumps({"perturb": args.perturb}), flush=True)
    if args.no_id_shuffle:
        trainer.train_step = make_train_step(cfg, trainer.engine,
                                             enable_id_shuffle=False)

    def to_device(b):
        return [torch.from_numpy(np.asarray(b[k])).to(device)
                for k in ("frames", "labels", "obj_nums")]

    frames, labels, obj_nums = to_device(batch)
    print(json.dumps({"obj_nums": [int(x) for x in batch["obj_nums"]]}),
          flush=True)
    jf = open(args.jsonl, "a") if args.jsonl else None

    generator = torch.Generator().manual_seed(7)
    t0 = time.time()
    last_iou = 0.0
    k_stream = stream["frames"].shape[0] if stream is not None else 1
    try:
        for step in range(1, args.steps + 1):
            if stream is not None:
                i = (step - 1) % k_stream
                frames, labels, obj_nums = to_device(
                    {k: v[i] for k, v in stream.items()})
            stats = trainer.train_step(trainer.state, frames, labels,
                                       obj_nums, generator, False)
            if step % args.log_step == 0 or step == args.steps:
                last_iou = float(stats["iou"])
                rec = {
                    "step": step,
                    "loss": round(float(stats["loss"]), 4),
                    "iou": round(last_iou, 4),
                    "grad": round(float(stats["grad_norm"]), 3),
                    "sec_per_it": round((time.time() - t0) / step, 3),
                }
                print(json.dumps(rec), flush=True)
                if jf:
                    jf.write(json.dumps(rec) + "\n")
                    jf.flush()
    finally:
        if jf:
            jf.close()
    # tools/overfit_check.py's bar: from-scratch AOTT on a fixed 2-object
    # batch reaches ~0.38 IoU in 200 steps; it detects broken training,
    # not imperfect memorisation
    verdict = "PASS" if last_iou > 0.25 else "FAIL"
    print(json.dumps({"verdict": verdict, "final_iou": last_iou}), flush=True)
    return last_iou


if __name__ == "__main__":
    main()
