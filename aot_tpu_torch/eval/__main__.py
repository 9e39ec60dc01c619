"""Evaluation CLI of the port: `python -m aot_tpu_torch.eval` (the
arguments of tools/eval.py, plus --device and --set).

    python -m aot_tpu_torch.eval --stage pre_ytb_dav --model aott \\
        --dataset davis2017 --split val --ckpt_path test
    python -m aot_tpu_torch.eval --dataset davis2017 --max_resolution 1080 \\
        --set TEST_DATASET_FULL_RESOLUTION=True --ckpt_path <file.pth>

Runs on cuda:0 unless --device names another (`--device cpu`), and raises
when there is no card. `--ckpt_path test` evaluates seeded random weights;
a `.pth` path (or the newest `save_step_N.pth` of the experiment's
checkpoint directory, `--ema` for the EMA stream) loads a checkpoint of the
port's trainer or a reference-keyed state dict of the reference PyTorch
repository. `--amp` serves in bf16 (TEST_DTYPE=bfloat16), `--video_batch N`
advances N videos a step and `--frame_chunk K` steps label-free runs K
frames at a time (eval/evaluator.py).
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Optional

import torch

from aot_tpu_torch.utils.weights import load_model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Eval VOS (PyTorch, one GPU)")
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--stage", type=str, default="pre_ytb_dav")
    parser.add_argument("--model", type=str, default="aott")
    parser.add_argument("--dataset", type=str, default="")
    parser.add_argument("--split", type=str, default="")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--ckpt_step", type=int, default=-1)
    parser.add_argument("--ema", action="store_true", default=False,
                        help="evaluate the EMA stream (DIR_EMA_CKPT); a "
                             "trainable-BN (MODEL_FREEZE_BN=False) run's "
                             "EMA checkpoint carries its running stats and "
                             "loads strictly into the frozen-BN eval model")
    parser.add_argument("--flip", action="store_true")
    parser.add_argument("--ms", nargs="+", type=float, default=[1.0])
    parser.add_argument("--max_resolution", type=float, default=480 * 1.3)
    parser.add_argument("--amp", action="store_true", default=False,
                        help="bf16 inference (TEST_DTYPE=bfloat16)")
    parser.add_argument("--lstt_num", type=int, default=-1,
                        help="override MODEL_LSTT_NUM")
    parser.add_argument("--max_id_num", type=int, default=-1,
                        help="override MODEL_MAX_OBJ_NUM")
    parser.add_argument("--frame_chunk", type=int, default=-1,
                        help="TEST_FRAME_CHUNK: label-free frames a step")
    parser.add_argument("--video_batch", type=int, default=-1,
                        help="TEST_VIDEO_BATCH: videos a step")
    parser.add_argument("--lt_gap", type=int, default=-1)
    parser.add_argument("--st_skip", type=int, default=-1)
    parser.add_argument("--mem_cap", type=int, default=-1)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda:0; raises without "
                             "a card unless --device cpu)")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="raw config override (python literal value)")
    return parser


def build_overrides(args: argparse.Namespace) -> dict:
    """Map CLI flags to config overrides, as tools/eval.py:49-81 does, then
    the raw --set overrides."""
    over = {}
    if args.dataset:
        over["TEST_DATASET"] = args.dataset
    if args.split:
        over["TEST_DATASET_SPLIT"] = args.split
    if args.flip:
        over["TEST_FLIP"] = True
    if args.ms != [1.0]:
        over["TEST_MULTISCALE"] = args.ms
        # multiscale caps the short edge to prevent OOM (reference
        # tools/eval.py:96-99)
        over["TEST_MAX_SHORT_EDGE"] = args.max_resolution
    if args.amp:
        over["TEST_DTYPE"] = "bfloat16"
    if args.lstt_num > 0:
        over["MODEL_LSTT_NUM"] = args.lstt_num
    if args.max_id_num > 0:
        over["MODEL_MAX_OBJ_NUM"] = args.max_id_num
    if args.frame_chunk > 0:
        over["TEST_FRAME_CHUNK"] = args.frame_chunk
    if args.video_batch > 0:
        over["TEST_VIDEO_BATCH"] = args.video_batch
    if args.lt_gap > 0:
        over["TEST_LONG_TERM_MEM_GAP"] = args.lt_gap
    if args.st_skip > 0:
        over["TEST_SHORT_TERM_MEM_SKIP"] = args.st_skip
    if args.mem_cap > 0:
        over["TEST_LONG_TERM_MEM_CAP"] = args.mem_cap
    over["TEST_MAX_LONG_EDGE"] = args.max_resolution * 800 / 480
    for kv in args.overrides:
        key, _, val = kv.partition("=")
        try:
            over[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            over[key] = val
    return over


def resolve_checkpoint(args: argparse.Namespace, cfg) -> Optional[str]:
    """Explicit path > explicit step > the newest in the experiment's
    checkpoint directory (the EMA stream with --ema)."""
    from aot_tpu_torch.utils import checkpoint as ckpt_lib

    ckpt_dir = cfg.DIR_EMA_CKPT if args.ema else cfg.DIR_CKPT
    if args.ckpt_path:
        return args.ckpt_path
    if args.ckpt_step > 0:
        return os.path.join(ckpt_dir, f"save_step_{args.ckpt_step}.pth")
    return ckpt_lib.latest_checkpoint(ckpt_dir)


def result_root(cfg, args: argparse.Namespace) -> str:
    """<DIR_EVALUATION>/<dataset>/<exp>/Annotations (tools/eval.py:129-137)."""
    exp = f"{cfg.EXP_NAME}_{cfg.STAGE_NAME}_ckpt_{args.ckpt_step}"
    if args.ema:
        exp += "_ema"
    if args.flip:
        exp += "_flip"
    if args.ms != [1.0]:
        exp += "_ms_" + "_".join(str(s) for s in args.ms)
    return os.path.join(cfg.DIR_EVALUATION, cfg.TEST_DATASET, exp,
                        "Annotations")


def run(argv=None, cudnn_benchmark: bool = True):
    """Evaluate; returns the Evaluator and its summary (with the
    per-sequence stats: per-frame times and input sizes). cuDNN autotunes
    its convolutions during the evaluation unless `cudnn_benchmark` is
    False (Evaluator)."""
    args = build_parser().parse_args(argv)
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.eval.evaluator import Evaluator
    from aot_tpu_torch.utils.device import resolve_device

    cfg = build_config(stage=args.stage, model=args.model,
                       exp_name=args.exp_name, make_dirs=True,
                       **build_overrides(args))
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = result_root(cfg, args)
    os.makedirs(root, exist_ok=True)
    model = load_model(cfg, resolve_checkpoint(args, cfg), device)
    ev = Evaluator(cfg, model, rank=args.rank,
                   world=args.world, result_root=root, device=device,
                   cudnn_benchmark=cudnn_benchmark)
    summary = ev.evaluate()
    if args.rank == 0 and "youtubevos" in cfg.TEST_DATASET:
        zip_path = os.path.join(os.path.dirname(root), "submission.zip")
        ev.package_submission(zip_path)
        print(f"[eval] packaged {zip_path}", flush=True)
    return ev, summary


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
