"""Training CLI of the port: `python -m aot_tpu_torch.train` (the arguments
of tools/train.py that one fp32 device needs).

    python -m aot_tpu_torch.train --stage pre_ytb_dav --model aott --fp32 \\
        --batch_size 16 --total_steps 100000 --datasets youtubevos davis2017

Without --fp32 (or TRAIN_DTYPE='float32' through --set) the trainer refuses
to start: bf16 is not ported. `--datasets test` trains on the synthetic
fixture with no data on disk.
"""

from __future__ import annotations

import argparse
import ast


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train VOS (PyTorch, one GPU)")
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--stage", type=str, default="pre")
    parser.add_argument("--model", type=str, default="aott")
    parser.add_argument("--gpu_num", type=int, default=-1,
                        help="devices (the port trains on one)")
    parser.add_argument("--batch_size", type=int, default=-1)
    parser.add_argument("--total_steps", type=int, default=-1)
    parser.add_argument("--lr", type=float, default=-1.0)
    parser.add_argument("--pretrained_path", type=str, default="")
    parser.add_argument("--datasets", nargs="+", default=[])
    parser.add_argument("--data_workers", type=int, default=-1)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--log_step", type=int, default=-1)
    parser.add_argument("--save_step", type=int, default=-1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda:0; raises without a "
                             "card unless --device cpu)")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="raw config override (python literal value)")
    return parser.parse_args(argv)


def config_overrides(args: argparse.Namespace) -> dict:
    over = {}
    if args.gpu_num > 0:
        over["MESH_DP_SIZE"] = args.gpu_num
    if args.batch_size > 0:
        over["TRAIN_BATCH_SIZE"] = args.batch_size
    if args.total_steps > 0:
        over["TRAIN_TOTAL_STEPS"] = args.total_steps
    if args.lr > 0:
        over["TRAIN_LR"] = args.lr
    if args.pretrained_path:
        over["PRETRAIN_MODEL"] = args.pretrained_path
        over["PRETRAIN_FULL"] = True
    if args.datasets:
        over["DATASETS"] = args.datasets
    if args.data_workers >= 0:
        over["DATA_WORKERS"] = args.data_workers
    if args.fp32:
        over["TRAIN_DTYPE"] = "float32"
    if args.log_step > 0:
        over["TRAIN_LOG_STEP"] = args.log_step
    if args.save_step > 0:
        over["TRAIN_SAVE_STEP"] = args.save_step
    for kv in args.overrides:
        key, _, val = kv.partition("=")
        try:
            over[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            over[key] = val
    return over


def main(argv=None) -> None:
    args = parse_args(argv)
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.train.trainer import Trainer

    cfg = build_config(stage=args.stage, model=args.model,
                       exp_name=args.exp_name, make_dirs=True,
                       **config_overrides(args))
    Trainer(cfg, seed=args.seed, device=args.device).sequential_training()


if __name__ == "__main__":
    main()
