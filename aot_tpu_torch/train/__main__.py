"""Training CLI of the port: `python -m aot_tpu_torch.train` (the arguments
of tools/train.py, --max_id_num and --amp included, plus --device and
--dist_url).

    python -m aot_tpu_torch.train --stage pre_ytb_dav --model aott \\
        --gpu_num 4 --batch_size 16 --total_steps 100000 \\
        --datasets youtubevos davis2017
    python -m aot_tpu_torch.train --device cpu --gpu_num 2 --datasets test

It trains AOT and DeAOT models (`--model`, e.g. aott, deaott, r50_deaotl)
in the config's TRAIN_DTYPE, bfloat16 by default as the JAX package trains;
`--fp32` trains in float32. `--datasets test` trains on the synthetic
fixture with no data on disk. `--gpu_num N` (MESH_DP_SIZE; -1, the
default, takes every visible card) trains data-parallel on N ranks, one
process each (parallel.launch): NCCL with rank r on cuda:{DIST_START_GPU +
r}, or with `--device cpu` gloo on the CPU. The global batch
(`--batch_size`) is split evenly over the ranks. With fewer cards than
ranks it raises.
"""

from __future__ import annotations

import argparse
import ast


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train VOS (PyTorch)")
    parser.add_argument("--exp_name", type=str, default="default")
    parser.add_argument("--stage", type=str, default="pre")
    parser.add_argument("--model", type=str, default="aott")
    parser.add_argument("--gpu_num", type=int, default=-1,
                        help="data-parallel ranks, one a card (default: "
                             "every visible card; with --device cpu, 1)")
    parser.add_argument("--batch_size", type=int, default=-1)
    parser.add_argument("--total_steps", type=int, default=-1)
    parser.add_argument("--lr", type=float, default=-1.0)
    parser.add_argument("--pretrained_path", type=str, default="")
    parser.add_argument("--datasets", nargs="+", default=[])
    parser.add_argument("--data_workers", type=int, default=-1)
    parser.add_argument("--max_id_num", type=int, default=-1,
                        help="MODEL_MAX_OBJ_NUM (when > 0)")
    parser.add_argument("--amp", action="store_true",
                        help="accepted for tools/train.py's argument "
                             "surface; no effect (bf16 is the config's "
                             "TRAIN_DTYPE, --fp32 the way out)")
    parser.add_argument("--fp32", action="store_true",
                        help="train in float32 (default: the config's "
                             "TRAIN_DTYPE, bfloat16)")
    parser.add_argument("--log_step", type=int, default=-1)
    parser.add_argument("--save_step", type=int, default=-1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; rank r on cuda:"
                             "{DIST_START_GPU + r}, raises without enough "
                             "cards) or cpu (gloo ranks); a named device "
                             "such as cuda:1 for one rank")
    parser.add_argument("--dist_url", type=str, default=None,
                        help="the ranks' rendezvous, e.g. tcp://localhost:"
                             "29500 (default: a file in a fresh temporary "
                             "directory)")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="raw config override (python literal value)")
    return parser.parse_args(argv)


def config_overrides(args: argparse.Namespace) -> dict:
    """The config keys the arguments set, as tools/train.py:38-64 sets
    them."""
    over = {}
    if args.gpu_num > 0:
        over["MESH_DP_SIZE"] = args.gpu_num
        over["TRAIN_GPUS"] = args.gpu_num
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
    if args.max_id_num > 0:
        over["MODEL_MAX_OBJ_NUM"] = args.max_id_num
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
    import torch

    from aot_tpu_torch import parallel
    from aot_tpu_torch.configs import build_config
    from aot_tpu_torch.train.trainer import train_rank

    cfg = build_config(stage=args.stage, model=args.model,
                       exp_name=args.exp_name, make_dirs=True,
                       **config_overrides(args))
    device = torch.device(args.device or "cuda")
    world = parallel.dp_world_size(cfg, device.type)
    if device.type == "cuda" and (device.index is None or world > 1):
        try:
            devices = parallel.rank_devices(world, "cuda",
                                            int(cfg.DIST_START_GPU))
        except RuntimeError as err:
            raise RuntimeError(f"MESH_DP_SIZE={cfg.MESH_DP_SIZE}: {err}"
                               ) from None
    else:
        devices = [str(device)] * world
    parallel.launch(train_rank, world, (cfg, args.seed), devices=devices,
                    init_method=args.dist_url)


if __name__ == "__main__":
    main()
