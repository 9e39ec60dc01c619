#!/usr/bin/env bash
# Two-stage training (PRE then PRE_YTB_DAV) + benchmark evals with the
# PyTorch port (counterpart of the repository's train_eval.sh: the same
# flow on CUDA cards, one process a card). Run from the repository root:
#   devices=4 bash aot_tpu_torch/scripts/train_eval.sh [exp] [model]
set -e

exp="${1:-aot}"
model="${2:-aott}"
devices="${devices:--1}"

echo "== stage 1: static-image pretraining (PRE) =="
python -m aot_tpu_torch.train --exp_name "${exp}" --stage pre \
    --model "${model}" --gpu_num "${devices}"

echo "== stage 2: main VOS training (PRE_YTB_DAV) =="
python -m aot_tpu_torch.train --exp_name "${exp}" --stage pre_ytb_dav \
    --model "${model}" --gpu_num "${devices}"

echo "== evals =="
dataset_args=(
    "--dataset youtubevos --split val"
    "--dataset youtubevos2019 --split val"
    "--dataset davis2017 --split val"
    "--dataset davis2017 --split test"
    "--dataset davis2016 --split val"
)
for args in "${dataset_args[@]}"; do
    # shellcheck disable=SC2086
    python -m aot_tpu_torch.eval --exp_name "${exp}" --stage pre_ytb_dav \
        --model "${model}" --ema ${args}
done
