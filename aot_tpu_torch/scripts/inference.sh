#!/usr/bin/env bash
# Demo inference with the PyTorch port on the card (counterpart of the
# repository's inference.sh). Run from the repository root:
#   bash aot_tpu_torch/scripts/inference.sh [model] [ckpt]
set -e
model="${1:-r50_deaotl}"
ckpt="${2:-test}"
python -m aot_tpu_torch.tools.demo --model "${model}" --ckpt_path "${ckpt}" \
    --data_path ./datasets/Demo --output_path ./demo_output
