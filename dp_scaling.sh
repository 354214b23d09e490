#!/bin/bash
# Data-parallel CLI (cli/data_parallel.py) at 1 and 4 ranks on NCCL, one
# GPU a rank: MobileNetV2, global batch 512 (128 a rank at 4),
# SyntheticTextures, 2 epochs of 20 steps. Each run's rank-0 log goes to
# OUT_DIR/dp4_*.txt (default ./log); epoch 1's time_per_batch is the
# steady-state wall time a step.
#
#   bash dp_scaling.sh [OUT_DIR]     # on a machine with four GPUs
out=${1:-log}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$out"
run() {
  n=$1; tag=$2; shift 2
  torchrun --nproc-per-node "$n" -m distributed_model_parallel_tpu_torch.cli.data_parallel \
    --model mobilenetv2 --dataset-type SyntheticTextures -b 512 --val-batch-size 1000 \
    -j 2 --epochs 2 --steps-per-epoch 20 "$@" > "$out/dp4_$n$tag.txt" 2>&1
  echo "== n=$n $* rc=$?"
  grep -E "^==>|^epoch" "$out/dp4_$n$tag.txt"
}
run 1 "" --engine ddp
run 4 "" --engine ddp
run 4 _sync --engine ddp --sync-bn
run 4 _gspmd --engine gspmd
