#!/bin/bash
# Synthetic-NSVF benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_synthetic_nsvf.sh).
export ROOT_DIR=${ROOT_DIR:-/data/Synthetic_NSVF}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for SCENE in Bike Lifestyle Palace Robot Spaceship Steamtrain Toad Wineholder; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name nsvf \
        --exp_name "$SCENE" \
        --num_epochs 20 --batch_size 16384 --lr 2e-2 --eval_lpips
done
