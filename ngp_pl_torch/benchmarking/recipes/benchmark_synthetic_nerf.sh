#!/bin/bash
# Synthetic-NeRF benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_synthetic_nerf.sh; reference
# benchmarking/benchmark_synthetic_nerf.sh): 20 epochs, batch 16384,
# lr 2e-2, LPIPS eval.  Runs on the card; DEVICE=cpu runs on the CPU.
export ROOT_DIR=${ROOT_DIR:-/data/Synthetic_NeRF}
# the repository root on PYTHONPATH, so that it runs from anywhere
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# SMOKE=1: the JAX recipe's hermetic tiny run on the procedural scene with
# the same recipe flags (no dataset on disk needed)
if [ -n "$SMOKE" ]; then
    exec python -m ngp_pl_torch.train \
        --root_dir "" --dataset_name synthetic --exp_name smoke_recipe \
        --num_epochs 1 --iters_per_epoch 48 --batch_size 1024 --lr 2e-2 \
        --downsample 0.25 --no_save_test --num_devices 1 \
        --device "${DEVICE:-cuda}"
fi

for SCENE in Chair Drums Ficus Hotdog Lego Materials Mic Ship; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name nsvf \
        --exp_name "$SCENE" \
        --num_epochs 20 --batch_size 16384 --lr 2e-2 --eval_lpips
done
