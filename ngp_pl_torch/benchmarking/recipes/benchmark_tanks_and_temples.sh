#!/bin/bash
# TanksAndTemples benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_tanks_and_temples.sh): real scenes, scale 4,
# black->white background scenes handled by the loader.
export ROOT_DIR=${ROOT_DIR:-/data/TanksAndTemple}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for SCENE in Barn Caterpillar Family Ignatius Truck; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name nsvf \
        --exp_name "$SCENE" \
        --num_epochs 20 --batch_size 16384 --lr 2e-2 --scale 4.0
done
