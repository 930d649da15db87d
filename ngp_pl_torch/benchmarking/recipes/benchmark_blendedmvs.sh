#!/bin/bash
# BlendedMVS benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_blendedmvs.sh).
export ROOT_DIR=${ROOT_DIR:-/data/BlendedMVS}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for SCENE in Character Fountain Jade Statues; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name nsvf \
        --exp_name "$SCENE" \
        --num_epochs 20 --batch_size 16384 --lr 2e-2 --scale 4.0
done
