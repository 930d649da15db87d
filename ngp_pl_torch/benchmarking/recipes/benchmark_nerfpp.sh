#!/bin/bash
# NeRF++ (unbounded real) benchmark recipe of the PyTorch port (counterpart
# of benchmarking/benchmark_nerfpp.sh).
export ROOT_DIR=${ROOT_DIR:-/data/nerf_pp}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for SCENE in tat_intermediate_M60 tat_intermediate_Playground \
             tat_intermediate_Train tat_training_Truck; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name nerfpp \
        --exp_name "$SCENE" \
        --num_epochs 20 --batch_size 16384 --lr 2e-2 --scale 4.0 \
        --random_bg
done
