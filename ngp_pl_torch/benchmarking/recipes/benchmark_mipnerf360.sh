#!/bin/bash
# mip-NeRF 360 benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_mipnerf360.sh): colmap loader (its JPEG images read
# by the port's own decoder), downsample 0.25, large scale, distortion loss,
# random background.
export ROOT_DIR=${ROOT_DIR:-/data/360_v2}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

declare -A SCALE=( [bicycle]=16 [bonsai]=8 [counter]=8 [garden]=16 \
                   [kitchen]=8 [room]=8 [stump]=64 )
for SCENE in "${!SCALE[@]}"; do
    python -m ngp_pl_torch.train \
        --root_dir "$ROOT_DIR/$SCENE" \
        --dataset_name colmap \
        --exp_name "$SCENE" \
        --downsample 0.25 \
        --num_epochs 20 --batch_size 4096 --scale "${SCALE[$SCENE]}" \
        --distortion_loss_w 1e-3 --random_bg
done
