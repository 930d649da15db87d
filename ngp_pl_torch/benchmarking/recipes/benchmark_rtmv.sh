#!/bin/bash
# RTMV benchmark recipe of the PyTorch port (counterpart of
# benchmarking/benchmark_rtmv.sh).  Convert each scene's .exr frames first:
# python -m ngp_pl_torch.misc.prepare_rtmv "$ROOT_DIR/<env>".
export ROOT_DIR=${ROOT_DIR:-/data/RTMV}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for ENV in bricks google_scanned abc amazon_berkeley; do
    for SCENE_DIR in "$ROOT_DIR/$ENV"/*/; do
        SCENE=$(basename "$SCENE_DIR")
        python -m ngp_pl_torch.train \
            --root_dir "$SCENE_DIR" \
            --dataset_name rtmv \
            --exp_name "$ENV/$SCENE" \
            --num_epochs 20 --batch_size 16384 --lr 2e-2
    done
done
