"""Train the field and score the test views (counterpart of train.py;
reference train.py __main__), the CSR layout on the procedural synthetic
scene.  Runs on the card unless `--device cpu` is given.

    python -m ngp_pl_torch.train --dataset_name synthetic --num_epochs 1 \\
        --iters_per_epoch 512
    python -m ngp_pl_torch.train --device cpu --n_levels 4 \\
        --log2_hashmap_size 12 --batch_size 256 --downsample 0.1875 \\
        --num_epochs 1 --iters_per_epoch 32

After training it writes a slim checkpoint in the JAX key format to
ckpts/<dataset>/<exp_name>/epoch=<num_epochs>_slim.npz.
"""
from __future__ import annotations

import argparse
import os
import time

from ngp_pl_torch.config import add_train_args, config_from_args
from ngp_pl_torch.training.system import NeRFSystem


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--max_images", type=int, default=None,
                        help="score only the first N test views")
    args = parser.parse_args(argv)
    tcfg = config_from_args(args)
    system = NeRFSystem(tcfg, device=args.device)
    t0 = time.time()
    system.fit()
    print(f"training took {time.time() - t0:.1f}s")
    ckpt_dir = os.path.join("ckpts", tcfg.dataset_name, tcfg.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch={tcfg.num_epochs}_slim.npz")
    system.save_slim(path)
    scores = system.validate(max_images=args.max_images)
    print("test: " + " ".join(f"{k}={v:.4f}" for k, v in scores.items()))
    return system, scores


if __name__ == "__main__":
    main()
