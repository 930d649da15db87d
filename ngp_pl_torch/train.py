"""Train the field and score the test views (counterpart of train.py;
reference train.py __main__) on the procedural synthetic scene, in the
sample layout of `--train_layout` (auto, the default, as the JAX
package's: CSR through grid warmup, then strided or CSR by the demand;
or pinned to csr, strided or rounds), with `--distortion_loss_w` for the
distortion loss.  Runs on the card unless `--device cpu` is given.

    python -m ngp_pl_torch.train --dataset_name synthetic --num_epochs 1 \\
        --iters_per_epoch 512
    python -m ngp_pl_torch.train --train_layout rounds \\
        --distortion_loss_w 1e-2 --num_epochs 1 --iters_per_epoch 512
    python -m ngp_pl_torch.train --device cpu --n_levels 4 \\
        --log2_hashmap_size 12 --batch_size 256 --downsample 0.1875 \\
        --num_epochs 1 --iters_per_epoch 32
    python -m ngp_pl_torch.train --ckpt_path \\
        ckpts/synthetic/exp/epoch=30.npz --val_only

`--ckpt_path` resumes from a full checkpoint of either package (params,
Adam state, grid state and step) and trains the steps left of
num_epochs x iters_per_epoch; `--val_only` skips training.  After training
it writes a full and a slim checkpoint in the JAX key format to
ckpts/<dataset>/<exp_name>/epoch=<num_epochs>.npz and
epoch=<num_epochs>_slim.npz (`--weight_path` loads the slim kind).  It
then scores the test views and, unless `--no_save_test`, writes them to
results/<dataset>/<exp_name>/NNN.png and their depth to NNN_d.png.
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
    if tcfg.ckpt_path:
        system.load(tcfg.ckpt_path)
    if not tcfg.val_only:
        t0 = time.time()
        system.fit(max_steps=tcfg.max_steps - system._host_step)
        print(f"training took {time.time() - t0:.1f}s")
        ckpt_dir = os.path.join("ckpts", tcfg.dataset_name, tcfg.exp_name)
        os.makedirs(ckpt_dir, exist_ok=True)
        system.save(os.path.join(ckpt_dir, f"epoch={tcfg.num_epochs}.npz"))
        system.save_slim(
            os.path.join(ckpt_dir, f"epoch={tcfg.num_epochs}_slim.npz"))
    scores = system.validate(max_images=args.max_images)
    print("test: " + " ".join(f"{k}={v:.4f}" for k, v in scores.items()))
    return system, scores


if __name__ == "__main__":
    main()
