#!/usr/bin/env python
"""The 30k quality protocol of benchmarking/full_run.py, resumed in this
package from a transfer file that `ngp_pl_torch.benchmarking.full_run_probe
--save_at STEP` wrote, so that both packages train on from one state.

  python benchmarking/full_run_from_state.py --state state_27648.npz \\
      --steps 28672 [--seed 23] > log.jsonl

Builds the system as full_run.py does (32 views at 128^2, 2 test views,
L8F4, batch 8192, the cosine over 30 epochs of 1000 steps), marks the
grid, and only then loads the state: marking writes density 0 to every
visible cell and would reset the density EMA.  A transfer file is a full
checkpoint in this package's keys cut to fit 64 MiB: the hash table as
float16, its Adam second moment as bfloat16 bits, its first moment left
out (zero here), the packed grid rows left out (rebuilt from
`grid.occ_grid`).  Then 16-step blocks to `--steps`, one JSON line per
block with the probe's fields (loss, rm_s, occupied, mean_density,
threshold, density_max, tbl_absmax, layout, S, chain), and the test
views' PSNR/SSIM at the load and at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TABLE = "params['hash_table']"
TABLE_MU = "opt[0].mu['hash_table']"
TABLE_NU = "opt[0].nu['hash_table']"


def _expand(path, cascades, grid_size):
    """The transfer file as a full checkpoint's arrays."""
    import jax.numpy as jnp
    import numpy as np

    from ngp_pl_tpu.models.occupancy import grid_rows

    with np.load(path, allow_pickle=False) as f:
        data = dict(f)
    data[TABLE] = data[TABLE].astype(np.float32)
    data[TABLE_NU] = (data[TABLE_NU].astype(np.uint32) << 16).view(
        np.float32)
    data[TABLE_MU] = np.zeros_like(data[TABLE])
    rows = grid_rows(jnp.asarray(data["grid.occ_grid"]), cascades, grid_size)
    for k, r in zip(("occ_rows", "dil_rows", "win_rows"), rows):
        data[f"grid.{k}"] = np.asarray(r)
    return data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", type=str, required=True)
    ap.add_argument("--steps", type=int, required=True,
                    help="the step to train to")
    ap.add_argument("--protocol_steps", type=int, default=30000,
                    help="the run's length, which sets the lr schedule")
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args()

    from ngp_pl_tpu.utils.jax_setup import enable_compilation_cache

    enable_compilation_cache()
    import numpy as np

    from ngp_pl_tpu.config import TrainConfig
    from ngp_pl_tpu.datasets.synthetic import SyntheticDataset
    from ngp_pl_tpu.training.system import NeRFSystem

    tcfg = TrainConfig(dataset_name="synthetic", batch_size=8192,
                       num_epochs=max(1, args.protocol_steps // 1000),
                       iters_per_epoch=1000, seed=args.seed,
                       exp_name="full_run_from_state", no_save_test=True,
                       n_levels=8, n_features=4, log2_hashmap_size=19)
    system = NeRFSystem(
        tcfg,
        train_dataset=SyntheticDataset(split="train", img_size=args.img_size,
                                       n_train=args.n_train),
        test_dataset=SyntheticDataset(split="test", img_size=args.img_size,
                                      n_test=2))
    system.on_train_start()
    data = _expand(args.state, system.cfg.cascades, system.cfg.grid_size)
    with tempfile.TemporaryDirectory() as d:
        full = os.path.join(d, "state.npz")
        np.savez(full, **data)
        system.load(full)
    nb, batch = tcfg.grid_update_interval, tcfg.batch_size

    def grid_fields():
        gs = system.grid_state
        mean = float(np.asarray(gs.mean_density))
        return {"occupied": float(np.asarray(gs.occ_grid).mean()),
                "mean_density": mean,
                "threshold": min(mean, float(system.density_threshold)),
                "density_max": float(np.asarray(gs.density_grid).max()),
                "tbl_absmax": float(np.abs(np.asarray(
                    system.state.params["hash_table"])).max())}

    def scores():
        s = system.validate(save_images=False)
        return {"test_psnr": s["psnr"], "test_ssim": s["ssim"]}

    print(json.dumps({"step": system._host_step, "package": "ngp_pl_tpu",
                      "from_state": args.state, **grid_fields(),
                      **scores()}), flush=True)
    t0 = time.time()
    for i in range(system._host_step // nb, args.steps // nb):
        m = system.step_block()
        rec = {"step": (i + 1) * nb, "package": "ngp_pl_tpu",
               "loss": float(np.asarray(m["loss"])),
               "rm_s": float(np.asarray(m["rm_samples"])) / batch,
               "layout": system.layout, "S": system._pool_mult,
               "chain": (system._rounds_chain if system.layout == "rounds"
                         else system.chain_length),
               **grid_fields(), "t": time.time() - t0}
        if (i + 1) * nb == args.steps:
            rec.update(scores())
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
