"""Steady-state training throughput, the counterpart of bench.py.

    python -m ngp_pl_torch.benchmarking.bench
    BENCH_BATCH=256 BENCH_WARM_STEPS=32 BENCH_STEPS=16 \\
        python -m ngp_pl_torch.benchmarking.bench --device cpu

The flagship model (L=8, F=4, T=2^19, grid 128^3, scale 0.5, the default
`auto` layout) on bench.py's scene, 8 synthetic views at 96x96.  It trains
BENCH_WARM_STEPS (2048) steps in 16-step blocks, so that the occupancy
grid, the budgets and the lr reach the regime a 30k-step run spends its
time in, then pins layout, budget and chain (`freeze_buckets`), runs one
more block, and times BENCH_STEPS (192, rounded down to whole blocks, at
least one) steps between two fences (a host read of the loss).  Batch
BENCH_BATCH (8192).  BENCH_SCALE (0.5) above 0.5 trains the same views
with bench.py's multi-cascade / exponential-step model of that scale
(at 4: four cascades, steps growing by 1/256), on a black background.
`--use_exposure` and `--optimize_ext` train the HDR head and pose
refinement, as the train entry point's flags do.

Prints warm-up progress on stderr and ONE JSON line on stdout:
{"metric": "train_rays_per_s", "value", "unit", "vs_baseline"}, where the
baseline is bench.py's 1e6 rays/s.  Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BASELINE_RAYS_PER_S = 1.0e6


def bench_system(device: str, batch_size: int, scale: float,
                 use_exposure: bool = False, optimize_ext: bool = False):
    """bench.py's system: the flagship on 8 views at 96x96, one test view
    (with the HDR head or pose refinement where asked)."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    tcfg = TrainConfig(dataset_name="synthetic", batch_size=batch_size,
                       scale=scale, num_epochs=30, exp_name="bench",
                       no_save_test=True, use_exposure=use_exposure,
                       optimize_ext=optimize_ext)
    return NeRFSystem(
        tcfg, device=device,
        train_dataset=SyntheticDataset(split="train", img_size=96, n_train=8,
                                       device=device),
        test_dataset=SyntheticDataset(split="test", img_size=96, n_test=1,
                                      device=device))


def run(system, warm_steps: int, steps: int, log=sys.stderr) -> dict:
    """Warm, freeze the buckets, time whole blocks; returns the record."""
    nb = system.tcfg.grid_update_interval
    system.on_train_start()

    def fence(metrics):
        return float(metrics["loss"])

    t_w = time.time()
    m = None
    for i in range(warm_steps // nb):
        m = system.step_block()
        if (i + 1) % 4 == 0:
            fence(m)
            print(f"warm {(i + 1) * nb}/{warm_steps} "
                  f"{(time.time() - t_w) / (4 * nb) * 1e3:.0f}ms/step "
                  f"{system.layout} x{system._pool_mult} "
                  f"chain {system.chain_length}", file=log, flush=True)
            t_w = time.time()
    if m is not None:
        fence(m)
    system.freeze_buckets = True
    fence(system.step_block())
    steps = max(nb, (steps // nb) * nb)
    t0 = time.time()
    for _ in range(steps // nb):
        m = system.step_block()
    fence(m)
    rays_per_s = system.tcfg.batch_size * steps / (time.time() - t0)
    return {"metric": "train_rays_per_s", "value": rays_per_s,
            "unit": "rays/s", "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--use_exposure", action="store_true")
    ap.add_argument("--optimize_ext", action="store_true")
    args = ap.parse_args(argv)
    flags = {k: True for k in ("use_exposure", "optimize_ext")
             if getattr(args, k)}
    batch_size = int(os.environ.get("BENCH_BATCH", 8192))
    warm_steps = int(os.environ.get("BENCH_WARM_STEPS", 2048))
    steps = int(os.environ.get("BENCH_STEPS", 192))
    scale = float(os.environ.get("BENCH_SCALE", 0.5))
    rec = run(bench_system(args.device, batch_size, scale, **flags),
              warm_steps, steps)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
