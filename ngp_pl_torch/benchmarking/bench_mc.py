"""Multi-cascade (scale 4, exponential steps) train bench and quality gate,
the counterpart of benchmarking/bench_mc.py.

    python -m ngp_pl_torch.benchmarking.bench_mc --steps 4096
    python -m ngp_pl_torch.benchmarking.bench_mc --steps 4096 --no_window

The reference's unbounded-scene recipes (scale 4-64, steps growing by
1/256) march four cascades.  This bench trains the flagship field (L=8,
F=4, T=2^19, grid 128^3, batch 8192, the default `auto` layout) at
`--scale` (4) on the procedural scene scaled by scale / 0.5, so that its
content fills the box as the unscaled scene fills the scale-0.5 box: 8
train views and 2 test views at `--img_size` (96), on a black background.
It trains `--steps` in 16-step blocks (a line every 512 steps), pins the
buckets, times 64 more steps between two fences and scores the test
views.  `--no_window` marches every step on the grid instead of the
two-window chain (the A/B of the JAX bench).

Prints the JSON record last and writes it to bench_mc_<tag>.json beside
this module (`window` or `zline`).  Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

RECORD_DIR = os.path.dirname(os.path.abspath(__file__))
TIMED_STEPS = 64


def bench_mc_system(device: str, steps: int, scale: float = 4.0,
                    img_size: int = 96, batch_size: int = 8192):
    """The JAX bench's system: its config (the cosine over steps // 1000
    epochs of 1000) and the scene scaled by scale / 0.5 on black."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    tcfg = TrainConfig(dataset_name="synthetic", batch_size=batch_size,
                       num_epochs=max(1, steps // 1000), iters_per_epoch=1000,
                       exp_name="bench_mc", no_save_test=True, scale=scale)
    ws = scale / 0.5
    return NeRFSystem(
        tcfg, device=device,
        train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                       n_train=8, world_scale=ws, bg=0.0,
                                       device=device),
        test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                      n_test=2, world_scale=ws, bg=0.0,
                                      device=device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--scale", type=float, default=4.0)
    ap.add_argument("--no_window", action="store_true",
                    help="march every step on the grid (A/B baseline)")
    ap.add_argument("--img_size", type=int, default=96)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    system = bench_mc_system(args.device, args.steps, args.scale,
                             args.img_size)
    print(f"cascades {system.cfg.cascades} exp_step_factor "
          f"{system.cfg.exp_step_factor} window_march {system.window_march} "
          f"chain_full {system.chain_full}", flush=True)
    if args.no_window:
        system.window_march = False
    system.on_train_start()
    nb, batch = system.tcfg.grid_update_interval, system.tcfg.batch_size
    if args.steps % nb:
        raise ValueError(f"--steps must be a multiple of {nb}")

    t0 = time.time()
    m = None
    for i in range(args.steps // nb):
        m = system.step_block()
        if ((i + 1) * nb) % 512 == 0:
            print(f"  {(i + 1) * nb}/{args.steps} loss "
                  f"{float(m['loss']):.4f} "
                  f"rm_s {float(m['rm_samples']) / batch:6.1f} "
                  f"S {system._pool_mult} {system.layout} "
                  f"chain {system.chain_length} t {time.time() - t0:6.1f}s",
                  flush=True)
    if m is not None:
        float(m["loss"])

    system.freeze_buckets = True
    t0 = time.time()
    for _ in range(TIMED_STEPS // nb):
        m = system.step_block()
    float(m["loss"])
    rays_per_s = batch * TIMED_STEPS / (time.time() - t0)
    scores = system.validate(save_images=False)
    tag = "zline" if args.no_window else "window"
    rec = {"tag": f"mc_{tag}", "scale": args.scale, "steps": args.steps,
           "cascades": system.cfg.cascades, "rays_per_s": rays_per_s,
           "psnr": scores["psnr"], "ssim": scores["ssim"],
           "layout": system.layout, "pool_mult": system._pool_mult,
           "chain": system.chain_length,
           "layout_log": [list(e) for e in system.layout_log],
           "device": str(system.dev)}
    print(json.dumps(rec), flush=True)
    with open(os.path.join(RECORD_DIR, f"bench_mc_{tag}.json"), "w") as f:
        json.dump(rec, f)
    return rec


if __name__ == "__main__":
    main()
