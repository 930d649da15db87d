"""Full-budget training run on the procedural scene with skip telemetry,
the counterpart of benchmarking/full_run.py (the JAX package's quality
protocol).

    python -m ngp_pl_torch.benchmarking.full_run --steps 30000 \\
        --n_train 32 --img_size 128
    python -m ngp_pl_torch.benchmarking.full_run --steps 30000 \\
        --geometry L16F2
    python -m ngp_pl_torch.benchmarking.full_run --steps 30000 --ceiling

Trains `--steps` steps (batch 8192, the default `auto` layout, the cosine
over steps // 1000 epochs of 1000) in 16-step blocks, counts the steps
skipped for non-finite gradients (one sync at the end), prints a line every
1024 steps in the JAX run's format (`step ... loss ... rm_s ... tbl_absmax
... S ... layout t`, so that a log lies beside benchmarking/
full_run_n32.log line by line), scores the 2 test views without images
and writes the record as JSON to ngp_pl_torch/benchmarking/
full_run_<tag>.json.  `--geometry L8F4` (default) or `L16F2`; `--ceiling`
is the oversized L16F4, T=2^20 field that anchors the scene's PSNR
ceiling.  Every 2048 steps it writes a full checkpoint to
ckpts/synthetic/full_run_torch_<tag>/resume.npz under the working
directory and resumes from it when it is there.  Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import torch

# steps between resume checkpoints and between log lines
RESUME_EVERY = 2048
LOG_EVERY = 1024
# where the record goes: beside this module, never benchmarking/, which
# holds the JAX package's records
RECORD_DIR = os.path.dirname(os.path.abspath(__file__))

GEOMETRIES = {"L8F4": (8, 4, 19), "L16F2": (16, 2, 19),
              "ceiling": (16, 4, 20)}


def run_config(steps: int, geometry: str, ceiling: bool):
    """(TrainConfig, run name, geometry as LxFyTz) of the JAX script's
    run."""
    from ngp_pl_torch.config import TrainConfig

    name = "ceiling" if ceiling else geometry
    n_levels, n_features, log2_t = GEOMETRIES[name]
    tcfg = TrainConfig(dataset_name="synthetic", batch_size=8192,
                       num_epochs=max(1, steps // 1000), iters_per_epoch=1000,
                       no_save_test=True,
                       n_levels=n_levels, n_features=n_features,
                       log2_hashmap_size=log2_t)
    return tcfg, name, f"L{n_levels}F{n_features}T{log2_t}"


def make_system(tcfg, img_size: int, n_train: int, device: str):
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    return NeRFSystem(
        tcfg, device=device,
        train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                       n_train=n_train, device=device),
        test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                      n_test=2, device=device))


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--geometry", type=str, default="L8F4",
                    choices=["L8F4", "L16F2"])
    ap.add_argument("--ceiling", action="store_true",
                    help="oversized config (L16F4, 2^20 table) to anchor "
                         "the scene's practical PSNR ceiling")
    ap.add_argument("--img_size", type=int, default=96)
    ap.add_argument("--n_train", type=int, default=8,
                    help="training views (the JAX quality protocol: 32)")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    steps = args.steps
    tcfg, name, geometry = run_config(steps, args.geometry, args.ceiling)
    tag = args.tag or name
    tcfg = tcfg.replace(exp_name=f"full_run_{tag}")
    system = make_system(tcfg, args.img_size, args.n_train, args.device)
    system.on_train_start()
    nb = tcfg.grid_update_interval
    if steps % nb:
        raise ValueError(f"--steps must be a multiple of {nb}")

    ck = os.path.join("ckpts", "synthetic", f"full_run_torch_{tag}",
                      "resume.npz")
    start_step = 0
    if os.path.exists(ck):
        system.load(ck)
        start_step = system._host_step
        print(f"resuming from {ck} at step {start_step}", flush=True)

    skip_counters = []
    batch = tcfg.batch_size
    loss = float("nan")
    t0 = time.time()
    for i in range(start_step // nb, steps // nb):
        m = system.step_block()
        skip_counters.append(m["n_skipped"])
        step_now = (i + 1) * nb
        if step_now % RESUME_EVERY == 0 and step_now < steps:
            system.save(ck)
        if step_now % LOG_EVERY == 0 or step_now == steps:
            loss = float(m["loss"])
            tbl = float(system.ngp.hash_table.detach().abs().max())
            print(f"step {step_now:6d} loss {loss:.5f} "
                  f"rm_s {float(m['rm_samples']) / batch:6.1f} "
                  f"tbl_absmax {tbl:9.3f} "
                  f"S {system._pool_mult} {system.layout} "
                  f"t {time.time() - t0:7.1f}s", flush=True)
            if not math.isfinite(loss):
                print("*** non-finite loss — aborting run", flush=True)
                break
    wall = time.time() - t0
    steps_run = steps - start_step
    n_skipped = int(torch.stack(skip_counters).sum()) if skip_counters else 0
    print(f"skipped steps (non-finite grads): {n_skipped}", flush=True)
    print(f"training done: {steps_run} steps in {wall:.1f}s "
          f"({batch * steps_run / wall:.0f} rays/s incl. build)", flush=True)

    scores = system.validate(save_images=False)
    rec = {"tag": tag, "steps": steps, "geometry": geometry,
           "n_train": args.n_train, "img_size": args.img_size,
           "wall_s": wall, "steps_run": steps_run,
           "rays_per_s_incl_build": batch * steps_run / wall,
           "psnr": scores["psnr"], "ssim": scores["ssim"],
           "n_skipped": n_skipped,
           "final_loss_finite": math.isfinite(loss),
           "layout_log": system.layout_log,
           "card": _card() if system.dev.type == "cuda" else "cpu"}
    print(json.dumps(rec), flush=True)
    out = os.path.join(RECORD_DIR, f"full_run_{tag}.json")
    with open(out, "w") as f:
        json.dump(rec, f)
    print(f"-> {out}", flush=True)
    return rec


if __name__ == "__main__":
    main()
