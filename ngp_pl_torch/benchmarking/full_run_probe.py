"""The quality protocol of `full_run` with a reading every 1024 steps, to
see where a run parts from the JAX package's log
(benchmarking/full_run_n32.log).

    python -m ngp_pl_torch.benchmarking.full_run_probe --steps 30000 \\
        --n_train 32 --img_size 128 [--seed 1337] [--score_every 2048]

The same system, scene and blocks as `full_run` (no resume file, no
record).  Every 1024 steps one JSON line: the block's loss and rm_s, the
layout, budget and chain, the march's chain demand (max and q99 per-ray
need) against the chain, the grid's occupied share, mean density and the
threshold it sets, the largest density and |table|; every
`--score_every` steps also the PSNR/SSIM of the 2 test views and of train
view 0 (no images written).  With `--plain` every hand kernel runs as its
plain PyTorch version on the card (no launch counted), which tells the
kernels' numerics apart from the program's.  Runs on the card unless
`--device cpu`.

`--save_at STEP` (repeatable) writes the state at STEP as a transfer file
`state_<STEP>.npz` into `--save_dir`, and `--from_state FILE` starts a run
from one (after the grid's marking, which would reset the density EMA);
`--log_every 16` logs every block; `--protocol_steps 30000` keeps the
30k protocol's lr schedule (30 epochs of 1000 steps) in a run that stops
earlier, as `--steps` alone sets the schedule by its own length.  A
transfer file is a full checkpoint in the JAX package's keys cut to fit
64 MiB: the hash table as float16 (the values the encode reads), its
Adam second moment as bfloat16 bits, its first moment left out (zero on
load), the packed grid rows left out (rebuilt from `grid.occ_grid` on
load); every other leaf exact.  The run that saves goes on from its own
unrounded state; a run from the file starts from the rounded one, as
`benchmarking/full_run_from_state.py` does in the JAX package.
`--host_draws` takes every batch, march jitter and refresh jitter from one
CPU generator of the seed, so that a run on the card and one on the CPU
train on the same draws.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ngp_pl_torch.benchmarking.full_run import make_system, run_config
from ngp_pl_torch.benchmarking.plain import ALL, plain_versions


def _view_psnr(system, ds, idx):
    """PSNR of view idx of `ds` through the system's round renderer."""
    from ngp_pl_torch.training.metrics import psnr

    w, h = ds.img_wh
    out = system.renderer().render_pose(
        system.grid_state.occ_grid,
        torch.from_numpy(ds.directions).to(system.dev),
        torch.from_numpy(ds.poses[idx]).to(system.dev))
    gt = ds.image(idx).reshape(h, w, 3)
    return float(psnr(out["rgb"].reshape(h, w, 3), gt))


TABLE = "params['hash_table']"
TABLE_MU = "opt[0].mu['hash_table']"
TABLE_NU = "opt[0].nu['hash_table']"
GRID_ROWS = ("grid.occ_rows", "grid.dil_rows", "grid.win_rows")


def save_state(system, path: str):
    """The system's state as a transfer file (see the module note)."""
    from ngp_pl_torch.training.checkpoint import _full_arrays

    st = system._state_numpy()
    data = _full_arrays(st["params"], st["mu"], st["nu"], st["count"],
                        st["grid"])
    data["__step__"] = np.asarray(system._host_step)
    for k in GRID_ROWS + (TABLE_MU,):
        del data[k]
    data[TABLE] = data[TABLE].astype(np.float16)
    data[TABLE_NU] = torch.from_numpy(data[TABLE_NU]).bfloat16().view(
        torch.int16).numpy().view(np.uint16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **data)


def load_state(system, path: str):
    """Load a transfer file into the system: the table and its moments
    widened to float32 (the first moment zero), the grid rows rebuilt."""
    from ngp_pl_torch.models.occupancy import grid_rows

    with np.load(path, allow_pickle=False) as f:
        data = dict(f)
    data[TABLE] = data[TABLE].astype(np.float32)
    data[TABLE_NU] = (data[TABLE_NU].astype(np.uint32) << 16).view(
        np.float32)
    data[TABLE_MU] = np.zeros_like(data[TABLE])
    rows = grid_rows(torch.from_numpy(data["grid.occ_grid"]))
    for k, r in zip(GRID_ROWS, rows):
        data[k] = r.numpy().view(np.uint32)
    with tempfile.TemporaryDirectory() as d:
        full = os.path.join(d, "state.npz")
        np.savez(full, **data)
        system.load(full)


def host_draws(system, seed: int):
    """Draw the batches (all images), the march jitter and the refresh
    jitter of `system` from one CPU generator of `seed` and move them to
    its device."""
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models.occupancy import update_density_grid
    from ngp_pl_torch.training.train_step import train_step

    g = torch.Generator().manual_seed(seed)
    dev, tcfg = system.dev, system.tcfg
    B, nb = tcfg.batch_size, tcfg.grid_update_interval
    n_img, n_pix = system.rays.shape[:2]
    if tcfg.ray_sampling_strategy != "all_images":
        raise ValueError("--host_draws draws from all images")

    def step():
        img = torch.randint(0, n_img, (B,), generator=g).to(dev)
        pix = torch.randint(0, n_pix, (B,), generator=g).to(dev)
        noise = torch.rand(B, generator=g).to(dev)
        rays_o, rays_d = get_rays(system.directions[pix], system.poses[img])
        gs = system.grid_state
        return train_step(
            system.ngp, system.optimizer,
            gs.win_rows if system.window_march else None,
            rays_o.contiguous(), rays_d.contiguous(), system.rays[img, pix],
            noise, system.background(), tcfg=tcfg, rcfg=system.rcfg,
            n_samples=system._pool_mult, chain_length=system.step_chain(),
            layout=system.layout, occ_grid=gs.occ_grid)

    def refresh(step_i):
        cfg = system.cfg
        warm = step_i < tcfg.grid_warmup_steps
        M = cfg.grid_size ** 3 // (1 if warm else 4)
        noise = torch.rand((cfg.cascades, M, 3), generator=g) * 2.0 - 1.0
        system.grid_state = update_density_grid(
            system.ngp, system.grid_state, system.density_threshold,
            warmup=warm, erode=system.erode, phase=(step_i // nb) % 4,
            noise=noise.to(dev))

    system._train_step = step
    system._refresh_grid = refresh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--protocol_steps", type=int, default=0,
                    help="the run whose lr schedule to follow (--steps)")
    ap.add_argument("--geometry", type=str, default="L8F4",
                    choices=["L8F4", "L16F2"])
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--score_every", type=int, default=2048)
    ap.add_argument("--plain", action="store_true",
                    help="the kernels' plain PyTorch versions on the card")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--log_every", type=int, default=1024)
    ap.add_argument("--save_at", type=int, action="append", default=[],
                    help="write the state at this step (repeatable)")
    ap.add_argument("--save_dir", type=str,
                    default=os.path.join("ckpts", "synthetic",
                                         "full_run_probe"))
    ap.add_argument("--from_state", type=str, default="",
                    help="a transfer file written by --save_at")
    ap.add_argument("--host_draws", action="store_true",
                    help="draws from a CPU generator, the same on any "
                         "device")
    args = ap.parse_args(argv)
    with plain_versions(*ALL) if args.plain else contextlib.nullcontext():
        _probe(args)


def _probe(args):
    tcfg, _, _ = run_config(args.protocol_steps or args.steps, args.geometry,
                            False)
    tcfg = tcfg.replace(seed=args.seed, exp_name="full_run_probe")
    system = make_system(tcfg, args.img_size, args.n_train, args.device)
    system.on_train_start()
    nb, batch = tcfg.grid_update_interval, tcfg.batch_size
    if args.host_draws:
        host_draws(system, args.seed)
    if args.from_state:
        load_state(system, args.from_state)
        print(json.dumps({"step": system._host_step, "plain": args.plain,
                          "from_state": args.from_state,
                          **_grid_fields(system), **_scores(system)}),
              flush=True)
    t0 = time.time()
    for i in range(system._host_step // nb, args.steps // nb):
        m = system.step_block()
        step = (i + 1) * nb
        if step in args.save_at:
            save_state(system, os.path.join(args.save_dir,
                                            f"state_{step}.npz"))
        if step % args.log_every and step != args.steps:
            continue
        dv = m["demand_vec"].float().cpu()
        rec = {"step": step, "plain": args.plain, "loss": float(m["loss"]),
               "rm_s": float(m["rm_samples"]) / batch,
               "layout": system.layout, "S": system._pool_mult,
               "chain": system.step_chain(),
               "chain_demand": float(dv[1]), "chain_demand_q": float(dv[2]),
               **_grid_fields(system), "t": time.time() - t0}
        if step % args.score_every == 0 or step == args.steps:
            rec.update(_scores(system))
        print(json.dumps(rec), flush=True)


def _grid_fields(system):
    gs = system.grid_state
    return {"occupied": float(gs.occ_grid.float().mean()),
            "mean_density": float(gs.mean_density),
            "threshold": min(float(gs.mean_density),
                             system.density_threshold),
            "density_max": float(gs.density_grid.max()),
            "tbl_absmax": float(system.ngp.hash_table.detach().abs().max())}


def _scores(system):
    scores = system.validate(save_images=False)
    return {"test_psnr": scores["psnr"], "test_ssim": scores["ssim"],
            "train_view0_psnr": _view_psnr(system, system.train_dataset, 0)}


if __name__ == "__main__":
    main()
