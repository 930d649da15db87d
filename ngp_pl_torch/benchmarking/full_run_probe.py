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
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from ngp_pl_torch.benchmarking.full_run import make_system, run_config


def _view_psnr(system, ds, idx):
    """PSNR of view idx of `ds` through the system's round renderer."""
    from ngp_pl_torch.models.rendering import RoundRenderer
    from ngp_pl_torch.training.metrics import psnr

    w, h = ds.img_wh
    out = RoundRenderer(system.ngp, system.rcfg).render_pose(
        system.grid_state.occ_grid,
        torch.from_numpy(ds.directions).to(system.dev),
        torch.from_numpy(ds.poses[idx]).to(system.dev))
    gt = ds.image(idx).reshape(h, w, 3)
    return float(psnr(out["rgb"].reshape(h, w, 3), gt))


@contextlib.contextmanager
def plain_versions():
    """Within the block the encode, its table gradient, the field tail and
    its backward run their plain versions, on any device."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    swaps = [(he, "hash_encode_fwd_cuda", he.hash_encode_fwd_plain),
             (he, "hash_encode_fwd_f2_cuda", he.hash_encode_fwd_plain),
             (he, "hash_encode_bwd_cuda", he.hash_encode_bwd_plain),
             (he, "hash_encode_bwd_f2_cuda", he.hash_encode_bwd_plain),
             (ft, "field_tail_cuda", ft.field_tail_plain),
             (ft, "field_tail_bwd_cuda", ft.field_tail_bwd_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--geometry", type=str, default="L8F4",
                    choices=["L8F4", "L16F2"])
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--score_every", type=int, default=2048)
    ap.add_argument("--plain", action="store_true",
                    help="the kernels' plain PyTorch versions on the card")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    with plain_versions() if args.plain else contextlib.nullcontext():
        _probe(args)


def _probe(args):
    tcfg, _, _ = run_config(args.steps, args.geometry, False)
    tcfg = tcfg.replace(seed=args.seed, exp_name="full_run_probe")
    system = make_system(tcfg, args.img_size, args.n_train, args.device)
    system.on_train_start()
    nb, batch = tcfg.grid_update_interval, tcfg.batch_size
    t0 = time.time()
    for i in range(args.steps // nb):
        m = system.step_block()
        step = (i + 1) * nb
        if step % 1024 and step != args.steps:
            continue
        gs = system.grid_state
        dv = m["demand_vec"].float().cpu()
        rec = {"step": step, "plain": args.plain, "loss": float(m["loss"]),
               "rm_s": float(m["rm_samples"]) / batch,
               "layout": system.layout, "S": system._pool_mult,
               "chain": system.step_chain(),
               "chain_demand": float(dv[1]), "chain_demand_q": float(dv[2]),
               "occupied": float(gs.occ_grid.float().mean()),
               "mean_density": float(gs.mean_density),
               "threshold": min(float(gs.mean_density),
                                system.density_threshold),
               "density_max": float(gs.density_grid.max()),
               "tbl_absmax": float(system.ngp.hash_table.detach().abs().max()),
               "t": time.time() - t0}
        if step % args.score_every == 0 or step == args.steps:
            scores = system.validate(save_images=False)
            rec.update(test_psnr=scores["psnr"], test_ssim=scores["ssim"],
                       train_view0_psnr=_view_psnr(
                           system, system.train_dataset, 0))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
