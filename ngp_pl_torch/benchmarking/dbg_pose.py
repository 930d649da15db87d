"""The pose-refinement gradients (dR, dT) through one strided train render
on a 4-image toy: the counterpart of benchmarking/dbg_pose.py.

    python -m ngp_pl_torch.benchmarking.dbg_pose [--n_samples 8]
        [--device cuda]

The JAX script's toy: an L=4, F=2, T=2^12 field at scale 0.5 on a 32^3
grid with every cell occupied, seed 0 (the JAX script's parameters come
from PRNGKey(0); `run` takes a model); 4 cameras at the origin's -2 z
with identity rotation, 256 directions around +z, a batch of 32 rays and
targets, all from numpy's `default_rng(0)` in the JAX script's order.  The
rays come through the zero corrections dR, dT of their images
(`train_step.apply_pose_refinement`), render with no march noise on white
in the strided layout (`render_rays_train`, S = `--n_samples`, chain 64,
max_samples 64 on the grid), and the loss is `nerf_loss` (opacity 1e-3,
no distortion) summed by `total_loss`.  The field takes the position
gradient (the x-grad encode and the PyTorch tail, no hand kernel, as in
the JAX package).  Prints the JAX script's two lines, then a JSON line
with both maxima and the rays in the loss.

At the JAX script's S=8 both gradients read 0, in the JAX package as
here: every ray of the toy marches 28-47 occupied samples, more than S,
and the strided render leaves such a ray out of the loss (`loss_mask`), so
no ray is in it.  At S=64 every ray is.  The port rounds as jitted JAX
does (`mlp_apply`); the JAX script takes its gradient eagerly, which
rounds the second sigma layer's output to bf16, and moves dT by ~4e-2 of
its max (tests/test_torch_train_diag.py).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N_IMAGES, N_PIX, B = 4, 256, 32


def config():
    from ngp_pl_torch.config import NGPConfig, RenderConfig

    return (NGPConfig(scale=0.5, n_levels=4, log2_hashmap_size=12,
                      grid_size=32),
            RenderConfig(max_samples=64, train_pool_mult=8))


def inputs():
    """(poses (4, 3, 4), directions (256, 3), img_idxs (32,), pix_idxs
    (32,), rgb_gt (32, 3)) as numpy arrays."""
    rng = np.random.default_rng(0)
    poses = np.zeros((N_IMAGES, 3, 4), np.float32)
    poses[:, :, :3] = np.eye(3)
    poses[:, 2, 3] = -2.0
    dirs = (rng.uniform(-0.2, 0.2, (N_PIX, 3))
            + np.array([0, 0, 1.0])).astype(np.float32)
    img = rng.integers(0, N_IMAGES, B)
    pix = rng.integers(0, N_PIX, B)
    rgb_gt = rng.random((B, 3)).astype(np.float32)
    return poses, dirs, img, pix, rgb_gt


def run(ngp, device="cuda", n_samples: int = 8) -> dict:
    """dR and dT gradients of the toy's loss for `ngp` (a model of
    `config()`'s field with the position gradient), S = `n_samples`."""
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models.rendering import render_rays_train
    from ngp_pl_torch.training.losses import nerf_loss, total_loss
    from ngp_pl_torch.training.train_step import apply_pose_refinement

    cfg, rcfg = config()
    poses, dirs, img, pix, rgb_gt = (torch.as_tensor(a).to(device)
                                     for a in inputs())
    occ = torch.ones((cfg.cascades, 32, 32, 32), dtype=torch.uint8,
                     device=device)
    pp = {k: torch.zeros((N_IMAGES, 3), device=device, requires_grad=True)
          for k in ("dR", "dT")}
    rays_o, rays_d = get_rays(dirs[pix],
                              apply_pose_refinement(poses[img], pp, img))
    out = render_rays_train(ngp, None, rays_o, rays_d,
                            torch.zeros(B, device=device),
                            torch.ones(3, device=device), rcfg=rcfg,
                            n_samples=n_samples, chain_length=64,
                            occ_grid=occ)
    loss = total_loss(nerf_loss(out, rgb_gt, lambda_opacity=1e-3,
                                lambda_distortion=0.0))
    g_r, g_t = torch.autograd.grad(loss, [pp["dR"], pp["dT"]])
    return {"dR": g_r, "dT": g_t,
            "dR_grad_max": float(g_r.abs().max()),
            "dT_grad_max": float(g_t.abs().max()),
            "loss": float(loss.detach()),
            "rays_in_loss": int(out["loss_mask"].sum())}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device
    from ngp_pl_torch.models.ngp import NGP

    ap = argparse.ArgumentParser()
    ap.add_argument("--n_samples", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(NGP(config()[0], seed=0, device=args.device,
                  need_x_grad=True), args.device, args.n_samples)
    print("dR grad max", rec["dR_grad_max"], flush=True)
    print("dT grad max", rec["dT_grad_max"], flush=True)
    out = {k: rec[k] for k in ("dR_grad_max", "dT_grad_max", "loss",
                               "rays_in_loss")}
    print(json.dumps({**out, "card": card_line(args.device)}), flush=True)
    return rec


if __name__ == "__main__":
    main()
