"""Plain float32 training steps of ngp_pl's NeRF (ngp_pl `train.py:159-185`,
`losses.py:41-60`): rays of a batch, the train march into the sample pool,
the field, the compositor on the white background, the rgb MSE plus the
opacity entropy (weight 1e-3), the gradient by autograd, and Adam (b1 0.9,
b2 0.999, eps 1e-15, bias-corrected, ngp_pl's per-epoch cosine lr).

A data-parallel step takes one shard per rank, each with its own pool, and
the mean of the shards' losses: its gradient is the ranks' averaged
gradient.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import field as rf
from perfbench.reference import march as rm

OPACITY_W = 1e-3
T_THRESHOLD_TRAIN = 1e-4
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15
LR_FINAL_DIV = 30.0


def cosine_lr(lr: float, num_epochs: int, iters_per_epoch: int,
              step: int) -> float:
    """ngp_pl's lr at `step`: cosine over epochs from lr to lr / 30, each
    epoch one value, in float32."""
    f = np.float32
    eta_min = lr / LR_FINAL_DIV
    epoch = min(step // iters_per_epoch, num_epochs)
    cos = np.cos(f(math.pi) * f(epoch) / f(num_epochs))
    return float(f(eta_min) + f(0.5 * (lr - eta_min)) * (f(1.0) + cos))


def rays(directions, poses, img, pix):
    """World rays (o, d) of pixels `pix` of views `img`."""
    c2w = poses[img]
    d = (directions[pix][:, None, :] * c2w[:, :, :3]).sum(dim=-1)
    return c2w[:, :, 3], d


def shard_loss(params: Dict, shard: Dict, g: rf.Grid, model: Dict,
               quant: Optional[Callable] = None):
    """The loss of one rank's rays and their colours: `shard` holds rays_o,
    rays_d, target, noise and the step's occupancy grid, chain and pool
    multiple."""
    o, d = shard["rays_o"], shard["rays_d"]
    N = o.shape[0]
    pool = rm.train_pool(o, d, shard["noise"], shard["occ_grid"],
                         scale=model["scale"], chain=shard["chain"],
                         pool_mult=shard["pool_mult"])
    valid = pool["valid"]
    sel = torch.nonzero(valid).squeeze(1)
    ray = pool["ray"][sel]
    xyz = rm.positions(pool["t"][sel][:, None], o[ray], d[ray])[:, 0]
    s, c = rf.field(params, xyz, d[ray], g, model["scale"], quant)
    P = valid.shape[0]
    sigma = torch.zeros(P, device=o.device).index_put((sel,), s)
    rgb = torch.zeros((P, 3), device=o.device).index_put((sel,), c)
    opacity, col = rm.composite_pool(sigma, rgb, pool, N, T_THRESHOLD_TRAIN)
    col = col + (1.0 - opacity[:, None])          # white background
    op = opacity + 1e-10
    return (((col - shard["target"]) ** 2).mean()
            + (OPACITY_W * (-op * torch.log(op))).mean()), col.detach()


class Adam:
    """Adam over a list of float32 leaves, ngp_pl's constants."""

    def __init__(self, leaves: List[torch.Tensor], lr_at: Callable):
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0
        self.lr_at = lr_at

    @torch.no_grad()
    def step(self, leaves, grads):
        lr = self.lr_at(self.count)
        self.count += 1
        f = np.float32
        bc1 = float(f(1.0) - f(ADAM_B1) ** f(self.count))
        bc2 = float(f(1.0) - f(ADAM_B2) ** f(self.count))
        for p, gr, m, v in zip(leaves, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * gr)
            v.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * gr * gr)
            p.add_((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) * (-lr))


def follow(params0: Dict, steps: List[List[Dict]], model: Dict,
           recipe: Dict, quant: Optional[Callable] = None) -> Dict:
    """Train float32 copies of `params0` through `steps` (each a list of
    rank shards).  Returns each step's loss, the first step's rays' colours
    (rank after rank) and gradient by leaf name, and the leaves after the
    last step."""
    g = rf.grid(model)
    params = {"hash_table": params0["hash_table"].detach().clone(),
              "sigma_mlp": [w.detach().clone()
                            for w in params0["sigma_mlp"]],
              "rgb_mlp": [w.detach().clone() for w in params0["rgb_mlp"]]}
    names, leaves = zip(*rf.leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    opt = Adam(list(leaves), lambda s: cosine_lr(
        recipe["lr"], recipe["num_epochs"], recipe["iters_per_epoch"], s))
    losses, first_grad, rgb = [], None, []
    for shards in steps:
        total = 0.0
        grads = [torch.zeros_like(p) for p in leaves]
        for shard in shards:
            loss, col = shard_loss(params, shard, g, model, quant)
            if first_grad is None:
                rgb.append(col)
            loss = loss / len(shards)
            gr = torch.autograd.grad(loss, leaves)
            for acc, x in zip(grads, gr):
                acc += x
            total += float(loss.detach())
            del loss, gr
        losses.append(total)
        if first_grad is None:
            first_grad = {n: x.clone() for n, x in zip(names, grads)}
        opt.step(leaves, grads)
    return {"losses": losses, "first_grad": first_grad,
            "rgb": torch.cat(rgb),
            "leaves": {n: p.detach() for n, p in zip(names, leaves)}}
