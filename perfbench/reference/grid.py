"""Plain checks of the occupancy grid's first refresh (ngp_pl
`models/networks.py:197-269`), the stage the train reference takes from the
program: the cells no train camera sees (density -1 for good) worked out
again from the cameras; the positions the refresh sampled, each within the
cell it stands for (its centre jittered by at most half a cell); the
density there worked out again by the reference field from the
benchmark's weights; and the occupied cells from the refreshed densities
and their mean.  Nothing here imports the program."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from perfbench.reference import field as rf

NEAR_DISTANCE = 0.01
MAX_SAMPLES = 1024


def invisible(K, poses, img_w: int, img_h: int, grid_size: int,
              scale: float, dev, chunk: int = 1 << 16) -> torch.Tensor:
    """(G^3,) bool: the cells whose centre no camera sees in front of its
    near plane, or that lie within it of some camera's image."""
    G = grid_size
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    R = poses[:, :3, :3].transpose(1, 2)
    T = -torch.einsum("nij,nj->ni", R, poses[:, :3, 3])
    KR = torch.einsum("ij,njk->nik", K, R)
    KT = torch.einsum("ij,nj->ni", K, T)
    half = scale / G
    out = torch.empty(G ** 3, dtype=torch.bool, device=dev)
    idx = torch.arange(G ** 3, device=dev)
    for a in range(0, G ** 3, chunk):
        i = idx[a:a + chunk]
        c = torch.stack([i // (G * G), (i // G) % G, i % G], dim=-1)
        pos = (c.to(torch.float32) / (G - 1) * 2.0 - 1.0) * (scale - half)
        uvd = torch.einsum("nij,mj->nmi", KR, pos) + KT[:, None, :]
        z = uvd[..., 2]
        uv = uvd[..., :2] / torch.where(z.abs()[..., None] > 1e-10,
                                        z[..., None], 1e-10)
        inside = ((z >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
        seen = ((z >= NEAR_DISTANCE) & inside).any(dim=0)
        too_near = ((z < NEAR_DISTANCE) & inside).any(dim=0)
        out[a:a + chunk] = ~seen | too_near
    return out


def occupied(density: torch.Tensor, mean_density: float) -> torch.Tensor:
    """Cells whose density is above min(mean, 0.01 * 1024 / sqrt(3))."""
    thr = min(float(mean_density), 0.01 * MAX_SAMPLES / 3.0 ** 0.5)
    return density > thr


def centres(grid_size: int, scale: float, dev):
    """(G^3, 3) cell centres in flat (x, y, z) order, and half a cell."""
    G = grid_size
    half = scale / G
    i = torch.arange(G ** 3, device=dev)
    c = torch.stack([i // (G * G), (i // G) % G, i % G], dim=-1)
    return (c.to(torch.float32) / (G - 1) * 2.0 - 1.0) * (scale - half), half


def outside_cells(pos: torch.Tensor, grid_size: int, scale: float) -> float:
    """The share of the refresh's positions (one a cell, in flat order)
    that lie farther than half a cell from their cell's centre on some
    axis; 1 where there is not one a cell."""
    if pos.shape != (grid_size ** 3, 3):
        return 1.0
    c, half = centres(grid_size, scale, pos.device)
    off = ((pos - c).abs() > half * (1.0 + 1e-4)).any(dim=-1)
    return float(off.float().mean())


@torch.no_grad()
def density(params: Dict, pos: torch.Tensor, model: Dict,
            quant: Optional[Callable] = None,
            chunk: int = 1 << 18) -> torch.Tensor:
    """The reference field's density (N,) at world positions pos (N, 3)."""
    g = rf.grid(model)
    return torch.cat([torch.exp(rf.geometry(params, pos[a:a + chunk], g,
                                            model["scale"], quant)[:, 0])
                      for a in range(0, pos.shape[0], chunk)])


def density_gap(got: torch.Tensor, want: torch.Tensor,
                invisible: torch.Tensor) -> float:
    """Over the visible cells, the summed absolute gap of the densities
    `got` from `want` over the summed `want`."""
    vis = ~invisible
    if got.shape != want.shape:
        return float("inf")
    return float((got[vis] - want[vis]).abs().sum()
                 / want[vis].abs().sum().clamp_min(1e-30))
