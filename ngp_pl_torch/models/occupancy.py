"""Occupancy ("density") grid for rendering (counterpart of
ngp_pl_tpu/models/occupancy.py, reference models/networks.py:155-269).

The grid is plain row-major (x, y, z) with one uint8 per cell.  The TPU's
packed forms (bit lines, dilated lines, 8^3 windows) are not kept: the
port's marcher reads the uint8 grid directly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ngp_pl_torch.config import NEAR_DISTANCE, NGPConfig
from ngp_pl_torch.ops.ray_march import f32_const

DENSITY_DECAY = 0.95          # EMA decay (reference train.py:58-59)
_CELL_CHUNK = 2 ** 16         # cells per projection pass in mark_invisible
_DENSITY_CHUNK = 2 ** 18      # cells per density query in the refresh


@dataclass
class OccupancyGridState:
    density_grid: torch.Tensor   # (C, G^3) f32; -1 = permanently invisible
    count_grid: torch.Tensor     # (C, G^3) f32 camera-coverage fraction
    occ_grid: torch.Tensor       # (C, G, G, G) uint8, the marcher's input
    mean_density: torch.Tensor   # () f32


def init_grid_state(cfg: NGPConfig, device) -> OccupancyGridState:
    C, G = cfg.cascades, cfg.grid_size
    z = torch.zeros((C, G ** 3), dtype=torch.float32, device=device)
    return OccupancyGridState(
        density_grid=z, count_grid=z.clone(),
        occ_grid=torch.zeros((C, G, G, G), dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device))


def _coords_from_flat(idx: torch.Tensor, G: int) -> torch.Tensor:
    return torch.stack([idx // (G * G), (idx // G) % G, idx % G], dim=-1)


def _cascade_world_pos(coords: torch.Tensor, c: int, cfg: NGPConfig):
    """Cell-centre world positions of cascade c (networks.py:251-253).
    Returns (pos (M, 3) f32, half cell size)."""
    s = min(2.0 ** (c - 1), cfg.scale)
    half = s / cfg.grid_size
    pos = (coords.to(torch.float32) / f32_const(cfg.grid_size - 1, coords)
           * 2.0 - 1.0) * (s - half)
    return pos, half


@torch.no_grad()
def mark_invisible_cells(state: OccupancyGridState, K, poses, *,
                         cfg: NGPConfig, img_w: int,
                         img_h: int) -> OccupancyGridState:
    """Project every cell into every camera (networks.py:197-238): cells no
    camera sees get density -1 for good; count_grid keeps the coverage."""
    dev = state.density_grid.device
    G, C = cfg.grid_size, cfg.cascades
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_cams = poses.shape[0]
    w2c_R = poses[:, :3, :3].transpose(1, 2)                  # (N, 3, 3)
    w2c_T = -torch.einsum("nij,nj->ni", w2c_R, poses[:, :3, 3])
    KR = torch.einsum("ij,njk->nik", K, w2c_R)
    KT = torch.einsum("ij,nj->ni", K, w2c_T)

    density = state.density_grid.clone()
    count = state.count_grid.clone()
    idx = torch.arange(G ** 3, device=dev)
    for c in range(C):
        for i in range(0, G ** 3, _CELL_CHUNK):
            j = i + _CELL_CHUNK
            pos, _ = _cascade_world_pos(_coords_from_flat(idx[i:j], G), c,
                                        cfg)
            uvd = torch.einsum("nij,mj->nmi", KR, pos) + KT[:, None, :]
            z = uvd[..., 2]
            uv = uvd[..., :2] / torch.where(z.abs()[..., None] > 1e-10,
                                            z[..., None], 1e-10)
            in_image = ((z >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                        & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
            covered = (z >= NEAR_DISTANCE) & in_image
            too_near = (z < NEAR_DISTANCE) & in_image
            cnt = covered.sum(dim=0).to(torch.float32) / n_cams
            valid = (cnt > 0) & ~too_near.any(dim=0)
            count[c, i:j] = cnt
            density[c, i:j] = torch.where(valid, 0.0, -1.0)
    return replace(state, density_grid=density, count_grid=count)


@torch.no_grad()
def update_density_grid(ngp, state: OccupancyGridState, density_threshold,
                        *, noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> OccupancyGridState:
    """The warmup EMA refresh of every cell (networks.py:240-269), as a
    fresh training system runs it first.  `noise` is the U(-1, 1) cell
    jitter, (C, G^3, 3); when None it is drawn from `generator`.  Non-finite
    densities are sanitised (NaN -> 0, +inf -> 1e10) before the EMA, and the
    occupancy threshold is min(mean density, density_threshold).  The
    sublattice refresh and erosion of training are a later slice."""
    cfg = ngp.cfg
    dev = state.density_grid.device
    G, C = cfg.grid_size, cfg.cascades
    coords = _coords_from_flat(torch.arange(G ** 3, device=dev), G)
    tmp = []
    for c in range(C):
        pos, half = _cascade_world_pos(coords, c, cfg)
        if noise is None:
            jitter = torch.rand(pos.shape, generator=generator) * 2.0 - 1.0
        else:
            jitter = torch.as_tensor(noise[c], dtype=torch.float32)
        pos = pos + jitter.to(dev) * half
        sigma = torch.cat([ngp.density(pos[i:i + _DENSITY_CHUNK])
                           for i in range(0, pos.shape[0], _DENSITY_CHUNK)])
        tmp.append(torch.nan_to_num(sigma, nan=0.0, posinf=1e10, neginf=0.0))
    tmp = torch.stack(tmp)

    grid = state.density_grid
    new_grid = torch.where(grid < 0, grid,
                           torch.maximum(grid * DENSITY_DECAY, tmp))
    pos_mask = new_grid > 0
    mean_density = (torch.where(pos_mask, new_grid, 0.0).sum()
                    / torch.clamp_min(pos_mask.sum(), 1))
    thr = torch.clamp_max(mean_density, float(density_threshold))
    occ = (new_grid > thr).to(torch.uint8).reshape(C, G, G, G)
    return OccupancyGridState(density_grid=new_grid,
                              count_grid=state.count_grid, occ_grid=occ,
                              mean_density=mean_density)
