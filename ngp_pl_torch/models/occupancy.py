"""Occupancy ("density") grid for rendering (counterpart of
ngp_pl_tpu/models/occupancy.py, reference models/networks.py:155-269).

The grid is plain row-major (x, y, z) with one uint8 per cell, read
directly by the test-time marcher; the train march reads the packed 8^3
windows (`win_rows`), rebuilt with every refresh.  The TPU's bit lines and
dilated lines fed marches the port does not have (the z-line and segment
marches), so the state does not keep them; `grid_rows` builds them for a
full checkpoint, which the JAX package loads.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ngp_pl_torch.config import NEAR_DISTANCE, NGPConfig
from ngp_pl_torch.ops.grid_ops import packbits
from ngp_pl_torch.ops.morton import morton3d
from ngp_pl_torch.ops.ray_march import (
    WIN_B,
    WIN_WORDS,
    dilate_lines,
    f32_const,
    occupancy_lines,
    occupancy_windows,
)

DENSITY_DECAY = 0.95          # EMA decay (reference train.py:58-59)
_CELL_CHUNK = 2 ** 16         # cells per projection pass in mark_invisible
_DENSITY_CHUNK = 2 ** 18      # cells per density query in the refresh


@dataclass
class OccupancyGridState:
    density_grid: torch.Tensor   # (C, G^3) f32; -1 = permanently invisible
    count_grid: torch.Tensor     # (C, G^3) f32 camera-coverage fraction
    occ_grid: torch.Tensor       # (C, G, G, G) uint8, the marcher's input
    mean_density: torch.Tensor   # () f32
    win_rows: Optional[torch.Tensor] = None   # (C*(G/4)^3, 16) int32


def grid_rows(occ_grid: torch.Tensor):
    """(occ_rows, dil_rows, win_rows): the bit-packed z-lines, their 3^3
    dilation and the 8^3 windows of the (C, G, G, G) grid, int32 words
    (ngp_pl_tpu/models/occupancy.py:52-59)."""
    C, G = occ_grid.shape[0], occ_grid.shape[1]
    rows = occupancy_lines(occ_grid)
    return rows, dilate_lines(rows, C, G), occupancy_windows(occ_grid)


def init_grid_state(cfg: NGPConfig, device) -> OccupancyGridState:
    C, G = cfg.cascades, cfg.grid_size
    z = torch.zeros((C, G ** 3), dtype=torch.float32, device=device)
    return OccupancyGridState(
        density_grid=z, count_grid=z.clone(),
        occ_grid=torch.zeros((C, G, G, G), dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        win_rows=torch.zeros((C * (G // WIN_B) ** 3, WIN_WORDS),
                             dtype=torch.int32, device=device))


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
                        *, warmup: bool = True, phase: int = 0,
                        erode: bool = False,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> OccupancyGridState:
    """One EMA refresh of the density grid (ngp_pl_tpu/models/occupancy.py
    155-254, reference networks.py:240-269).

    Warmup refreshes every cell; afterwards the sublattice of cells whose
    flat index is `phase` (mod 4), the others getting a fresh density of 0,
    so every cell decays and each is refreshed every 4 updates.  `noise` is
    the U(-1, 1) cell jitter, (C, M, 3) for the M refreshed cells; when None
    it is drawn from `generator` (on the generator's device).  Non-finite
    densities are sanitised (NaN -> 0, +inf -> 1e10) before the EMA;
    `erode` decays cells seen by few cameras faster (networks.py:258-260).
    The occupancy threshold is min(mean density, density_threshold); the
    uint8 grid and its packed windows are rebuilt."""
    cfg = ngp.cfg
    dev = state.density_grid.device
    G, C = cfg.grid_size, cfg.cascades
    n4 = G ** 3 // 4
    if warmup:
        idx = torch.arange(G ** 3, device=dev)
    else:
        idx = int(phase) + 4 * torch.arange(n4, device=dev)
    coords = _coords_from_flat(idx, G)
    tmp = []
    for c in range(C):
        pos, half = _cascade_world_pos(coords, c, cfg)
        if noise is None:
            gdev = generator.device if generator is not None else "cpu"
            jitter = (torch.rand(pos.shape, generator=generator, device=gdev)
                      * 2.0 - 1.0)
        else:
            jitter = torch.as_tensor(noise[c], dtype=torch.float32)
        pos = pos + jitter.to(dev) * half
        sigma = torch.cat([ngp.density(pos[i:i + _DENSITY_CHUNK])
                           for i in range(0, pos.shape[0], _DENSITY_CHUNK)])
        tmp.append(torch.nan_to_num(sigma, nan=0.0, posinf=1e10, neginf=0.0))
    tmp = torch.stack(tmp)
    if not warmup:
        full = torch.zeros((C, n4, 4), dtype=torch.float32, device=dev)
        full[:, :, int(phase)] = tmp
        tmp = full.reshape(C, G ** 3)

    grid = state.density_grid
    if erode:
        decay_t = torch.clamp(
            DENSITY_DECAY ** (1.0 / torch.clamp_min(state.count_grid, 1e-10)),
            0.1, DENSITY_DECAY)
    else:
        decay_t = DENSITY_DECAY
    new_grid = torch.where(grid < 0, grid, torch.maximum(grid * decay_t, tmp))
    pos_mask = new_grid > 0
    mean_density = (torch.where(pos_mask, new_grid, 0.0).sum()
                    / torch.clamp_min(pos_mask.sum(), 1))
    thr = torch.clamp_max(mean_density, float(density_threshold))
    occ = (new_grid > thr).to(torch.uint8).reshape(C, G, G, G)
    return OccupancyGridState(density_grid=new_grid,
                              count_grid=state.count_grid, occ_grid=occ,
                              mean_density=mean_density,
                              win_rows=occupancy_windows(occ))


def export_bitfield(state: OccupancyGridState, cfg: NGPConfig) -> torch.Tensor:
    """The occupancy grid as the reference stores it (networks.py:28-29):
    a uint8 bitfield of C * G^3 / 8 bytes, each cascade's cells in Morton
    order, the first cell in the lowest bit
    (ngp_pl_tpu/models/occupancy.py:257-272).  As JAX's scatter does, a
    cell whose code falls past G^3 (G not a power of two) is dropped."""
    G, C = cfg.grid_size, cfg.cascades
    dev = state.occ_grid.device
    m = morton3d(_coords_from_flat(torch.arange(G ** 3, device=dev), G))
    keep = m < G ** 3
    out = []
    for c in range(C):
        morton_occ = torch.zeros(G ** 3, dtype=torch.uint8, device=dev)
        morton_occ[m[keep]] = state.occ_grid[c].reshape(-1)[keep]
        out.append(packbits(morton_occ.to(torch.float32), 0.5))
    return torch.cat(out)
