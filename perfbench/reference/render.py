"""Plain float32 render of one frame of ngp_pl's NeRF at test time
(`models/rendering.py:46-118`): every ray steps from its box entry at
dt_min through the occupied cells, front to back, and a sample counts while
the transmittance before it is above the threshold; white background.
Samples go through the field `per_round` at a time a ray, rays whose
transmittance fell to the threshold or whose occupied steps ran out
dropping out.  Nothing here imports the program."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from perfbench.reference import field as rf
from perfbench.reference import march as rm


@torch.no_grad()
def frame(params: Dict, occ_grid: torch.Tensor, directions: torch.Tensor,
          pose: torch.Tensor, model: Dict, t_threshold: float,
          quant: Optional[Callable] = None, rays_at_once: int = 1 << 15,
          per_round: int = 32) -> torch.Tensor:
    """rgb (H*W, 3) of the camera `pose` (3, 4) with camera-frame
    `directions` (H*W, 3)."""
    g = rf.grid(model)
    scale = model["scale"]
    d_all = directions @ pose[:, :3].T
    out = torch.empty_like(d_all)
    for a in range(0, d_all.shape[0], rays_at_once):
        d = d_all[a:a + rays_at_once]
        o = pose[:, 3].expand(d.shape[0], 3)
        R = d.shape[0]
        T = torch.ones(R, device=d.device)
        rgb = torch.zeros((R, 3), device=d.device)
        opacity = torch.zeros(R, device=d.device)
        nxt = torch.zeros(R, dtype=torch.int64, device=d.device)
        alive = torch.ones(R, dtype=torch.bool, device=d.device)
        while bool(alive.any()):
            idx = torch.nonzero(alive).squeeze(1)
            t, valid, nxt_i = rm.test_samples(
                o[idx], d[idx], occ_grid, scale=scale, start=nxt[idx],
                n=per_round)
            sel = torch.nonzero(valid, as_tuple=True)
            sigma = torch.zeros(t.shape, device=d.device)
            col = torch.zeros(t.shape + (3,), device=d.device)
            if sel[0].numel():
                xyz = rm.positions(t[sel][:, None], o[idx][sel[0]],
                                   d[idx][sel[0]])[:, 0]
                s, c = rf.field(params, xyz, d[idx][sel[0]], g, scale, quant)
                sigma[sel], col[sel] = s, c
            sd = torch.where(valid, torch.clamp_max(sigma * rm.dt_min(),
                                                    rm.SD_CLAMP), 0.0)
            excl = torch.cumsum(sd, dim=1) - sd
            Ti = T[idx][:, None] * torch.exp(-excl)
            w = torch.where(valid & (Ti > t_threshold),
                            (1.0 - torch.exp(-sd)) * Ti, 0.0)
            rgb[idx] += (w[..., None] * col).sum(dim=1)
            opacity[idx] += w.sum(dim=1)
            T_end = T[idx] * torch.exp(-sd.sum(dim=1))
            T[idx] = T_end
            nxt[idx] = nxt_i
            alive[idx] = ((T_end > t_threshold)
                          & (nxt_i <= rm.MAX_SAMPLES)
                          & valid[:, -1])
        out[a:a + R] = rgb + (1.0 - opacity[:, None])
    return out
