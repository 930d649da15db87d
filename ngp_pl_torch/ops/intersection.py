"""Ray / scene-box intersection (counterpart of ngp_pl_tpu/ops/intersection.py,
reference models/csrc/intersection.cu:5-55)."""
from __future__ import annotations

import torch


def ray_aabb_intersect_single(rays_o: torch.Tensor, rays_d: torch.Tensor,
                              center: torch.Tensor,
                              half_size: torch.Tensor) -> torch.Tensor:
    """Intersect rays with ONE box.  Returns hits_t (N, 2); rows of -1 mark
    a miss.  Near is clamped to 0; rows with t2 <= 0 or t1 > t2 miss."""
    inv_d = 1.0 / rays_d
    t_min = (center - half_size - rays_o) * inv_d
    t_max = (center + half_size - rays_o) * inv_d
    t1 = torch.minimum(t_min, t_max).amax(dim=-1)
    t2 = torch.maximum(t_min, t_max).amin(dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    near = torch.clamp_min(t1, 0.0)
    return torch.where(hit[:, None], torch.stack([near, t2], dim=-1),
                       torch.full_like(rays_o[:, :2], -1.0))
