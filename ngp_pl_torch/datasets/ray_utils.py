"""Ray generation (counterpart of ngp_pl_tpu/datasets/ray_utils.py:15-59,
reference datasets/ray_utils.py)."""
from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(H, W, K) -> np.ndarray:
    """(H*W, 3) float32 ray directions through the pixel centres, in the
    camera frame [right down front]."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    directions = np.stack(
        [(u - cx + 0.5) / fx, (v - cy + 0.5) / fy, np.ones_like(u)], axis=-1
    ).astype(np.float32)
    return directions.reshape(-1, 3)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame directions (N, 3) + one (3, 4) c2w pose, or one pose
    per ray (N, 3, 4) -> world rays (rays_o (N, 3), rays_d (N, 3)); rays_d
    is not normalized."""
    if c2w.dim() == 3:
        rays_d = torch.einsum("nij,nj->ni", c2w[:, :, :3], directions)
        return c2w[:, :, 3], rays_d
    rays_d = directions @ c2w[:, :3].T
    return c2w[:, 3].expand(rays_d.shape), rays_d
