"""Ray generation and the pose correction's rotation (counterpart of
ngp_pl_tpu/datasets/ray_utils.py:15-90, reference datasets/ray_utils.py).
Both are differentiable: with pose refinement the gradient flows through
`get_rays` into the per-ray poses."""
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


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b as XLA's CPU dot computes a short
    contraction: the first product, then one fused multiply-add per term in
    order (each computed in float64, where the product is exact, and
    rounded once).  Differentiable."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = (a[..., k].double() * b[..., k].double()
               + acc.double()).float()
    return acc


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame directions (N, 3) + one (3, 4) c2w pose, or one pose
    per ray (N, 3, 4) -> world rays (rays_o (N, 3), rays_d (N, 3)); rays_d
    is not normalized.  The rotation's sums are XLA's (`_dot3`), so the
    rays are the JAX package's bit for bit."""
    if c2w.dim() == 3:
        rays_d = _dot3(c2w[:, :, :3], directions[:, None, :])
        return c2w[:, :, 3], rays_d
    rays_d = _dot3(c2w[None, :, :3], directions[:, None, :])
    return c2w[:, 3].expand(rays_d.shape), rays_d


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (B, 3, 3) @ (B, 3, 3) with `_dot3`'s sums."""
    return _dot3(a[:, :, None, :], b.transpose(1, 2)[:, None, :, :])


def axisangle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 3) -> rotation matrices (B, 3, 3) by Rodrigues'
    formula, differentiable (ngp_pl_tpu/datasets/ray_utils.py:62-90).  The
    norm is sqrt(v.v + 1e-14): pose refinement starts at v = 0, where the
    plain norm's gradient is 0/0."""
    squeeze = v.dim() == 1
    if squeeze:
        v = v[None]
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], dim=1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], dim=1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], dim=1),
    ], dim=1)
    theta = torch.sqrt(_dot3(v, v) + 1e-14)[:, None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)[None]
    R = (eye + torch.sin(theta) / theta * skew
         + (1 - torch.cos(theta)) / theta ** 2 * matmul3(skew, skew))
    return R[0] if squeeze else R
