"""Ray generation and pose math (counterpart of
ngp_pl_tpu/datasets/ray_utils.py, reference datasets/ray_utils.py).

`get_ray_directions`, `average_poses`, `center_poses` and
`create_spheric_poses` run once on the host when a dataset loads, in numpy
with the JAX package's dtypes step by step (`center_poses` multiplies
float32 poses by a float64 inverse, as there).  `get_rays` and
`axisangle_to_R` are torch and differentiable: with pose refinement the
gradient flows through `get_rays` into the per-ray poses."""
from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(H, W, K, random=False, return_uv=False, flatten=True,
                       rng=None):
    """Ray directions in the camera frame [right down front]
    (ray_utils.py:15-43): (H*W, 3) float32 through the pixel centres, or
    (H, W, 3) unless `flatten`; `random` jitters each uniformly inside its
    pixel with `rng` (a numpy Generator); `return_uv` also returns the
    pixel coordinates."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        rng = rng or np.random.default_rng()
        du = rng.random(u.shape, dtype=np.float32)
        dv = rng.random(v.shape, dtype=np.float32)
    else:
        du = dv = 0.5
    directions = np.stack(
        [(u - cx + du) / fx, (v - cy + dv) / fy, np.ones_like(u)], axis=-1
    ).astype(np.float32)
    uv = np.stack([u, v], axis=-1)
    if flatten:
        directions = directions.reshape(-1, 3)
        uv = uv.reshape(-1, 2)
    if return_uv:
        return directions, uv
    return directions


def _normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses, pts3d=None):
    """The average c2w pose that centring inverts (ray_utils.py:96-103):
    centre at the points' (or the cameras') mean, z the mean front axis."""
    center = pts3d.mean(0) if pts3d is not None else poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], axis=1)  # (3, 4)


def center_poses(poses, pts3d=None):
    """All poses (and points) in the frame of the inverse average pose
    (ray_utils.py:106-119)."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_h = np.eye(4)
    pose_avg_h[:3] = pose_avg
    inv = np.linalg.inv(pose_avg_h)
    last = np.tile([0, 0, 0, 1.0], (len(poses), 1, 1))
    poses_h = np.concatenate([poses, last], axis=1)
    centered = (inv @ poses_h)[:, :3]
    if pts3d is not None:
        pts3d_c = pts3d @ inv[:3, :3].T + inv[:3, 3]
        return centered, pts3d_c
    return centered


def create_spheric_poses(radius, mean_h, n_poses=120):
    """A circular camera path around +z at height 2 * mean_h
    (ray_utils.py:122-139), float32 (n_poses, 3, 4)."""

    def pose(theta, phi, r):
        trans = np.array([[1, 0, 0, 0], [0, 1, 0, 2 * mean_h], [0, 0, 1, -r]],
                         dtype=np.float64)
        rot_phi = np.array(
            [[1, 0, 0],
             [0, np.cos(phi), -np.sin(phi)],
             [0, np.sin(phi), np.cos(phi)]])
        rot_theta = np.array(
            [[np.cos(theta), 0, -np.sin(theta)],
             [0, 1, 0],
             [np.sin(theta), 0, np.cos(theta)]])
        c2w = rot_theta @ rot_phi @ trans
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0.0]]) @ c2w

    thetas = np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
    return np.stack([pose(t, -np.pi / 12, radius) for t in thetas]).astype(
        np.float32)


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
