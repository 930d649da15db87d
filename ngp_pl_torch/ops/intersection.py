"""Ray / box and ray / sphere intersection (counterpart of
ngp_pl_tpu/ops/intersection.py, reference models/csrc/intersection.cu).

The render path intersects only the scene box, one hit per ray
(`ray_aabb_intersect_single`); `ray_aabb_intersect` and
`ray_sphere_intersect` are the reference's multi-voxel kernels, with hits
sorted near to far by a stable sort, as `jnp.argsort` sorts, so that ties
(misses at +inf, several boxes around an origin that clamp to 0) keep the
JAX package's order.  Sums over the three axes are written out in JAX's
order and the square root is taken in float64 (torch's vectorised float32
sqrt on the CPU is not correctly rounded: it moves the last bit of ~17% of
values), so both devices give the JAX package's bits.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _slab_test(rays_o, inv_d, centers, half_sizes):
    """Slab test per (ray, box) (intersection.cu:5-22): rays_o, inv_d
    (N, 3); centers, half_sizes (V, 3).  Returns (N, V) near and far,
    near > far on a miss."""
    o, inv = rays_o[:, None, :], inv_d[:, None, :]
    t_min = (centers[None] - half_sizes[None] - o) * inv
    t_max = (centers[None] + half_sizes[None] - o) * inv
    t1 = torch.minimum(t_min, t_max).amax(dim=-1)
    t2 = torch.maximum(t_min, t_max).amin(dim=-1)
    return t1, t2


def ray_aabb_intersect_single(rays_o: torch.Tensor, rays_d: torch.Tensor,
                              center: torch.Tensor,
                              half_size: torch.Tensor) -> torch.Tensor:
    """Intersect rays with ONE box.  Returns hits_t (N, 2); rows of -1 mark
    a miss.  Near is clamped to 0; rows with t2 <= 0 or t1 > t2 miss."""
    t1, t2 = _slab_test(rays_o, 1.0 / rays_d, center.reshape(1, 3),
                        half_size.reshape(1, 3))
    t1, t2 = t1[:, 0], t2[:, 0]
    hit = (t1 <= t2) & (t2 > 0)
    near = torch.clamp_min(t1, 0.0)
    return torch.where(hit[:, None], torch.stack([near, t2], dim=-1),
                       torch.full_like(rays_o[:, :2], -1.0))


def _sorted_hits(hit, near_hit, far, max_hits):
    """(hits_cnt (N,) int32, hits_t (N, max_hits, 2), hits_idx (N,
    max_hits)) from per-(ray, object) hits: near to far, misses last as -1."""
    near = torch.where(hit, near_hit, torch.full_like(near_hit, torch.inf))
    order = torch.argsort(near, dim=1, stable=True)[:, :max_hits]
    near_s = torch.gather(near, 1, order)
    far_s = torch.gather(far, 1, order)
    hit_s = torch.gather(hit, 1, order)
    hits_t = torch.where(hit_s[..., None],
                         torch.stack([near_s, far_s], dim=-1), -1.0)
    hits_idx = torch.where(hit_s, order, -1)
    return hit.sum(dim=1, dtype=torch.int32), hits_t, hits_idx


def ray_aabb_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       centers: torch.Tensor, half_sizes: torch.Tensor,
                       max_hits: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays (N, 3) against boxes (V, 3) (intersection.cu:60-105).  Returns
    (hits_cnt (N,), hits_t (N, max_hits, 2), hits_voxel_idx (N,
    max_hits)), hits near to far, -1 padding for misses."""
    t1, t2 = _slab_test(rays_o, 1.0 / rays_d, centers, half_sizes)
    hit = (t1 <= t2) & (t2 > 0)
    return _sorted_hits(hit, torch.clamp_min(t1, 0.0), t2, max_hits)


def _dot3(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def ray_sphere_intersect(rays_o: torch.Tensor, rays_d: torch.Tensor,
                         centers: torch.Tensor, radii: torch.Tensor,
                         max_hits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays (N, 3) against spheres: centers (S, 3), radii (S,) or (S, 3),
    of which the first per-axis radius counts, as in the reference
    (intersection.cu:103-197).  Same outputs as `ray_aabb_intersect`."""
    radii = radii.reshape(radii.shape[0], -1)[:, 0]
    oc = rays_o[:, None, :] - centers[None]                 # (N, S, 3)
    a = _dot3(rays_d, rays_d)[:, None]                      # (N, 1)
    b = 2.0 * _dot3(oc, rays_d[:, None, :])                 # (N, S)
    c = _dot3(oc, oc) - radii[None] * radii[None]
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0).double()).float()
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    hit = (disc > 0) & (t2 > 0)
    return _sorted_hits(hit, torch.clamp_min(t1, 0.0), t2, max_hits)
