"""Procedural synthetic scene with analytic ground truth (counterpart of
ngp_pl_tpu/datasets/synthetic.py).

Soft hollow coloured spheres inside [-0.4, 0.4]^3, seen by cameras on a
radius-1.5 sphere looking at the origin (the NeRF-synthetic convention, white
background).  `world_scale` ws scales the scene geometrically (centres,
radii, edge widths and camera radius x ws, density / ws), so the images do
not change while the content spans [-0.4 ws, 0.4 ws]^3: at ws=8 it fills
the scale-4 box of the multi-cascade scenes, which train on a black
background (`bg=0`).  Intrinsics, poses and seeds are the JAX package's,
so both packages see the same views; ground-truth images are rendered on
demand on the dataset's device by a port of the JAX package's exact
renderer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ngp_pl_torch.datasets.ray_utils import get_ray_directions
from ngp_pl_torch.device import resolve_device

# (center, radius, rgb) of the analytic spheres
_SPHERES = [
    (np.array([0.0, 0.0, 0.0]), 0.22, np.array([0.9, 0.25, 0.2])),
    (np.array([0.25, 0.15, -0.1]), 0.12, np.array([0.2, 0.8, 0.3])),
    (np.array([-0.22, -0.18, 0.15]), 0.1, np.array([0.25, 0.35, 0.95])),
    (np.array([0.05, -0.28, -0.2]), 0.09, np.array([0.95, 0.85, 0.2])),
]
_DENSITY = 800.0  # alpha ~0.74 per marched sample: rays stop after a few
_EDGE = 0.02      # soft edge width
_THICK = 0.05     # shell thickness (hollow spheres)
_N_STEPS = 384    # ground-truth depth samples per ray


def _lookat_pose(cam_pos: np.ndarray) -> np.ndarray:
    """c2w with camera axes [right down front] looking at the origin."""
    forward = -cam_pos / np.linalg.norm(cam_pos)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward, cam_pos], axis=1).astype(np.float32)


@torch.no_grad()
def render_gt(rays_o: torch.Tensor, rays_d: torch.Tensor,
              world_scale: float = 1.0, bg: float = 1.0):
    """Dense volume render of the analytic field scaled by `world_scale` at
    _N_STEPS uniform depths in [0.6, 2.6] x world_scale, on the background
    `bg` (synthetic.py:71-130).  Returns (rgb (N, 3), depth (N,), opacity
    (N,))."""
    dev = rays_o.device
    ws = float(world_scale)
    centers = torch.tensor(np.stack([s[0] for s in _SPHERES]),
                           dtype=torch.float32, device=dev) * ws
    radii = torch.tensor([s[1] for s in _SPHERES], dtype=torch.float32,
                         device=dev) * ws
    colors = torch.tensor(np.stack([s[2] for s in _SPHERES]),
                          dtype=torch.float32, device=dev)
    ts = torch.linspace(0.6 * ws, 2.6 * ws, _N_STEPS, dtype=torch.float32)
    dt = float(ts[1] - ts[0])
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    N = rays_o.shape[0]
    rgb_acc = torch.zeros((N, 3), device=dev)
    depth_acc = torch.zeros(N, device=dev)
    T = torch.ones(N, device=dev)
    for t in ts.tolist():
        xyz = rays_o + t * d
        dist = torch.linalg.norm(xyz[:, None, :] - centers[None], dim=-1)
        outer = torch.clamp((radii[None] - dist) / (_EDGE * ws), 0.0, 1.0)
        inner = torch.clamp((dist - (radii[None] - _THICK * ws))
                            / (_EDGE * ws), 0.0, 1.0)
        inside, best = (outer * inner).max(dim=1)
        sigma = (_DENSITY / ws) * inside
        rgb = torch.where(inside[:, None] > 0, colors[best], 1.0)
        alpha = 1.0 - torch.exp(-sigma * dt)
        w = alpha * T
        rgb_acc += w[:, None] * rgb
        depth_acc += w * t
        T = T * (1.0 - alpha)
    return rgb_acc + bg * T[:, None], depth_acc, 1.0 - T


class SyntheticDataset:
    """Poses, intrinsics and ground truth of one split: `n_train` (24) train
    or `n_test` (4) test views of img_size x img_size * downsample pixels
    (128 by default), cameras drawn from `seed` (train) or `seed + 1` (test),
    as ngp_pl_tpu/datasets/synthetic.py:151-189 does; `world_scale` and
    the background `bg` as there (see the module note).

    `rays` is the ground-truth store (n_img, H*W, 3) on the dataset's
    device, rendered at first use; test views are also rendered one at a
    time by `image`."""

    def __init__(self, split="train", downsample=1.0, device="cuda",
                 img_size=128, n_train=24, n_test=4, seed=0,
                 world_scale=1.0, bg=1.0):
        self.split = split
        self.world_scale = float(world_scale)
        self.bg = float(bg)
        self.device = resolve_device(device)
        w = h = int(img_size * downsample)
        f = 1.2 * w
        self.K = np.float32([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        self.img_wh = (w, h)
        self.directions = get_ray_directions(h, w, self.K)
        self._rays = None

        train = split.startswith("train")
        rng = np.random.default_rng(seed if train else seed + 1)
        n = n_train if train else n_test
        poses = []
        for i in range(n):
            theta = 2 * np.pi * i / n + rng.uniform(0, 0.1)
            phi = np.deg2rad(rng.uniform(-55, -15))
            cam = 1.5 * self.world_scale * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                -np.sin(phi),
            ])
            poses.append(_lookat_pose(cam))
        self.poses = np.stack(poses)

    def image(self, idx: int) -> torch.Tensor:
        """Ground-truth rgb (H*W, 3) of view idx, on the dataset's device."""
        pose = self.poses[idx]
        rd = self.directions @ pose[:, :3].T
        ro = np.broadcast_to(pose[:, 3], rd.shape)
        rgb, _, _ = render_gt(torch.tensor(ro, device=self.device),
                              torch.tensor(rd, device=self.device),
                              world_scale=self.world_scale, bg=self.bg)
        return rgb

    @property
    def rays(self) -> torch.Tensor:
        """(n_img, H*W, 3) f32 ground-truth colours of every view, kept on
        the dataset's device (the resident store the train step samples)."""
        if self._rays is None:
            self._rays = torch.stack([self.image(i)
                                      for i in range(len(self.poses))])
        return self._rays

    def test_item(self, idx: int) -> Dict:
        return {"pose": self.poses[idx], "rgb": self.image(idx)}
