"""The benchmark's own scene: procedural hollow spheres in ngp_pl's
NeRF-synthetic layout (100 train views of 800x800, cameras on the
radius-1.5 sphere looking at the origin, white background).

The constants are frozen copies of the port's procedural scene
(`ngp_pl_torch/datasets/synthetic.py`: four soft hollow coloured spheres in
[-0.4, 0.4]^3, 384 ground-truth depth samples per ray in [0.6, 2.6]); the
renderer is this file's own, vectorised over rays and depth samples so that
the 64M ground-truth rays of a run take seconds on the card.  The scene does
not depend on the run's seed: the cameras come from `np.random.default_rng(0)`
as the port's train split draws them, and every pixel is quantised to 8 bits
as a PNG of the Blender scenes holds it.  The 100 views take ~13 s to
render on an H100, so the first run in a checkout keeps them, 8 bits a
value, in `build/perfbench/` and later runs read them from there
(`cached_views`).  Nothing here imports the program.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import torch

SPHERES = (                       # (centre, radius, rgb)
    ((0.0, 0.0, 0.0), 0.22, (0.9, 0.25, 0.2)),
    ((0.25, 0.15, -0.1), 0.12, (0.2, 0.8, 0.3)),
    ((-0.22, -0.18, 0.15), 0.1, (0.25, 0.35, 0.95)),
    ((0.05, -0.28, -0.2), 0.09, (0.95, 0.85, 0.2)),
)
DENSITY = 800.0                   # per unit length inside a shell
EDGE = 0.02                       # soft edge width
THICK = 0.05                      # shell thickness
GT_STEPS = 384                    # ground-truth depth samples per ray
GT_NEAR, GT_FAR = 0.6, 2.6
CAMERA_RADIUS = 1.5
FOCAL_PER_WIDTH = 1.2             # f = 1.2 W, principal point at the centre


def intrinsics(size: int) -> np.ndarray:
    f = FOCAL_PER_WIDTH * size
    return np.float32([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]])


def directions(size: int) -> np.ndarray:
    """(size^2, 3) float32 camera-frame directions through the pixel
    centres, [right down front]."""
    K = intrinsics(size)
    u, v = np.meshgrid(np.arange(size, dtype=np.float32),
                       np.arange(size, dtype=np.float32), indexing="xy")
    d = np.stack([(u - K[0, 2] + 0.5) / K[0, 0],
                  (v - K[1, 2] + 0.5) / K[1, 1], np.ones_like(u)], axis=-1)
    return d.astype(np.float32).reshape(-1, 3)


def lookat(cam: np.ndarray) -> np.ndarray:
    """(3, 4) float32 c2w with axes [right down front] looking at the
    origin."""
    forward = -cam / np.linalg.norm(cam)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward, cam], axis=1).astype(np.float32)


def train_poses(n: int) -> np.ndarray:
    """(n, 3, 4) train cameras: azimuth 2 pi i / n + U(0, 0.1), elevation
    U(15, 55) degrees above the equator, from `default_rng(0)`."""
    rng = np.random.default_rng(0)
    poses = []
    for i in range(n):
        theta = 2 * np.pi * i / n + rng.uniform(0, 0.1)
        phi = np.deg2rad(rng.uniform(-55, -15))
        poses.append(lookat(CAMERA_RADIUS * np.array([
            np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
            -np.sin(phi)])))
    return np.stack(poses)


def orbit_poses(n: int, elevation_deg: float) -> np.ndarray:
    """(n, 3, 4) cameras of a fixed orbit: azimuth 2 pi (i + 1/2) / n at
    `elevation_deg` above the equator, radius 1.5: between the train
    views."""
    phi = math.radians(elevation_deg)
    return np.stack([lookat(CAMERA_RADIUS * np.array([
        math.cos(t) * math.cos(phi), math.sin(t) * math.cos(phi),
        math.sin(phi)])) for t in (2 * math.pi * (i + 0.5) / n
                                   for i in range(n))])


@torch.no_grad()
def render(rays_o: torch.Tensor, rays_d: torch.Tensor,
           steps_at_once: int = 32) -> torch.Tensor:
    """Ground-truth rgb (N, 3) of rays on the white background: a dense
    volume render of the spheres at GT_STEPS uniform depths, `steps_at_once`
    depths per pass."""
    dev = rays_o.device
    centers = torch.tensor([s[0] for s in SPHERES], device=dev)
    radii = torch.tensor([s[1] for s in SPHERES], device=dev)
    colors = torch.tensor([s[2] for s in SPHERES], device=dev)
    dt = (GT_FAR - GT_NEAR) / (GT_STEPS - 1)
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    N = rays_o.shape[0]
    rgb = torch.zeros((N, 3), device=dev)
    T = torch.ones(N, device=dev)
    for s0 in range(0, GT_STEPS, steps_at_once):
        t = GT_NEAR + dt * torch.arange(
            s0, min(s0 + steps_at_once, GT_STEPS), device=dev,
            dtype=torch.float32)
        xyz = rays_o[:, None, :] + t[None, :, None] * d[:, None, :]
        dist = torch.linalg.norm(xyz[:, :, None, :] - centers, dim=-1)
        outer = torch.clamp((radii - dist) / EDGE, 0.0, 1.0)
        inner = torch.clamp((dist - (radii - THICK)) / EDGE, 0.0, 1.0)
        inside, best = (outer * inner).max(dim=-1)           # (N, S)
        alpha = 1.0 - torch.exp(-DENSITY * inside * dt)
        trans = torch.cumprod(torch.cat(
            [T[:, None], 1.0 - alpha], dim=1), dim=1)        # (N, S + 1)
        w = alpha * trans[:, :-1]
        col = torch.where(inside[..., None] > 0, colors[best], 1.0)
        rgb += (w[..., None] * col).sum(dim=1)
        T = trans[:, -1]
    return rgb + T[:, None]


@torch.no_grad()
def views(poses: np.ndarray, size: int, device,
          rays_at_once: int = 1 << 18) -> torch.Tensor:
    """(n_views, size^2, 3) float32 8-bit ground truth of every view, on
    `device`."""
    dirs = torch.from_numpy(directions(size)).to(device)
    out = torch.empty((len(poses), size * size, 3), device=device)
    for i, pose in enumerate(poses):
        p = torch.from_numpy(pose).to(device)
        rd = dirs @ p[:, :3].T
        for a in range(0, rd.shape[0], rays_at_once):
            b = min(a + rays_at_once, rd.shape[0])
            out[i, a:b] = render(p[:, 3].expand(b - a, 3), rd[a:b])
    return torch.round(out.clamp(0.0, 1.0) * 255.0) / 255.0


def cached_views(poses: np.ndarray, size: int, device, cache_dir: Path,
                 tag: str) -> torch.Tensor:
    """`views`, read from `cache_dir/<tag>_<views>x<size>.u8` where an
    earlier run wrote it, else rendered and written there (through a
    temporary name, so that ranks rendering at once each write whole
    files)."""
    path = Path(cache_dir) / f"{tag}_{len(poses)}x{size}.u8"
    shape = (len(poses), size * size, 3)
    if path.exists() and path.stat().st_size == math.prod(shape):
        raw = torch.from_numpy(np.fromfile(path, dtype=np.uint8))
        return raw.to(device).reshape(shape).to(torch.float32) / 255.0
    out = views(poses, size, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    (out * 255.0).round().to(torch.uint8).cpu().numpy().tofile(tmp)
    os.replace(tmp, path)
    return out
