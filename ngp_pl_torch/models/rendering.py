"""Rendering (counterpart of ngp_pl_tpu/models/rendering.py; reference
models/rendering.py): the differentiable CSR train render
(`render_rays_train_csr`, reference rendering.py:121-163) and test-view
rendering (span pre-pass, cull and the alive-ray round loop,
`RoundRenderer`, reference rendering.py:46-118).

Train render: scene-box hits -> windowed march into the flat pool ->
field (K1 + K7, differentiable) -> CSR compositor -> background.

A frame goes: scene-box hits -> occupied-span pre-pass over a dilated
super-grid -> cull of rays with no occupied span -> chunks of the surviving
rays, each through rounds of march (first S occupied samples) -> field
(K1 + K7) -> incremental compositing, until every ray has converged, left
the box or used max_samples.

Each round picks its (slots, n_samples, chain) from the JAX package's bucket
ladder: the smallest bucket whose slot count still fits the alive rays.  The
bucket sets the round's samples per ray and chain length, and so the result.
The JAX package ran the loop on the device and padded every round to the
bucket's slot count; here the host reads the alive count each round, as the
CUDA reference does, and a round processes exactly the alive rays.  A ray's
result depends only on the (n_samples, chain) sequence it sees, so it is the
JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ngp_pl_torch.config import MAX_SAMPLES, NEAR_DISTANCE, SQRT3, RenderConfig
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.ops.intersection import ray_aabb_intersect_single
from ngp_pl_torch.ops.ray_march import (
    _fma,
    march_rays_test_round,
    march_rays_train_window,
    occupied_span,
    occupied_span_prep,
)
from ngp_pl_torch.ops.volume_render import (
    composite_test_round,
    composite_train,
)

MAX_ROUNDS = 512     # per chunk, as the JAX package's renderer


def scene_hits(rays_o, rays_d, scale: float):
    """Intersect with the scene box and clamp the near plane
    (reference rendering.py:26-29)."""
    center = torch.zeros(3, dtype=rays_o.dtype, device=rays_o.device)
    half = torch.full((3,), scale, dtype=rays_o.dtype, device=rays_o.device)
    hits = ray_aabb_intersect_single(rays_o, rays_d, center, half)
    near = hits[:, 0]
    near = torch.where((near >= 0) & (near < NEAR_DISTANCE), NEAR_DISTANCE,
                       near)
    return torch.stack([near, hits[:, 1]], dim=-1)


def compute_scene_chain_length(poses, directions, scale: float,
                               max_samples: int = MAX_SAMPLES,
                               subsample: int = 4096) -> int:
    """Static dt-chain bound of a uniform-step scene: the longest in-box
    segment of any training ray, in chain steps of dt_min, rounded up to
    128 plus 128 (rendering.py:54-100; its exp-stepping branch comes with
    the multi-cascade slice)."""
    dt_min = float(SQRT3) / max_samples
    poses = np.asarray(poses)
    directions = np.asarray(directions)
    if directions.shape[0] > subsample:
        directions = directions[::directions.shape[0] // subsample]
    range_max = 0.0
    for pose in poses:
        rd = directions @ pose[:, :3].T
        ro = pose[:, 3][None, :]
        inv = 1.0 / rd
        lo = (-scale - ro) * inv
        hi = (scale - ro) * inv
        t1 = np.minimum(lo, hi).max(axis=1)
        t2 = np.maximum(lo, hi).min(axis=1)
        hit = (t1 <= t2) & (t2 > 0)
        if not hit.any():
            continue
        near = np.maximum(t1[hit], NEAR_DISTANCE)
        range_max = max(range_max, float((t2[hit] - near).max()))
    if range_max <= 0:
        return max_samples
    steps = int(math.ceil(range_max / dt_min))
    steps = min(int(-(-steps // 128) * 128) + 128, 2 * max_samples)
    return max(steps, 128)


def render_rays_train_csr(ngp, win_rows, rays_o, rays_d, noise, bg_rgb, *,
                          rcfg: RenderConfig, pool_mult: Optional[int] = None,
                          chain_length: int = 0) -> Dict[str, torch.Tensor]:
    """Differentiable train render into the CSR pool, windowed-march branch
    (rendering.py:186-238, 275-305).  Single cascade and uniform steps only;
    the caller checks `segment_march_dmax_ok`.  Gradients reach the field's
    parameters; positions are o + t * d with t and the rays held fixed.
    Returns the compositor's outputs plus the pool and the march's demand
    statistics."""
    cfg = ngp.cfg
    if cfg.cascades != 1 or cfg.exp_step_factor != 0.0:
        raise NotImplementedError(
            "the train render covers single-cascade scenes (scale <= 0.5); "
            "multi-cascade / exp stepping is a later slice")
    N = rays_o.shape[0]
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    chain = chain_length or rcfg.max_samples
    with torch.no_grad():
        m = march_rays_train_window(
            rays_o, rays_d, hits, noise, win_rows, scale=cfg.scale,
            grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
            pool_size=N * (pool_mult or rcfg.train_pool_mult),
            chain_length=chain)
    ridx = torch.clamp(m.ray_idx, 0, N - 1)
    o, d = rays_o[ridx], rays_d[ridx]
    xyz = _fma(m.ts[:, None], d, o)
    sigmas, rgbs = ngp(xyz, d)
    out = composite_train(sigmas, rgbs, m.deltas, m.ts, m.ray_idx, m.valid,
                          m.offsets, n_rays=N, T_threshold=rcfg.t_threshold)
    out["rgb"] = out["rgb"] + bg_rgb[None, :] * (1.0 - out["opacity"][:, None])
    out.update(ts=m.ts, ray_idx=m.ray_idx, offsets=m.offsets,
               rm_samples=m.total, rm_counts=m.rm_counts,
               chain_demand=m.chain_demand, chain_demand_q=m.chain_demand_q,
               vr_counts=out["vr_samples"],
               vr_samples=out["vr_samples"].sum())
    return out


def bucket_ladder(chunk: int, min_s: int) -> List[Tuple[int, int, int]]:
    """(slots, n_samples, chain) buckets, largest first: a 2x slot ladder
    with n_samples growing 8 -> 64 as the alive set shrinks; the first
    bucket gets a 256-step chain so empty space is crossed in few rounds
    (rendering.py:644-660, chain rounding :743)."""
    buckets = []
    s, ns, first = chunk, max(min_s, 8), True
    while s >= 1024 and ns <= 64:
        buckets.append((s, ns, 256 if first else 128))
        s //= 2
        ns = min(64, ns * 2)
        first = False
    tail = (min(max(s, 256), chunk), 64, 128)
    if tail not in buckets:
        buckets.append(tail)
    return [(s, ns, -(-max(ch, 4 * ns) // 8) * 8) for s, ns, ch in buckets]


class RoundRenderer:
    """Renders rays or camera poses with a fixed model and occupancy grid."""

    def __init__(self, ngp, rcfg: RenderConfig, chunk: int = 131072):
        cfg = ngp.cfg
        if cfg.cascades != 1 or cfg.exp_step_factor != 0.0:
            raise NotImplementedError(
                "the round renderer covers single-cascade scenes (scale <= "
                "0.5); multi-cascade / exp stepping is a later slice")
        self.ngp = ngp
        self.rcfg = rcfg
        self.chunk = chunk
        self.buckets = bucket_ladder(chunk, 1)
        self._span_cache: list = []

    def _span_grid(self, occ_grid):
        """Dilated super-grid, computed once per occupancy grid."""
        if not (self._span_cache and self._span_cache[0] is occ_grid):
            self._span_cache[:] = [occ_grid, occupied_span_prep(
                occ_grid, grid_size=self.ngp.cfg.grid_size)]
        return self._span_cache[1]

    def _bucket(self, n_alive: int) -> Tuple[int, int, int]:
        branch = sum(s >= n_alive for s, _, _ in self.buckets[1:])
        return self.buckets[branch]

    @torch.no_grad()
    def _render_chunk(self, occ_grid, rays_o, rays_d, t_start, t_end):
        cfg, rcfg = self.ngp.cfg, self.rcfg
        N = rays_o.shape[0]
        dev = rays_o.device
        t_cur = t_start.clone()
        opacity = torch.zeros(N, device=dev)
        depth = torch.zeros(N, device=dev)
        rgb = torch.zeros((N, 3), device=dev)
        alive = t_start >= 0
        samples = torch.zeros(N, dtype=torch.int64, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        rounds = 0
        while rounds < MAX_ROUNDS:
            idx = torch.nonzero(alive).squeeze(1)       # reads n_alive
            n = idx.numel()
            if n == 0:
                break
            _, n_s, chain = self._bucket(n)
            ro, rd, te = rays_o[idx], rays_d[idx], t_end[idx]
            ts, dts, valid, t_next, n_eff = march_rays_test_round(
                ro, rd, t_cur[idx], te, occ_grid, cascades=cfg.cascades,
                scale=cfg.scale, exp_step_factor=cfg.exp_step_factor,
                grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
                n_samples=n_s, chain_length=chain)
            xyz = ro[:, None, :] + ts[..., None] * rd[:, None, :]
            dirs = rd[:, None, :].expand(n, n_s, 3)
            sigmas, rgbs = self.ngp(xyz.reshape(n * n_s, 3),
                                    dirs.reshape(n * n_s, 3))
            o2, d2, r2, a2 = composite_test_round(
                sigmas.reshape(n, n_s), rgbs.reshape(n, n_s, 3), dts, ts,
                valid, opacity[idx], depth[idx], rgb[idx],
                torch.ones(n, dtype=torch.bool, device=dev),
                rcfg.test_t_threshold)
            s2 = samples[idx] + n_s
            a2 = a2 & (t_next < te) & (s2 < rcfg.max_samples)
            t_cur[idx] = t_next
            opacity[idx] = o2
            depth[idx] = d2
            rgb[idx] = r2
            alive[idx] = a2
            samples[idx] = s2
            total += n_eff.sum()
            rounds += 1
        return rgb, depth, opacity, total, rounds

    @torch.no_grad()
    def render_image(self, occ_grid, rays_o, rays_d,
                     bg_color: Optional[float] = None) -> Dict:
        """rays (N, 3) f32 tensors on the model's device -> dict of rgb
        (N, 3), depth, opacity (tensors) and total_samples, rounds,
        alive_rays (ints)."""
        cfg = self.ngp.cfg
        if bg_color is None:
            bg_color = 1.0 if cfg.exp_step_factor == 0 else 0.0
        N = rays_o.shape[0]
        dev = rays_o.device
        span_grid = self._span_grid(occ_grid)
        dt_min = SQRT3 / self.rcfg.max_samples
        t1_all, t2_all, alive_all = [], [], []
        for i in range(0, N, self.chunk):
            ro, rd = rays_o[i:i + self.chunk], rays_d[i:i + self.chunk]
            hits = scene_hits(ro, rd, cfg.scale)
            t1s, t2s, span_steps = occupied_span(
                ro, rd, hits[:, 0], hits[:, 1], span_grid, scale=cfg.scale,
                dt_min=dt_min)
            t1_all.append(t1s)
            t2_all.append(t2s)
            alive_all.append((hits[:, 0] >= 0) & (span_steps > 0))
        t1_all, t2_all = torch.cat(t1_all), torch.cat(t2_all)
        idx = torch.nonzero(torch.cat(alive_all)).squeeze(1)

        rgb = torch.zeros((N, 3), device=dev)
        depth = torch.zeros(N, device=dev)
        opacity = torch.zeros(N, device=dev)
        total, rounds = 0, 0
        for i in range(0, idx.numel(), self.chunk):
            sel = idx[i:i + self.chunk]
            r, d, o, ns, nr = self._render_chunk(
                occ_grid, rays_o[sel], rays_d[sel], t1_all[sel], t2_all[sel])
            rgb[sel], depth[sel], opacity[sel] = r, d, o
            total += int(ns)
            rounds += nr
        rgb = rgb + bg_color * (1.0 - opacity[:, None])
        return {"rgb": rgb, "depth": depth, "opacity": opacity,
                "total_samples": total, "rounds": rounds,
                "alive_rays": int(idx.numel())}

    def render_pose(self, occ_grid, directions, pose,
                    bg_color: Optional[float] = None) -> Dict:
        """Camera-frame directions (N, 3) and a (3, 4) c2w pose, both on
        the model's device."""
        rays_o, rays_d = get_rays(directions, pose)
        return self.render_image(occ_grid, rays_o.contiguous(), rays_d,
                                 bg_color)
