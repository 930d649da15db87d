"""Rendering (counterpart of ngp_pl_tpu/models/rendering.py; reference
models/rendering.py): the differentiable train renders in the JAX
package's three layouts (reference rendering.py:121-163) and test-view
rendering (span pre-pass, cull and the alive-ray round loop,
`RoundRenderer`, reference rendering.py:46-118).

Train render: scene-box hits -> march (the 8-step windowed march for one
cascade with uniform steps; the general march, `march_rays_train`, with
the two-window chain or the grid for multi-cascade / exponential steps and
for cameras past `segment_march_dmax_ok`) -> field (K1 + K7,
differentiable) -> compositor -> background, into
- the CSR pool (`render_rays_train_csr`): a flat pool shared by need;
- the strided block (`render_rays_train`): the first S samples of each ray
  in its own row, rays with more dropped from the loss (`loss_mask`);
- rounds (`render_rays_train_rounds`): four windowed test rounds of
  shrinking slot counts over the alive rays, with the transmittance and
  the distortion's prefix sums carried across rounds.

A frame goes: scene-box hits -> occupied-span pre-pass over a dilated
super-grid -> cull of rays with no occupied span -> chunks of the surviving
rays, each through rounds of march (first S occupied samples) -> field
(K1 + K7) -> incremental compositing, until every ray has converged, left
the box or used max_samples.  Multi-cascade scenes have no span pass: the
frame goes in chunks of consecutive rays from their box hits, on a black
background, with at least 4 samples per round.

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
    calc_dt,
    march_rays_test_round,
    march_rays_train,
    march_rays_train_strided,
    march_rays_train_window,
    occupancy_windows,
    occupied_span,
    occupied_span_prep,
)
from ngp_pl_torch.ops.volume_render import (
    SD_CLAMP,
    composite_test_round,
    composite_train,
    composite_train_strided,
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
                               exp_step_factor: float = 0.0,
                               max_samples: int = MAX_SAMPLES,
                               grid_size: int = 128,
                               subsample: int = 4096) -> int:
    """Static dt-chain bound of a scene (rendering.py:54-100): the chain
    steps the longest in-box segment of any training ray needs, rounded up
    to 128 plus 128, at most 2 max_samples.  Under uniform steps a segment
    is range / dt_min steps; under exponential ones the clamped-geometric
    chain is stepped from the nearest start across the longest range."""
    dt_min = float(SQRT3) / max_samples
    dt_max = float(SQRT3) * 2 * scale / grid_size
    poses = np.asarray(poses)
    directions = np.asarray(directions)
    if directions.shape[0] > subsample:
        directions = directions[::directions.shape[0] // subsample]
    t1_min, range_max = np.inf, 0.0
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
        t1_min = min(t1_min, float(near.min()))
        range_max = max(range_max, float((t2[hit] - near).max()))
    if not np.isfinite(t1_min) or range_max <= 0:
        return max_samples
    if exp_step_factor == 0.0:
        steps = int(math.ceil(range_max / dt_min))
    else:
        t, steps, t_end = t1_min, 0, t1_min + range_max
        while t < t_end and steps < 4 * max_samples:
            t += min(max(t * exp_step_factor, dt_min), dt_max)
            steps += 1
    steps = min(int(-(-steps // 128) * 128) + 128, 2 * max_samples)
    return max(steps, 128)


def _default_chain(cfg, rcfg) -> int:
    """The march's chain when the caller gives none (rendering.py:133-135):
    max_samples, twice that under exponential steps."""
    return rcfg.max_samples * (1 if cfg.exp_step_factor == 0 else 2)


def render_rays_train_csr(ngp, win_rows, rays_o, rays_d, noise, bg_rgb, *,
                          rcfg: RenderConfig, pool_mult: Optional[int] = None,
                          chain_length: int = 0, occ_grid=None,
                          exposure: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """Differentiable train render into the CSR pool (rendering.py:186-305).
    With `win_rows` under one cascade and uniform steps the 8-step windowed
    march (the caller checks `segment_march_dmax_ok`); otherwise
    `march_rays_train` on `occ_grid`, with the two-window chain where
    `win_rows` is given (the caller checks `window_march_mc_ok`).
    Gradients reach the field's parameters and, through the positions
    o + t * d (t held fixed: only the march runs without autograd) and the
    directions, the rays.  `exposure` (N, 1) goes to each ray's samples
    (HDR head).  Returns the compositor's outputs plus the pool and the
    march's demand statistics."""
    cfg = ngp.cfg
    N = rays_o.shape[0]
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    chain = chain_length or _default_chain(cfg, rcfg)
    pool_size = N * (pool_mult or rcfg.train_pool_mult)
    with torch.no_grad():
        if (win_rows is not None and cfg.cascades == 1
                and cfg.exp_step_factor == 0.0):
            m = march_rays_train_window(
                rays_o, rays_d, hits, noise, win_rows, scale=cfg.scale,
                grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
                pool_size=pool_size, chain_length=chain)
        else:
            m = march_rays_train(
                rays_o, rays_d, hits, occ_grid, noise,
                cascades=cfg.cascades, scale=cfg.scale,
                exp_step_factor=cfg.exp_step_factor,
                grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
                pool_size=pool_size, chain_length=chain, win_rows=win_rows)
    ridx = torch.clamp(m.ray_idx, 0, N - 1)
    o, d = rays_o[ridx], rays_d[ridx]
    xyz = _fma(m.ts[:, None], d, o)
    sigmas, rgbs = ngp(xyz, d, exposure=None if exposure is None
                       else exposure[ridx])
    out = composite_train(sigmas, rgbs, m.deltas, m.ts, m.ray_idx, m.valid,
                          m.offsets, n_rays=N, T_threshold=rcfg.t_threshold)
    out["rgb"] = out["rgb"] + bg_rgb[None, :] * (1.0 - out["opacity"][:, None])
    out.update(deltas=m.deltas, ts=m.ts, ray_idx=m.ray_idx,
               pool_valid=m.valid, offsets=m.offsets,
               rm_samples=m.total, rm_counts=m.rm_counts,
               chain_demand=m.chain_demand, chain_demand_q=m.chain_demand_q,
               chain_need=m.per_ray_need, vr_counts=out["vr_samples"],
               vr_samples=out["vr_samples"].sum())
    return out


def render_rays_train(ngp, win_rows, rays_o, rays_d, noise, bg_rgb, *,
                      rcfg: RenderConfig, n_samples: Optional[int] = None,
                      chain_length: int = 0, occ_grid=None,
                      exposure: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Differentiable train render into the strided (N, S) layout
    (rendering.py:103-183); the march takes `win_rows` or `occ_grid` as
    the JAX package's dispatch does (`march_rays_train_strided`).  A ray
    with more than S occupied samples is cut by the march and left out of
    the loss (`loss_mask`): a partial render would bias it towards its
    entry slab.  Invalid slots sit at their ray's origin (t = 0) with zero
    weight.  Gradients reach the rays as in the CSR render; `exposure`
    (N, 1) is per ray."""
    cfg = ngp.cfg
    S = n_samples or rcfg.train_pool_mult
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    with torch.no_grad():
        m = march_rays_train_strided(
            rays_o, rays_d, hits, noise, win_rows, scale=cfg.scale,
            grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
            n_samples=S, chain_length=chain_length or _default_chain(
                cfg, rcfg), cascades=cfg.cascades,
            exp_step_factor=cfg.exp_step_factor, occ_grid=occ_grid)
    xyz = _fma(m.ts[..., None], rays_d[:, None, :], rays_o[:, None, :])
    sigmas, rgbs = ngp.forward_rays(xyz, rays_d, exposure=exposure)
    out = composite_train_strided(sigmas, rgbs, m.deltas, m.ts, m.valid,
                                  T_threshold=rcfg.t_threshold)
    out["rgb"] = out["rgb"] + bg_rgb[None, :] * (1.0 - out["opacity"][:, None])
    out.update(loss_mask=m.rm_counts <= S, deltas=m.deltas, ts=m.ts,
               valid=m.valid, rm_samples=m.total, rm_counts=m.rm_counts,
               chain_demand=m.chain_demand, chain_demand_q=m.chain_demand_q,
               chain_need=m.per_ray_need, vr_counts=out["vr_samples"],
               vr_samples=out["vr_samples"].sum())
    return out


def _at_rows(full, raw, delta, add: bool):
    """`full.at[raw].add(delta)` (or `.set`) with JAX's mode="drop": the
    sentinel raw == N lands in a padding row that is cut off.  Out of place,
    so a tensor that autograd saved is never written."""
    pad = torch.cat([full, full.new_zeros((1,) + full.shape[1:])])
    if add:
        return pad.index_add(0, raw, delta)[:-1]
    return pad.index_copy(0, raw, delta)[:-1]


def render_rays_train_rounds(ngp, win_rows, rays_o, rays_d, noise, bg_rgb,
                             *, rcfg: RenderConfig, n_samples: int = 16,
                             chain_length: int = 256, n_rounds: int = 4,
                             lambda_distortion: float = 0.0, occ_grid=None,
                             exposure: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
    """Differentiable train render in `n_rounds` rounds
    (rendering.py:308-478).  Round r gives max(256, N >> r) slots to the
    alive rays, compacted to the front in ray order (sentinel N past them),
    marches S occupied samples of each with the windowed test round from
    its cursor, and composites them onto the carried transmittance; rgb,
    depth, opacity and T stay differentiable across rounds.  A ray alive
    past a round's slots, or after the last round, is left out of the
    loss.  With `lambda_distortion` the DVGO distortion accumulates per
    round from the carried prefix sums of w and w t.  Writes to the
    per-ray state use the unclamped sentinel: clamping it onto ray N - 1
    would collide with that ray's own write.  The rounds march as the test
    round does for `win_rows` and `occ_grid` (`march_rays_test_round`).
    Gradients reach the rays as in the CSR render; `exposure` (N, 1) is per
    ray."""
    cfg = ngp.cfg
    N = rays_o.shape[0]
    S = n_samples
    dev = rays_o.device
    thr = rcfg.t_threshold
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    t1, t_end = hits[:, 0], hits[:, 1]
    t_cur = torch.where(
        t1 >= 0, _fma(noise, calc_dt(t1, cfg.exp_step_factor,
                                     rcfg.max_samples, cfg.grid_size,
                                     cfg.scale), t1), t_end)
    T = torch.ones(N, device=dev)
    rgb = torch.zeros((N, 3), device=dev)
    depth = torch.zeros(N, device=dev)
    opacity = torch.zeros(N, device=dev)
    dist = torch.zeros(N, device=dev)
    ws_in = torch.zeros(N, device=dev)     # running sum of w
    wts_in = torch.zeros(N, device=dev)    # running sum of w * t
    alive = t1 >= 0
    vr_counts = torch.zeros(N, dtype=torch.int32, device=dev)
    rm_counts = torch.zeros(N, dtype=torch.int32, device=dev)
    dropped = torch.zeros(N, dtype=torch.bool, device=dev)
    total_slots = 0
    for r in range(n_rounds):
        slots = max(256, N >> r)
        total_slots += slots
        # the j-th alive ray in ray order, N past the last
        alive_csum = torch.cumsum(alive, dim=0)
        raw = torch.searchsorted(alive_csum, torch.arange(
            1, min(slots, N) + 1, device=dev))
        idx = torch.clamp_max(raw, N - 1)
        sel = raw < N
        dropped = dropped | (alive & (alive_csum > slots))

        ro, rd = rays_o[idx], rays_d[idx]
        with torch.no_grad():
            ts, dts, valid, t_next, n_eff = march_rays_test_round(
                ro, rd, t_cur[idx], t_end[idx], occ_grid,
                cascades=cfg.cascades, scale=cfg.scale,
                exp_step_factor=cfg.exp_step_factor,
                grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
                n_samples=S, chain_length=chain_length, win_rows=win_rows)
        valid = valid & sel[:, None]
        xyz = _fma(ts[..., None], rd[:, None, :], ro[:, None, :])
        sigmas, rgbs = ngp.forward_rays(
            xyz, rd, exposure=None if exposure is None else exposure[idx])

        sd = torch.where(valid, torch.clamp_max(sigmas * dts, SD_CLAMP), 0.0)
        excl = torch.cumsum(sd, dim=1) - sd
        T0 = T[idx]
        T_s = T0[:, None] * torch.exp(-excl)
        alpha = 1.0 - torch.exp(-sd)
        keep = valid & (T_s > thr)
        w = torch.where(keep, alpha * T_s, 0.0)
        if lambda_distortion > 0:
            wt = w * ts
            ws_ex = torch.cumsum(w, dim=1) - w + ws_in[idx][:, None]
            wts_ex = torch.cumsum(wt, dim=1) - wt + wts_in[idx][:, None]
            per_s = (2.0 * ((wts_ex + wt) * ws_ex - (ws_ex + w) * wts_ex)
                     + (w * w * dts) / 3.0)
            dist = _at_rows(dist, raw, per_s.sum(dim=1), add=True)
            ws_in = _at_rows(ws_in, raw, w.sum(dim=1), add=True)
            wts_in = _at_rows(wts_in, raw, wt.sum(dim=1), add=True)

        rgb = _at_rows(rgb, raw, (w[:, :, None] * rgbs).sum(dim=1), add=True)
        depth = _at_rows(depth, raw, (w * ts).sum(dim=1), add=True)
        opacity = _at_rows(opacity, raw, w.sum(dim=1), add=True)
        T_new = T0 * torch.exp(-sd.sum(dim=1))
        T = _at_rows(T, raw, T_new, add=False)
        t_cur = _at_rows(t_cur, raw, t_next, add=False)
        vr_counts = _at_rows(vr_counts, raw,
                             keep.sum(dim=1, dtype=torch.int32), add=True)
        rm_counts = _at_rows(rm_counts, raw, n_eff.to(torch.int32), add=True)
        still = sel & (T_new.detach() > thr) & (t_next < t_end[idx])
        alive = _at_rows(torch.zeros_like(alive), raw, still, add=False)

    loss_mask = ~(dropped | alive)
    return {
        "rgb": rgb + bg_rgb[None, :] * (1.0 - opacity[:, None]),
        "depth": depth, "opacity": opacity, "distortion": dist,
        "loss_mask": loss_mask, "rm_samples": rm_counts.sum(),
        "rm_counts": rm_counts, "vr_counts": vr_counts,
        "vr_samples": vr_counts.sum(),
        # rays still alive wanted more rounds; reported like the one-shot
        # marches' demand so the budget feedback keeps working
        "chain_demand": torch.tensor(chain_length * n_rounds, device=dev),
        "chain_demand_q": torch.tensor(chain_length, device=dev),
        "rounds_alive_end": alive.sum(),
        "total_slots": torch.tensor(total_slots, device=dev),
    }


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
    """Renders rays or camera poses with a fixed model and occupancy grid
    (`make_device_round_renderer`, rendering.py:588-980).

    Under exponential steps the first bucket holds at least 4 samples per
    ray (`min_s`) and there is no span pass.  `use_window` is the JAX
    package's flag (its systems set it where `segment_march_dmax_ok` or
    `window_march_mc_ok` holds): under multi-cascade or exponential steps
    the rounds then read the two-window chain, whose conservative
    fallbacks add samples; for one cascade with uniform steps the rounds
    read the grid, whose bits the 8-step windows equal."""

    def __init__(self, ngp, rcfg: RenderConfig, chunk: int = 131072,
                 use_window: bool = False):
        cfg = ngp.cfg
        self.ngp = ngp
        self.rcfg = rcfg
        self.chunk = chunk
        self.buckets = bucket_ladder(
            chunk, 1 if cfg.exp_step_factor == 0 else 4)
        self.use_span = cfg.cascades == 1 and cfg.exp_step_factor == 0.0
        self.use_window_mc = use_window and not self.use_span
        self._grid_cache: list = []

    def _packed(self, occ_grid):
        """The span pass's dilated super-grid or the two-window chain's
        windows, computed once per occupancy grid."""
        if not (self._grid_cache and self._grid_cache[0] is occ_grid):
            if self.use_span:
                packed = occupied_span_prep(
                    occ_grid, grid_size=self.ngp.cfg.grid_size)
            else:
                packed = (occupancy_windows(occ_grid) if self.use_window_mc
                          else None)
            self._grid_cache[:] = [occ_grid, packed]
        return self._grid_cache[1]

    def _bucket(self, n_alive: int) -> Tuple[int, int, int]:
        branch = sum(s >= n_alive for s, _, _ in self.buckets[1:])
        return self.buckets[branch]

    @torch.no_grad()
    def _render_chunk(self, occ_grid, rays_o, rays_d, t_start, t_end):
        cfg, rcfg = self.ngp.cfg, self.rcfg
        win_rows = None if self.use_span else self._packed(occ_grid)
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
                n_samples=n_s, chain_length=chain, win_rows=win_rows)
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
        if not self.use_span:
            return self._render_unspanned(occ_grid, rays_o, rays_d, bg_color)
        span_grid = self._packed(occ_grid)
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

    def _render_unspanned(self, occ_grid, rays_o, rays_d, bg_color):
        """Chunks of consecutive rays from their box hits
        (rendering.py:939-968): each chunk's alive count, and so its
        buckets, counts the rays of that chunk that hit the box.  A short
        last chunk is padded, as the JAX package pads it, with rays from
        (1, 1, 1) along (1, 1, 1): inside a box of scale > 1 they are
        alive, move the chunk's buckets and add to its samples and rounds;
        their outputs are dropped."""
        parts, total, rounds, alive = [], 0, 0, 0
        N = rays_o.shape[0]
        for i in range(0, N, self.chunk):
            ro, rd = rays_o[i:i + self.chunk], rays_d[i:i + self.chunk]
            n = ro.shape[0]
            if n < self.chunk:
                ro, rd = (torch.cat([a, a.new_ones((self.chunk - n, 3))])
                          for a in (ro, rd))
            hits = scene_hits(ro, rd, self.ngp.cfg.scale)
            r, d, o, ns, nr = self._render_chunk(occ_grid, ro, rd,
                                                 hits[:, 0], hits[:, 1])
            parts.append((r[:n], d[:n], o[:n]))
            total += int(ns)
            rounds += nr
            alive += int((hits[:n, 0] >= 0).sum())
        rgb, depth, opacity = (torch.cat(p) for p in zip(*parts))
        return {"rgb": rgb + bg_color * (1.0 - opacity[:, None]),
                "depth": depth, "opacity": opacity, "total_samples": total,
                "rounds": rounds, "alive_rays": alive}

    def render_pose(self, occ_grid, directions, pose,
                    bg_color: Optional[float] = None) -> Dict:
        """Camera-frame directions (N, 3) and a (3, 4) c2w pose, both on
        the model's device."""
        rays_o, rays_d = get_rays(directions, pose)
        return self.render_image(occ_grid, rays_o.contiguous(), rays_d,
                                 bg_color)
