"""Occupancy-guided test-time ray marching (counterpart of the test-path pieces
of ngp_pl_tpu/ops/ray_march.py; reference models/csrc/raymarching.cu).

The dt-chain has a closed form, so the k-th marching position of a ray is a
function of (t_start, k) alone; a round evaluates the chain for all (ray, k)
at once, looks up occupancy and keeps the first S occupied steps.

The TPU version packed the uint8 grid into bit lines and 64-byte windows and
picked the first S bits by popcounts, all to avoid narrow gathers.  Here the
lookup reads the uint8 grid directly and the first-S selection is a cumsum
and a sorted search.  Sample positions are computed in f32 in the JAX
package's order, so both give the same bits wherever the windowed march is
valid (`segment_march_dmax_ok` in the JAX package), which holds for the
synthetic cameras.

Divisions by a constant go through a 0-dim tensor of the same device: on
CUDA PyTorch turns `tensor / python_float` into a multiply by the
reciprocal (and `python_float / tensor` is a reciprocal on both devices),
which can move a sample by one ulp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ngp_pl_torch.config import SQRT3

# cells per supercell edge of the span pre-pass; the JAX package measured 2
# slower than 4 at 800x800 (ngp_pl_tpu/models/rendering.py:673-675)
SPAN_SUPER_FACTOR = 4


def f32_const(v: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim f32 tensor on `like`'s device (see the module note)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def calc_dt(t, exp_step_factor, max_samples, grid_size, scale):
    """Step size along the chain (raymarching.cu:11-13)."""
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    return torch.clamp(t * exp_step_factor, dt_min, dt_max)


def chain_t(t0, k, exp_step_factor, dt_min, dt_max):
    """Closed-form t_k of the dt-chain starting at t0 (broadcasting t0 and
    the float step indices k)."""
    if exp_step_factor == 0.0:
        return t0 + k * dt_min
    f = exp_step_factor
    log1pf = math.log1p(f)
    t_a = dt_min / f   # below: dt = dt_min
    t_b = dt_max / f   # above: dt = dt_max
    n1 = torch.ceil(torch.clamp_min(t_a - t0, 0.0) / f32_const(dt_min, t0))
    t1 = t0 + n1 * dt_min
    n2 = torch.ceil(
        torch.clamp_min(torch.log(f32_const(max(t_b, 1e-30), t0)
                                  / torch.clamp_min(t1, 1e-30)), 0.0)
        / f32_const(log1pf, t0))
    t2 = t1 * torch.exp(n2 * log1pf)
    in1 = k < n1
    in2 = k < n1 + n2
    t_lin1 = t0 + k * dt_min
    t_geo = t1 * torch.exp((k - n1) * log1pf)
    t_lin2 = t2 + (k - n1 - n2) * dt_max
    return torch.where(in1, t_lin1, torch.where(in2, t_geo, t_lin2))


def cell_coords(xyz, scale, grid_size):
    """(..., 3) int64 cell of each position in the single cascade."""
    u = (xyz / f32_const(scale, xyz) + 1.0) * 0.5 * grid_size
    return torch.clamp(u, 0.0, grid_size - 1.0).to(torch.int64)


def occupancy_at(occ_grid, xyz, cascades, scale, grid_size):
    """Per-sample occupancy lookup on the uint8 (C, G, G, G) grid."""
    if cascades != 1:
        raise NotImplementedError(
            "multi-cascade scenes (scale > 0.5) are a later slice")
    n = cell_coords(xyz, scale, grid_size)
    flat = (n[..., 0] * grid_size + n[..., 1]) * grid_size + n[..., 2]
    return occ_grid.reshape(-1)[flat] > 0


def march_rays_test_round(rays_o, rays_d, t_start, t_end, occ_grid, *,
                          cascades, scale, exp_step_factor, grid_size,
                          max_samples, n_samples, chain_length):
    """One inference marching round (reference raymarching.cu:335-454).

    Returns (ts (N, S), deltas (N, S), valid (N, S) bool, t_next (N,),
    n_eff (N,)).  `t_next` is the resume cursor: just past the S-th occupied
    sample, else the chain position after the last examined step.  Slots
    past n_eff hold finite placeholder positions and are not valid."""
    K, S = chain_length, n_samples
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    dev = rays_o.device

    k = torch.arange(K + 1, dtype=torch.float32, device=dev)[None, :]
    ts_all = chain_t(t_start[:, None], k, exp_step_factor, dt_min, dt_max)
    ts = ts_all[:, :K]
    in_range = (ts < t_end[:, None]) & (t_start[:, None] >= 0)
    xyz = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    occ = occupancy_at(occ_grid, xyz, cascades, scale, grid_size) & in_range

    # first-S selection: the (s+1)-th occupied step is the first index
    # where the running count reaches s+1
    csum = torch.cumsum(occ, dim=1)                            # (N, K) int64
    n_eff = torch.clamp_max(csum[:, -1], S)
    s_row = torch.arange(S, device=dev)
    k_idx = torch.searchsorted(
        csum, (s_row + 1).expand(csum.shape[0], S).contiguous())  # (N, S)
    valid = s_row[None, :] < n_eff[:, None]
    ts_s = chain_t(t_start[:, None], k_idx.to(torch.float32),
                   exp_step_factor, dt_min, dt_max)
    dts_s = torch.clamp(ts_s * exp_step_factor, dt_min, dt_max)

    last_k = torch.where(valid, k_idx, -1).amax(dim=1)
    last_t = torch.where(
        n_eff >= S,
        chain_t(t_start, (last_k + 1).to(torch.float32), exp_step_factor,
                dt_min, dt_max),
        ts_all[:, K])
    t_next = torch.minimum(last_t, t_end)
    return ts_s, dts_s, valid, t_next, n_eff


def occupied_span_prep(occ_grid, *, grid_size):
    """Dilated super-grid for `occupied_span`: a supercell of 4^3 cells is
    occupied if any of its cells is, then 3^3 max-pool dilation.  Returns
    (G/4, G/4, G/4) bool; computed once per grid."""
    f = SPAN_SUPER_FACTOR
    SG = grid_size // f
    sup = (occ_grid[0].reshape(SG, f, SG, f, SG, f) > 0).any(dim=5)\
        .any(dim=3).any(dim=1)
    dil = F.max_pool3d(sup[None, None].to(torch.float32), 3, stride=1,
                       padding=1)
    return dil[0, 0] > 0


def occupied_span(rays_o, rays_d, t1, t2, span_grid, *, scale, dt_min):
    """Conservative per-ray bounds [t_s, t_e] of the occupied region
    (single-cascade scenes), from a coarse pre-march over the dilated
    super-grid at half-supercell spacing.  t_s is snapped down to the dt_min
    lattice anchored at t1, so fine-chain positions stay those of the
    unskipped chain.  Returns (t_s, t_e, span_steps), span_steps = 0 when
    nothing is occupied."""
    SG = span_grid.shape[0]
    e = 2.0 * scale / SG
    dt_c = 0.5 * e
    K_c = int(math.ceil(2.0 * scale * SQRT3 / dt_c)) + 2

    k = torch.arange(K_c, dtype=torch.float32, device=rays_o.device)[None, :]
    ts_c = t1[:, None] + (k + 0.5) * dt_c                 # (N, K_c) midpoints
    in_r = (t1[:, None] >= 0) & (ts_c - 0.5 * dt_c < t2[:, None])
    xyz = rays_o[:, None, :] + ts_c[..., None] * rays_d[:, None, :]
    n = cell_coords(xyz, scale, SG)
    occ_c = span_grid[n[..., 0], n[..., 1], n[..., 2]] & in_r

    any_hit = occ_c.any(dim=1)
    occ_u8 = occ_c.to(torch.uint8)
    first_k = torch.argmax(occ_u8, dim=1)
    last_k = K_c - 1 - torch.argmax(occ_u8.flip(1), dim=1)
    t_s = t1 + first_k.to(torch.float32) * dt_c
    t_e = torch.minimum(t2, t1 + (last_k + 1).to(torch.float32) * dt_c)
    dt_min_t = f32_const(dt_min, t1)
    m = torch.floor(torch.clamp_min(t_s - t1, 0.0) / dt_min_t)
    t_s = t1 + m * dt_min
    t_s = torch.where(any_hit, t_s, t2)
    t_e = torch.where(any_hit, t_e, t2)
    span_steps = torch.where(
        any_hit & (t1 >= 0),
        torch.ceil((t_e - t_s) / dt_min_t).to(torch.int64) + 1,
        0)
    return t_s, t_e, span_steps
