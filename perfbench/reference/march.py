"""Plain occupancy-grid ray marching and compositing of ngp_pl's NeRF
(`models/csrc/raymarching.cu`, `volumerendering.cu`), for one cascade with
uniform steps (scale 0.5): the train march into the CSR sample pool and
its compositor, and the test-time march with early termination.

Positions follow the published chain: a ray's k-th step is at
t1 + dt_min (noise + k) (train) or t1 + k dt_min (test), dt_min =
sqrt(3) / 1024, each o + t d rounded once to float32 from float64, and a
step is kept when the grid cell it falls in is occupied.  The train pool
is the JAX package's, which the port keeps: the batch's occupied steps in
(ray, step) order in B x pool_mult slots, the tail of the batch dropping
out at saturation, and the slots past what its first 2 P / 32 non-empty
32-step groups hold repeating the last candidate of the last of those
groups (a defect of that pool that both keep, so that one batch gives one
loss).  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

SQRT3 = math.sqrt(3.0)
MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01
SD_CLAMP = 25.0
EXCL_MAX = 88.0


def dt_min() -> float:
    return SQRT3 / MAX_SAMPLES


def f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def box_hits(rays_o: torch.Tensor, rays_d: torch.Tensor, scale: float):
    """(t1, t2) of each ray's segment in the box [-scale, scale]^3, the near
    end at least NEAR_DISTANCE when it lies in [0, NEAR_DISTANCE), both -1
    on a miss."""
    inv = 1.0 / rays_d
    lo = (-scale - rays_o) * inv
    hi = (scale - rays_o) * inv
    t1 = torch.minimum(lo, hi).amax(dim=-1)
    t2 = torch.maximum(lo, hi).amin(dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    near = torch.clamp_min(t1, 0.0)
    near = torch.where((near >= 0) & (near < NEAR_DISTANCE),
                       torch.full_like(near, NEAR_DISTANCE), near)
    return (torch.where(hit, near, -1.0), torch.where(hit, t2, -1.0))


def positions(t: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """o + t d rounded once to float32 (t (R, K), o, d (R, 3))."""
    return (t.double()[..., None] * d.double()[:, None, :]
            + o.double()[:, None, :]).float()


def occupied(xyz: torch.Tensor, occ_grid: torch.Tensor, scale: float):
    """Occupancy of the grid cell of each position (..., 3)."""
    G = occ_grid.shape[-1]
    u = (xyz / scale + 1.0) * 0.5 * G
    n = torch.clamp(u, 0.0, G - 1.0).to(torch.int64)
    flat = (n[..., 0] * G + n[..., 1]) * G + n[..., 2]
    return occ_grid.reshape(-1)[flat] > 0


def train_pool(rays_o, rays_d, noise, occ_grid, *, scale: float,
               chain: int, pool_mult: int) -> Dict[str, torch.Tensor]:
    """The train march of a batch into its sample pool: per slot its ray
    (N on empty slots), position t, step size and validity, and per ray its
    first slot."""
    N = rays_o.shape[0]
    K = -(-chain // 8) * 8
    P = N * pool_mult
    dt = f32(dt_min())
    t1, t2 = box_hits(rays_o, rays_d, scale)
    t0 = (noise.double() * dt + t1.double()).float()
    k = torch.arange(K, dtype=torch.float64, device=rays_o.device)
    ts = (k[None, :] * dt + t0.double()[:, None]).float()        # (N, K)
    occ = occupied(positions(ts, rays_o, rays_d), occ_grid, scale)
    occ &= (t1 >= 0)[:, None] & (ts >= 0) & (ts < t2[:, None])
    counts = occ.sum(dim=1)
    csum = torch.cumsum(counts, dim=0)
    offsets = csum - counts
    total = min(int(csum[-1]), P)
    running = torch.cumsum(occ.reshape(-1).to(torch.int64), dim=0)
    slot = torch.arange(P, device=rays_o.device)
    valid = slot < total
    src = torch.searchsorted(running, slot + 1)
    # the pool's staging budget: its first 2 P / 32 non-empty groups
    nonempty = occ.reshape(-1, 32).any(dim=1)
    n_groups = nonempty.shape[0]
    g_last = min(int(torch.searchsorted(torch.cumsum(nonempty, dim=0),
                                        max(2 * (P // 32), 1))),
                 n_groups - 1)
    staged = int(running[g_last * 32 + 31])
    src = torch.where(slot < staged, src, g_last * 32 + 31)
    src = torch.where(valid, src, 0)
    ray = src // K
    t = (((src % K).double() * dt + t0.double()[ray]).float())
    return {"ray": torch.where(valid, ray, N),
            "t": torch.where(valid, t, 0.0),
            "delta": torch.full((P,), dt_min(), device=rays_o.device),
            "valid": valid, "offsets": offsets, "total": total}


def composite_pool(sigma, rgb, pool, n_rays: int, t_threshold: float):
    """Front-to-back compositing of the pool (opacity (N,), rgb (N, 3)):
    each ray's transmittance from its samples' optical depths before the
    sample (summed in float64 over the pool, less its first slot's), a
    sample counting while its transmittance is above the threshold."""
    valid, ray = pool["valid"], pool["ray"]
    sd = torch.where(valid, torch.clamp_max(sigma * pool["delta"], SD_CLAMP),
                     0.0)
    c = torch.cumsum(sd, dim=0, dtype=torch.float64).to(sd.dtype)
    excl = c - sd
    P = sd.shape[0]
    base = excl.index_select(0, torch.clamp(pool["offsets"], 0, P - 1))
    excl = torch.clamp(excl - base.index_select(
        0, torch.clamp(ray, 0, n_rays - 1)), 0.0, EXCL_MAX)
    T = torch.exp(-excl)
    alpha = 1.0 - torch.exp(-sd)
    w = torch.where(valid & (T > t_threshold), alpha * T, 0.0)
    seg = torch.where(valid, ray, n_rays)
    sums = torch.zeros((n_rays + 1, 4), dtype=w.dtype, device=w.device)
    sums = sums.index_add(0, seg, torch.cat([w[:, None], w[:, None] * rgb],
                                            dim=1))[:-1]
    return sums[:, 0], sums[:, 1:]


@torch.no_grad()
def test_samples(rays_o, rays_d, occ_grid, *, scale: float,
                 start: torch.Tensor, n: int):
    """The next `n` occupied steps of each ray from step index `start`
    (R,) on: (t (R, n), valid (R, n), the step index to resume from (R,)).
    Steps run from the box entry t1 at dt_min, at most MAX_SAMPLES
    occupied ones a ray."""
    R = rays_o.shape[0]
    dev = rays_o.device
    dt = dt_min()
    t1, t2 = box_hits(rays_o, rays_d, scale)
    K = MAX_SAMPLES + 1
    out_t = torch.zeros((R, n), device=dev)
    out_v = torch.zeros((R, n), dtype=torch.bool, device=dev)
    nxt = start.clone()
    chunk = 256
    filled = torch.zeros(R, dtype=torch.int64, device=dev)
    k0 = 0
    while k0 < K:
        k = torch.arange(k0, min(k0 + chunk, K), device=dev,
                         dtype=torch.float64)
        t = (t1.double()[:, None] + k[None, :] * dt).float()
        occ = occupied(positions(t, rays_o, rays_d), occ_grid, scale)
        occ &= (t1 >= 0)[:, None] & (t < t2[:, None])
        occ &= (k[None, :] >= start.double()[:, None])
        rank = filled[:, None] + torch.cumsum(occ.to(torch.int64), dim=1) - 1
        take = occ & (rank < n)
        r_idx, c_idx = torch.nonzero(take, as_tuple=True)
        out_t[r_idx, rank[r_idx, c_idx]] = t[r_idx, c_idx]
        out_v[r_idx, rank[r_idx, c_idx]] = True
        last = torch.where(take, k[None, :].long() + 1, 0).amax(dim=1)
        nxt = torch.where(last > 0, last, nxt)
        filled += take.sum(dim=1)
        k0 += chunk
        if bool((filled >= n).all()):
            break
    done = filled < n                    # no occupied step left
    return out_t, out_v, torch.where(done, torch.full_like(nxt, K), nxt)
