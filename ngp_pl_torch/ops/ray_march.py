"""Occupancy-guided ray marching (counterpart of the test round, the occupied
span and the windowed train marches, CSR and strided, of
ngp_pl_tpu/ops/ray_march.py; reference models/csrc/raymarching.cu).

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

The train marches, and the test round as the train rounds call it (with
`win_rows`), must give the JAX package's samples bit for bit: one ulp at a
cell edge flips an occupancy bit and shifts every later slot.  XLA fuses
`t0 + k * dt_min` and `o + t * d` into fused multiply-adds (one rounding);
`_fma` reproduces that on both devices in float64, where these products and
sums are exact, and rounds once to float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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
                          max_samples, n_samples, chain_length,
                          win_rows=None):
    """One inference marching round (reference raymarching.cu:335-454).

    Returns (ts (N, S), deltas (N, S), valid (N, S) bool, t_next (N,),
    n_eff (N,)).  `t_next` is the resume cursor: just past the S-th occupied
    sample, else the chain position after the last examined step.  Slots
    past n_eff hold finite placeholder positions and are not valid.

    With `win_rows` (single cascade, uniform steps, chain a multiple of 8;
    the train rounds) the bits come from `_occ_window_chain` and every
    chain position is one fused multiply-add, as in the JAX package's
    windowed branch (ngp_pl_tpu/ops/ray_march.py:213-227), so valid, n_eff
    and t_next are its bits; `occ_grid` is then unused."""
    K, S = chain_length, n_samples
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    dev = rays_o.device

    if win_rows is not None:
        if cascades != 1 or exp_step_factor != 0.0 or K % SEGMENT_J:
            raise NotImplementedError(
                "the windowed round covers single-cascade, uniform-step "
                "scenes with a chain that is a multiple of 8")

        def chain(t0, k):
            return _fma(k, _f32(dt_min), t0)
    else:
        def chain(t0, k):
            return chain_t(t0, k, exp_step_factor, dt_min, dt_max)

    k = torch.arange(K + 1, dtype=torch.float32, device=dev)[None, :]
    ts_all = chain(t_start[:, None], k)
    ts = ts_all[:, :K]
    in_range = (ts < t_end[:, None]) & (t_start[:, None] >= 0)
    if win_rows is not None:
        occ, _ = _occ_window_chain(rays_o, rays_d, t_start, K // SEGMENT_J,
                                   win_rows, scale=scale,
                                   grid_size=grid_size, dt_min=dt_min)
        occ = occ.reshape(-1, K) & in_range
    else:
        xyz = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
        occ = occupancy_at(occ_grid, xyz, cascades, scale, grid_size) \
            & in_range

    # first-S selection: the (s+1)-th occupied step is the first index
    # where the running count reaches s+1
    csum = torch.cumsum(occ, dim=1)                            # (N, K) int64
    n_eff = torch.clamp_max(csum[:, -1], S)
    s_row = torch.arange(S, device=dev)
    k_idx = torch.searchsorted(
        csum, (s_row + 1).expand(csum.shape[0], S).contiguous())  # (N, S)
    valid = s_row[None, :] < n_eff[:, None]
    ts_s = chain(t_start[:, None], k_idx.to(torch.float32))
    dts_s = torch.clamp(ts_s * exp_step_factor, dt_min, dt_max)

    last_k = torch.where(valid, k_idx, -1).amax(dim=1)
    # the cursor past the S-th sample is two roundings in the JAX package
    # with or without windows: XLA does not fuse this product and sum,
    # which follow a reduction
    last_t = torch.where(
        n_eff >= S, chain_t(t_start, (last_k + 1).to(torch.float32),
                            exp_step_factor, dt_min, dt_max),
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


# ---------------------------------------------------------------------------
# Windowed train march (ngp_pl_tpu/ops/ray_march.py:401-591, 741-863)
# ---------------------------------------------------------------------------

SEGMENT_J = 8   # fine chain steps per window interval
WIN_B = 4       # window anchor stride in cells
WIN_P = 8       # window extent in cells per axis (8^3 bits = 16 words)
WIN_APRON = 2   # window w covers cells [4w - 2, 4w + 6) per axis
WIN_WORDS = WIN_P ** 3 // 32


class MarchResults(NamedTuple):
    """Flat sample pool ordered by (ray, t), the CSR layout of the JAX
    package's `MarchResults`."""

    ts: torch.Tensor             # (P,) sample distance along its ray
    deltas: torch.Tensor         # (P,) integration interval
    ray_idx: torch.Tensor        # (P,) int64 owning ray; == N in unused slots
    valid: torch.Tensor          # (P,) bool slot validity
    counts: torch.Tensor         # (N,) samples of each ray in the pool
    offsets: torch.Tensor        # (N,) start slot of each ray
    total: torch.Tensor          # () samples in the pool
    rm_counts: torch.Tensor      # (N,) samples found by marching (pre-clip)
    chain_demand: torch.Tensor   # () chain steps the batch needs
    chain_demand_q: torch.Tensor  # () 99th percentile of the per-ray need


def _f32(v: float) -> float:
    """The float32 value of a Python constant, as a Python float."""
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding to float32 (XLA's fused multiply-add).
    For the march's operands (chain steps k < 2^12 times dt_min, positions
    and directions of order 1) the float64 product and sum are exact."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def occupancy_windows(occ_grid: torch.Tensor) -> torch.Tensor:
    """(C, G, G, G) uint8 -> (C*(G/4)^3, 16) int32 packed 8^3-cell windows.

    Window w = (wx, wy, wz) covers cells [4w - 2, 4w + 6) per axis, zero
    outside the grid; bit (lx*8 + ly)*8 + lz of its 512 is cell
    4w - 2 + (lx, ly, lz), stored as bit b % 32 of word b // 32.  The words
    are the JAX package's uint32 windows (`occupancy_windows`, built there
    from bit-packed z-lines) read as int32."""
    C, G = occ_grid.shape[0], occ_grid.shape[1]
    NW = G // WIN_B
    hi = WIN_P - WIN_B - WIN_APRON
    occ = F.pad((occ_grid > 0).to(torch.int32),
                (WIN_APRON, hi, WIN_APRON, hi, WIN_APRON, hi))
    win = (occ.unfold(1, WIN_P, WIN_B).unfold(2, WIN_P, WIN_B)
           .unfold(3, WIN_P, WIN_B))              # (C, NW, NW, NW, 8, 8, 8)
    bits = win.reshape(C * NW ** 3, WIN_WORDS, 2, 16)
    shift = torch.arange(16, dtype=torch.int32, device=occ_grid.device)
    halves = (bits << shift).sum(dim=-1, dtype=torch.int64)   # 16-bit halves
    words = halves[..., 0] + (halves[..., 1] << 16)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def segment_march_dmax_ok(directions, grid_size: int = 128,
                          max_samples: int = 1024,
                          scale: float = 0.5) -> bool:
    """True if the fine steps of one 8-step interval stay within one world
    cell of its midpoint, so one window holds every step's bit
    (ngp_pl_tpu/ops/ray_march.py:703-721)."""
    d = np.asarray(directions)
    dmax = float(np.sqrt((d * d).sum(axis=-1)).max())
    cell = 2.0 * scale / grid_size
    dt_min = SQRT3 / max_samples
    return (SEGMENT_J - 1) / 2 * dt_min * dmax < cell


def _cells(t, rays_o, rays_d, scale, grid_size):
    """Per-axis int32 cells of the positions o + t * d (fused like XLA)."""
    out = []
    for a in range(3):
        xyz = _fma(t, rays_d[:, a].reshape((-1,) + (1,) * (t.dim() - 1)),
                   rays_o[:, a].reshape((-1,) + (1,) * (t.dim() - 1)))
        u = (xyz / f32_const(scale, xyz) + 1.0) * 0.5 * grid_size
        out.append(torch.clamp(u, 0.0, grid_size - 1.0).to(torch.int32))
    return out


def _occ_window_chain(rays_o, rays_d, t0, KA, win_rows, *, scale, grid_size,
                      dt_min):
    """Occupancy bits (N, KA, J) and positions ts (N, KA, J) of KA*J uniform
    chain steps from t0, one window per 8-step interval, anchored at the
    4^3 brick of the interval midpoint (ray_march.py:478-514)."""
    dev = rays_o.device
    J = SEGMENT_J
    NW = grid_size // WIN_B
    dt = _f32(dt_min)
    c = torch.arange(KA, dtype=torch.float32, device=dev)[None, :]
    m_t = _fma(c * J + 0.5 * (J - 1), dt, t0[:, None])          # (N, KA)
    wx, wy, wz = (n >> 2 for n in _cells(m_t, rays_o, rays_d, scale,
                                         grid_size))
    widx = ((wx * NW + wy) * NW + wz).to(torch.int64)

    kk = torch.arange(KA * J, dtype=torch.float32, device=dev).reshape(
        1, KA, J)
    ts = _fma(kk, dt, t0[:, None, None])                         # (N, KA, J)
    local = [torch.clamp(n - ((w[:, :, None] << 2) - WIN_APRON), 0, WIN_P - 1)
             for n, w in zip(_cells(ts, rays_o, rays_d, scale, grid_size),
                             (wx, wy, wz))]
    bit = (local[0] * WIN_P + local[1]) * WIN_P + local[2]
    word = win_rows.reshape(-1)[widx[:, :, None] * WIN_WORDS + (bit >> 5)]
    return ((word >> (bit & 31)) & 1) > 0, ts


def qtile(per_ray_need: torch.Tensor, q: float) -> torch.Tensor:
    """q-th percentile of a per-ray integer demand vector
    (ray_march.py:1132-1141)."""
    n = per_ray_need.shape[0]
    k = max(int(q * n) - 1, 0)
    return torch.sort(per_ray_need).values[k]


def q99(per_ray_need: torch.Tensor) -> torch.Tensor:
    return qtile(per_ray_need, 0.99)


def _compact_to_pool(occ, t0, max_samples, pool_size, dt_min):
    """Compaction of the occupied candidates (N, K) into a flat pool of
    `pool_size` slots ordered by (ray, t) (ray_march.py:741-863).

    Slot p holds the (p+1)-th occupied candidate in (ray, step) order,
    found by a sorted search of the running count; at saturation the tail
    of the batch drops out.

    The JAX package stages only the first `blocks = 2 * (P // GRP)`
    non-empty groups of GRP candidates (GRP = 32, halved while K % GRP).
    Slots past the samples those groups hold (when groups hold fewer than
    ~16 samples on average, as in grid warmup) take the last staged group:
    its ray, and chain step kb[3] + 7: there j is at least the group's
    popcount, so the reference's branch-free `_nth_set_bit(bits, j)` goes
    high at every step and gives bitpos 31, ksub 3 and bitpos & 7 = 7
    (ray_march.py:724-738, 845-850); kb[3] is the chain step of lane 24 of
    the group, zero padding when GRP < 32 (ray_march.py:800-850).  So those slots repeat one position.
    That is a defect of the reference; the port reproduces it so that both
    give the same pool, loss and gradients (ROADMAP, reference defects)."""
    N, K = occ.shape
    if K <= max_samples:
        rm_counts = occ.sum(dim=1, dtype=torch.int32)
    else:
        incl = torch.cumsum(occ.to(torch.int32), dim=1, dtype=torch.int32)
        occ = occ & (incl - occ.to(torch.int32) < max_samples)
        rm_counts = torch.clamp_max(incl[:, -1], max_samples)
    csum = torch.cumsum(rm_counts, dim=0, dtype=torch.int32)
    offsets = csum - rm_counts
    total = torch.clamp_max(csum[-1], pool_size)

    P = pool_size
    running = torch.cumsum(occ.reshape(-1).to(torch.int32), dim=0,
                           dtype=torch.int32)
    slot = torch.arange(P, dtype=torch.int32, device=occ.device)
    valid = slot < total
    src = torch.searchsorted(running, slot + 1)

    # the staging budget: g_last is the last staged group (the blocks-th
    # non-empty one; the last group when fewer are non-empty, and then the
    # staged groups hold every sample)
    grp = 32
    while K % grp:
        grp //= 2
    NG = N * K // grp
    nonempty = occ.reshape(NG, grp).any(dim=1)
    g_last = torch.clamp_max(torch.searchsorted(
        torch.cumsum(nonempty, dim=0, dtype=torch.int32),
        max(2 * (P // grp), 1)), NG - 1)
    # a (1,) index: a 0-dim one would be read on the host
    staged = running[(g_last * grp + (grp - 1)).reshape(1)]
    # flat (ray, kb[ksub]) of the group, ksub = 31 >> 3 = 3: lane 24, or
    # step 0 of its ray when GRP < 32; then bitpos & 7 = 7
    kb3 = g_last * grp + 24 if grp == 32 else (g_last // (K // grp)) * K
    src = torch.where(slot < staged, src, kb3 + 7)
    src = torch.where(valid, src, 0)
    ray = src // K
    k = (src % K).to(torch.float32)
    ts = torch.where(valid, _fma(k, _f32(dt_min), t0[ray]), 0.0)
    ray_idx = torch.where(valid, ray, N)
    deltas = torch.full((P,), dt_min, dtype=torch.float32, device=occ.device)
    in_pool = torch.minimum(torch.clamp_min(total - offsets, 0), rm_counts)
    return ts, deltas, ray_idx, valid, in_pool, offsets, total, rm_counts


def march_rays_train_window(rays_o, rays_d, hits_t, noise, win_rows, *,
                            scale: float, grid_size: int, max_samples: int,
                            pool_size: int, chain_length: int) -> MarchResults:
    """Windowed occupancy march of a train batch (single cascade, uniform
    steps; ray_march.py:517-591): the chain from t1 + dt_min * noise, cut
    into 8-step intervals whose bits come from one 64-byte window each,
    then compacted into the pool.  Valid under `segment_march_dmax_ok`."""
    N = rays_o.shape[0]
    J = SEGMENT_J
    K = -(-chain_length // J) * J
    dt_min = SQRT3 / max_samples
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    t0 = _fma(noise, _f32(dt_min), t1)
    occ, ts = _occ_window_chain(rays_o, rays_d, t0, K // J, win_rows,
                                scale=scale, grid_size=grid_size,
                                dt_min=dt_min)
    ts = ts.reshape(N, K)
    in_range = hit[:, None] & (ts >= 0) & (ts < t2[:, None])
    occ = occ.reshape(N, K) & in_range
    del ts, in_range

    kk1 = torch.arange(1, K + 1, dtype=torch.int32, device=occ.device)
    per_ray_need = torch.where(occ, kk1, 0).amax(dim=1)
    pool = _compact_to_pool(occ, t0, max_samples, pool_size, dt_min)
    return MarchResults(*pool[:4], counts=pool[4], offsets=pool[5],
                        total=pool[6], rm_counts=pool[7],
                        chain_demand=per_ray_need.max(),
                        chain_demand_q=q99(per_ray_need))


class StridedMarch(NamedTuple):
    """Per-ray strided sample block of the JAX package's `StridedMarch`:
    ray r owns row r of each (N, S) array, its first S occupied samples
    front to back; a ray with more is cut, never dropped by the batch."""

    ts: torch.Tensor             # (N, S) sample distances, 0 on invalid slots
    deltas: torch.Tensor         # (N, S)
    valid: torch.Tensor          # (N, S) bool
    counts: torch.Tensor         # (N,) samples kept (<= S)
    rm_counts: torch.Tensor      # (N,) occupied samples found (pre-clip)
    total: torch.Tensor          # () kept samples of the batch
    chain_demand: torch.Tensor   # () chain steps the batch needs
    chain_demand_q: torch.Tensor  # () 99th percentile of the per-ray need


def march_rays_train_strided(rays_o, rays_d, hits_t, noise, win_rows, *,
                             scale: float, grid_size: int, max_samples: int,
                             n_samples: int,
                             chain_length: int) -> StridedMarch:
    """Windowed occupancy march of a train batch into the strided (N, S)
    layout (ngp_pl_tpu/ops/ray_march.py:1040-1131, its single-cascade,
    uniform-step window branch): the chain of `march_rays_train_window`,
    rounded up to 32 steps, and per ray the first S occupied steps, found
    by a cumsum and a sorted search where the TPU counts bits in groups.
    Valid under `segment_march_dmax_ok`."""
    N = rays_o.shape[0]
    S = n_samples
    K = -(-chain_length // 32) * 32
    dt_min = SQRT3 / max_samples
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    t0 = _fma(noise, _f32(dt_min), t1)
    occ, ts_all = _occ_window_chain(rays_o, rays_d, t0, K // SEGMENT_J,
                                    win_rows, scale=scale,
                                    grid_size=grid_size, dt_min=dt_min)
    ts_all = ts_all.reshape(N, K)
    occ = occ.reshape(N, K) & hit[:, None] & (ts_all >= 0) & (
        ts_all < t2[:, None])
    del ts_all

    kk1 = torch.arange(1, K + 1, dtype=torch.int32, device=occ.device)
    per_ray_need = torch.where(occ, kk1, 0).amax(dim=1)
    csum = torch.cumsum(occ, dim=1)                             # (N, K)
    rm_counts = csum[:, -1].to(torch.int32)
    counts = torch.clamp_max(rm_counts, S)
    s_row = torch.arange(S, device=occ.device)
    k_idx = torch.searchsorted(
        csum, (s_row + 1).expand(N, S).contiguous())            # K if none
    valid = s_row[None, :] < counts[:, None]
    ts = torch.where(valid, _fma(k_idx.to(torch.float32), _f32(dt_min),
                                 t0[:, None]), 0.0)
    deltas = torch.full((N, S), dt_min, dtype=torch.float32,
                        device=occ.device)
    return StridedMarch(ts=ts, deltas=deltas, valid=valid, counts=counts,
                        rm_counts=rm_counts,
                        total=counts.sum(dtype=torch.int32),
                        chain_demand=per_ray_need.max(),
                        chain_demand_q=q99(per_ray_need))
