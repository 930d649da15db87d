"""Occupancy-guided ray marching (counterpart of the test round, the occupied
span and the train marches, CSR and strided, of
ngp_pl_tpu/ops/ray_march.py; reference models/csrc/raymarching.cu), for
one cascade with uniform steps and for the multi-cascade scenes with
exponential steps (scale > 0.5).

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
sums are exact, and rounds once to float32.  Under exponential steps the
chain also takes an `exp` and a `log`, and the cascade picks a `log2`:
each goes through float64 and is rounded once to float32 (`_exp`, `_log`,
`_floor_log2`), so it is correctly rounded and the same on the card and
on the CPU.  torch's float32 exp on the card and on the CPU differ by an
ulp on some arguments, which moves a geometric step, and at a cell edge
the march, between the two (`benchmarking/exp_chain_probe.py`).  XLA's
CPU exp is not correctly rounded either: against the JAX package a
position may differ by an ulp, and a bit only at a cell edge.
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


def _exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp, correctly rounded on either device (through float64)."""
    return torch.exp(x.double()).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 log, correctly rounded on either device (through float64)."""
    return torch.log(x.double()).float()


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of float32 x > 0, from the correctly rounded float32
    log2 (through float64), the same on either device."""
    return torch.floor(torch.log2(x.double()).float()).to(torch.int64)


def chain_t(t0, k, exp_step_factor, dt_min, dt_max, fused=False):
    """Closed-form t_k of the dt-chain starting at t0 (broadcasting t0 and
    the float step indices k; ray_march.py:65-91).  Uniform steps take
    one rounding with `fused` (XLA's fused multiply-add) and two without;
    the exponential branch's linear phases are always fused, as XLA fuses
    them, and its powers go through `_exp`."""
    if exp_step_factor == 0.0:
        return _fma(k, _f32(dt_min), t0) if fused else t0 + k * dt_min
    f = exp_step_factor
    log1pf = math.log1p(f)
    t_a = dt_min / f   # below: dt = dt_min
    t_b = dt_max / f   # above: dt = dt_max
    n1 = torch.ceil(torch.clamp_min(t_a - t0, 0.0) / f32_const(dt_min, t0))
    t1 = _fma(n1, _f32(dt_min), t0)
    n2 = torch.ceil(
        torch.clamp_min(_log(f32_const(max(t_b, 1e-30), t0)
                             / torch.clamp_min(t1, 1e-30)), 0.0)
        / f32_const(log1pf, t0))
    t2 = t1 * _exp(n2 * log1pf)
    in1 = k < n1
    in2 = k < n1 + n2
    t_lin1 = _fma(k, _f32(dt_min), t0)
    t_geo = t1 * _exp((k - n1) * log1pf)
    t_lin2 = _fma(k - n1 - n2, _f32(dt_max), t2)
    return torch.where(in1, t_lin1, torch.where(in2, t_geo, t_lin2))


def cell_coords(xyz, scale, grid_size):
    """(..., 3) int64 cell of each position in the single cascade."""
    u = (xyz / f32_const(scale, xyz) + 1.0) * 0.5 * grid_size
    return torch.clamp(u, 0.0, grid_size - 1.0).to(torch.int64)


def mip_from_pos(xyz, cascades):
    """Cascade of a position by its magnitude (ray_march.py:94-101,
    raymarching.cu:19-23): |x| in [0, .5) -> 0, [.5, 1) -> 1, [1, 2) -> 2,
    ..."""
    mx = torch.amax(torch.abs(xyz), dim=-1)
    e = _floor_log2(torch.clamp_min(mx, 1e-10)) + 2
    return torch.clamp(e, 0, cascades - 1)


def mip_from_dt(dt, grid_size, cascades):
    """Cascade of a step size (ray_march.py:104-107, raymarching.cu:28-32)."""
    e = _floor_log2(torch.clamp_min(dt * grid_size, 1e-10)) + 1
    return torch.clamp(e, 0, cascades - 1)


def _mip_bound(mip, scale):
    """Half-width of cascade `mip`'s box: min(2^(mip - 1), scale)."""
    return torch.clamp_max(torch.exp2(mip.to(torch.float32) - 1.0), scale)


def grid_coords(xyz, dt, cascades, scale, grid_size):
    """(mip, n): the cascade and int64 cell of each position
    (ray_march.py:110-126): the larger of the position's and the step's
    cascade, one cascade at scale <= 0.5."""
    if cascades == 1:
        return (torch.zeros(xyz.shape[:-1], dtype=torch.int64,
                            device=xyz.device),
                cell_coords(xyz, scale, grid_size))
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    u = (xyz / _mip_bound(mip, scale)[..., None] + 1.0) * 0.5 * grid_size
    return mip, torch.clamp(u, 0.0, grid_size - 1.0).to(torch.int64)


def occupancy_at(occ_grid, xyz, dt, cascades, scale, grid_size):
    """Per-sample occupancy lookup on the uint8 (C, G, G, G) grid at the
    cascade that position and step size pick (ray_march.py:129-138)."""
    mip, n = grid_coords(xyz, dt, cascades, scale, grid_size)
    flat = (((mip * grid_size + n[..., 0]) * grid_size + n[..., 1])
            * grid_size + n[..., 2])
    return occ_grid.reshape(-1)[flat] > 0


def occupancy_at_lines(occ_rows, mip, n, grid_size):
    """Occupancy from the bit-packed z-lines of `occupancy_lines` at cells
    (mip, n) of any cascade (ray_march.py:158-172): bit nz % 32 of word
    nz // 32 of line (mip G + nx) G + ny."""
    G = grid_size
    line = (mip * G + n[..., 0]) * G + n[..., 1]
    nz = n[..., 2]
    word = occ_rows[line, nz >> 5].to(torch.int64)
    return ((word >> (nz & 31)) & 1) > 0


def march_rays_test_round(rays_o, rays_d, t_start, t_end, occ_grid, *,
                          cascades, scale, exp_step_factor, grid_size,
                          max_samples, n_samples, chain_length,
                          win_rows=None):
    """One inference marching round (reference raymarching.cu:335-454).

    Returns (ts (N, S), deltas (N, S), valid (N, S) bool, t_next (N,),
    n_eff (N,)).  `t_next` is the resume cursor: just past the S-th occupied
    sample, else the chain position after the last examined step.  Slots
    past n_eff hold finite placeholder positions and are not valid.

    The JAX package's dispatch (ngp_pl_tpu/ops/ray_march.py:213-240):
    with `win_rows` and a single cascade, uniform steps and a chain that
    is a multiple of 8 (the train rounds) the bits come from
    `_occ_window_chain` and every chain position is one fused
    multiply-add, so valid, n_eff and t_next are its bits; with `win_rows`
    under multi-cascade or exponential steps and a chain that is a
    multiple of 4, from the two-window chain `_occ_window_chain_mc`
    (conservative where a step leaves its windows); otherwise from the
    grid `occ_grid` at each step's cascade."""
    K, S = chain_length, n_samples
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    dev = rays_o.device
    use_window = (win_rows is not None and exp_step_factor == 0.0
                  and cascades == 1 and K % SEGMENT_J == 0)
    use_window_mc = (win_rows is not None and not use_window
                     and (cascades > 1 or exp_step_factor > 0.0)
                     and K % J_MC == 0)

    def chain(t0, k):
        return chain_t(t0, k, exp_step_factor, dt_min, dt_max,
                       fused=use_window)

    k = torch.arange(K + 1, dtype=torch.float32, device=dev)[None, :]
    ts_all = chain(t_start[:, None], k)
    ts = ts_all[:, :K]
    in_range = (ts < t_end[:, None]) & (t_start[:, None] >= 0)
    if use_window:
        occ, _ = _occ_window_chain(rays_o, rays_d, t_start, K // SEGMENT_J,
                                   win_rows, scale=scale,
                                   grid_size=grid_size, dt_min=dt_min)
        occ = occ.reshape(-1, K) & in_range
    elif use_window_mc:
        occ, _, _ = _occ_window_chain_mc(
            rays_o, rays_d, t_start, K // J_MC, win_rows,
            cascades=cascades, scale=scale, grid_size=grid_size,
            exp_step_factor=exp_step_factor, dt_min=dt_min, dt_max=dt_max)
        occ = occ & in_range
    else:
        dts = torch.clamp(ts * exp_step_factor, dt_min, dt_max)
        xyz = (_positions(ts, rays_o, rays_d) if exp_step_factor > 0.0
               else rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :])
        occ = occupancy_at(occ_grid, xyz, dts, cascades, scale,
                           grid_size) & in_range

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
    per_ray_need: torch.Tensor   # (N,) int32 one past each ray's last
    #                              occupied chain step (0 for none)


def _f32(v: float) -> float:
    """The float32 value of a Python constant, as a Python float."""
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding to float32 (XLA's fused multiply-add).
    For the march's operands (chain steps k < 2^12 times dt_min, positions
    and directions of order 1) the float64 product and sum are exact.
    Autograd passes the casts: the gradient to b is g * a and to c is g,
    each rounded once to float32, as XLA's backward of the product."""
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
    return _as_int32(words)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same 32 bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


_U32 = 0xFFFFFFFF


def occupancy_lines(occ_grid: torch.Tensor) -> torch.Tensor:
    """(C, G, G, G) uint8 -> (C*G*G, ceil(G/32)) int32 bit-packed z-lines:
    bit z % 32 of word z // 32 of row (c*G + x)*G + y is cell (x, y, z) of
    cascade c (ngp_pl_tpu/ops/ray_march.py:141-156).  The words are the
    JAX package's uint32 rows read as int32.  No march of the port reads
    them; full checkpoints carry them for the JAX package."""
    C, G = occ_grid.shape[0], occ_grid.shape[1]
    W = max(1, (G + 31) // 32)
    flat = occ_grid.reshape(C * G * G, G)
    if W * 32 != G:
        flat = F.pad(flat, (0, W * 32 - G))
    bits = (flat.reshape(C * G * G, W, 32) > 0).to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=occ_grid.device)
    return _as_int32((bits << shift).sum(dim=-1))


def dilate_lines(occ_rows: torch.Tensor, cascades: int,
                 grid_size: int) -> torch.Tensor:
    """3x3x3 binary dilation of the bit-packed z-lines, per cascade
    (ngp_pl_tpu/ops/ray_march.py:372-400): z by shifts with carries across
    words, then y and x by neighbouring rows.  int32 words in and out; the
    shifts run on their unsigned values in int64."""
    G = grid_size
    a = occ_rows.to(torch.int64) & _U32
    W = a.shape[-1]
    zero = torch.zeros_like(a[:, :1])
    hi = torch.cat([zero, a[:, :-1] >> 31], dim=1)
    lo = torch.cat([(a[:, 1:] << 31) & _U32, zero], dim=1)
    a = a | ((a << 1) & _U32) | hi | (a >> 1) | lo
    for shape in ((cascades * G, G, W), (cascades, G, G, W)):
        a = a.reshape(shape)
        zero = torch.zeros_like(a[:, :1])
        a = (a | torch.cat([zero, a[:, :-1]], dim=1)
             | torch.cat([a[:, 1:], zero], dim=1))
    return _as_int32(a.reshape(cascades * G * G, W))


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


def _positions(t, rays_o, rays_d):
    """(..., 3) positions o + t * d of chain positions t (N, ...), fused
    like XLA."""
    shape = (-1,) + (1,) * (t.dim() - 1)
    return torch.stack([_fma(t, rays_d[:, a].reshape(shape),
                             rays_o[:, a].reshape(shape))
                        for a in range(3)], dim=-1)


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


J_MC = 4        # chain steps per interval of the multi-cascade windows


def _occ_window_chain_mc(rays_o, rays_d, t0, KA, win_rows, *, cascades,
                         scale, grid_size, exp_step_factor, dt_min, dt_max):
    """Occupancy bits, positions and step sizes (each (N, KA*J)) of KA*J
    chain steps from t0 under multi-cascade / exponential steps, two
    windows per 4-step interval (ray_march.py:597-681).

    Each step's cascade is the larger of its position's and its step
    size's.  Per interval one window is gathered at the interval's lowest
    cascade and one at its highest, each anchored at the 4^3 brick of the
    interval midpoint in that cascade's cells; a step reads its bit from
    the window of its own cascade.  A step whose cascade lies strictly
    between the two, or whose cell falls outside the gathered window,
    counts as occupied: a conservative extra sample, never a missed one.
    These fallbacks are the JAX package's, bit for bit."""
    N = rays_o.shape[0]
    J = J_MC
    G = grid_size
    NW = G // WIN_B
    f = exp_step_factor
    dev = rays_o.device
    kk = torch.arange(KA * J, dtype=torch.float32, device=dev)[None, :]
    ts = chain_t(t0[:, None], kk, f, dt_min, dt_max,
                 fused=True).reshape(N, KA, J)
    dts = torch.clamp(ts * f, dt_min, dt_max)
    xyz = _positions(ts, rays_o, rays_d)                     # (N, KA, J, 3)
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dts, G, cascades))       # (N, KA, J)
    mip_lo = mip.amin(dim=2)
    mip_hi = mip.amax(dim=2)
    k_mid = (torch.arange(KA, dtype=torch.float32, device=dev) * J
             + 0.5 * (J - 1))[None, :]
    t_mid = chain_t(t0[:, None], k_mid, f, dt_min, dt_max, fused=True)
    xyz_mid = _positions(t_mid, rays_o, rays_d)              # (N, KA, 3)
    words = win_rows.reshape(-1)

    def bits_at(m_sel):
        bound = _mip_bound(m_sel, scale)                     # (N, KA)
        u_mid = (xyz_mid / bound[..., None] + 1.0) * 0.5 * G
        w = torch.clamp(u_mid, 0.0, G - 1.0).to(torch.int64) >> 2
        widx = ((m_sel * NW + w[..., 0]) * NW + w[..., 1]) * NW + w[..., 2]
        u = (xyz / bound[..., None, None] + 1.0) * 0.5 * G
        n = torch.clamp(u, 0.0, G - 1.0).to(torch.int64)     # (N, KA, J, 3)
        local = n - ((w[:, :, None, :] << 2) - WIN_APRON)
        inwin = ((local >= 0) & (local < WIN_P)).all(dim=-1)
        lc = torch.clamp(local, 0, WIN_P - 1)
        bit = (lc[..., 0] * WIN_P + lc[..., 1]) * WIN_P + lc[..., 2]
        word = words[widx[:, :, None] * WIN_WORDS + (bit >> 5)].to(
            torch.int64)
        got = ((word >> (bit & 31)) & 1) > 0
        return torch.where(inwin, got, True)

    occ = torch.where(mip == mip_lo[..., None], bits_at(mip_lo),
                      torch.where(mip == mip_hi[..., None], bits_at(mip_hi),
                                  True))
    return (occ.reshape(N, KA * J), ts.reshape(N, KA * J),
            dts.reshape(N, KA * J))


def window_march_mc_ok(directions, exp_step_factor: float,
                       cascades: int) -> bool:
    """Whether the multi-cascade windowed march applies
    (ray_march.py:684-700): not for single-cascade uniform steps (the
    8-step windows do), nor for exp factors above 1/64 or directions
    longer than 2, where the conservative fallbacks would be everywhere."""
    if cascades <= 1 and exp_step_factor == 0.0:
        return False
    if exp_step_factor > 1.0 / 64.0:
        return False
    d = np.asarray(directions)
    return float(np.sqrt((d * d).sum(axis=-1)).max()) <= 2.0


def qtile(per_ray_need: torch.Tensor, q: float) -> torch.Tensor:
    """q-th percentile of a per-ray integer demand vector
    (ray_march.py:1132-1141)."""
    n = per_ray_need.shape[0]
    k = max(int(q * n) - 1, 0)
    return torch.sort(per_ray_need).values[k]


def q99(per_ray_need: torch.Tensor) -> torch.Tensor:
    return qtile(per_ray_need, 0.99)


def _compact_to_pool(occ, t0, max_samples, pool_size, dt_min,
                     exp_step_factor=0.0, dt_max=0.0):
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
    give the same pool, loss and gradients (ROADMAP, reference defects).

    A slot's position is the chain's at its step from its ray's t0, the
    same expression as the candidates' (`chain_t`, fused), and its delta
    the step size there: dt_min under uniform steps, clamp(t f, dt_min,
    dt_max) under exponential ones (ray_march.py:853-858)."""
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
    f = exp_step_factor
    ts = torch.where(valid, chain_t(t0[ray], k, f, dt_min, dt_max,
                                    fused=True), 0.0)
    ray_idx = torch.where(valid, ray, N)
    deltas = (torch.clamp(ts * f, dt_min, dt_max) if f > 0.0 else
              torch.full((P,), dt_min, dtype=torch.float32,
                         device=occ.device))
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
                        chain_demand_q=q99(per_ray_need),
                        per_ray_need=per_ray_need)


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
    per_ray_need: torch.Tensor   # (N,) int32, as MarchResults'


def march_rays_train_strided(rays_o, rays_d, hits_t, noise, win_rows, *,
                             scale: float, grid_size: int, max_samples: int,
                             n_samples: int, chain_length: int,
                             cascades: int = 1, exp_step_factor: float = 0.0,
                             occ_grid=None) -> StridedMarch:
    """Occupancy march of a train batch into the strided (N, S) layout
    (ngp_pl_tpu/ops/ray_march.py:1040-1129): the chain from
    t1 + calc_dt(t1) * noise, rounded up to 32 steps, its bits by the JAX
    package's dispatch (`_chain_bits`: the 8-step windows, the
    multi-cascade windows, or the grid), and per ray the first S occupied
    steps, found by a cumsum and a sorted search where the TPU counts bits
    in groups.  Deltas are the step sizes at the kept positions; slots past
    a ray's count hold t = 0 and are not valid."""
    N = rays_o.shape[0]
    S = n_samples
    K = -(-chain_length // 32) * 32
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor
    t1 = hits_t[:, 0]
    t0 = _fma(noise, calc_dt(t1, f, max_samples, grid_size, scale), t1)
    occ = _chain_bits(rays_o, rays_d, t0, t1 >= 0, hits_t[:, 1], K,
                      win_rows=win_rows, occ_grid=occ_grid,
                      cascades=cascades, scale=scale, exp_step_factor=f,
                      grid_size=grid_size, dt_min=dt_min, dt_max=dt_max,
                      uniform_window=True)

    kk1 = torch.arange(1, K + 1, dtype=torch.int32, device=occ.device)
    per_ray_need = torch.where(occ, kk1, 0).amax(dim=1)
    csum = torch.cumsum(occ, dim=1)                             # (N, K)
    rm_counts = csum[:, -1].to(torch.int32)
    counts = torch.clamp_max(rm_counts, S)
    s_row = torch.arange(S, device=occ.device)
    k_idx = torch.searchsorted(
        csum, (s_row + 1).expand(N, S).contiguous())            # K if none
    valid = s_row[None, :] < counts[:, None]
    ts = chain_t(t0[:, None], k_idx.to(torch.float32), f, dt_min, dt_max,
                 fused=True)
    deltas = (torch.clamp(ts * f, dt_min, dt_max) if f > 0.0 else
              torch.full((N, S), dt_min, dtype=torch.float32,
                         device=occ.device))
    return StridedMarch(ts=torch.where(valid, ts, 0.0), deltas=deltas,
                        valid=valid, counts=counts, rm_counts=rm_counts,
                        total=counts.sum(dtype=torch.int32),
                        chain_demand=per_ray_need.max(),
                        chain_demand_q=q99(per_ray_need),
                        per_ray_need=per_ray_need)


def _chain_bits(rays_o, rays_d, t0, hit, t2, K, *, win_rows, occ_grid,
                cascades, scale, exp_step_factor, grid_size, dt_min, dt_max,
                uniform_window):
    """(N, K) occupancy of the chain steps from t0 that lie in [0, t2) of
    a ray that hits the box (`hit`), by the JAX package's dispatch
    (ray_march.py:926-946, 1077-1105): with `win_rows`, the 8-step windows
    for one cascade and uniform steps (where `uniform_window` allows them,
    as the strided march does) or the two-window chain for multi-cascade
    or exponential steps (K a multiple of 4); otherwise each step's cell
    of the grid `occ_grid` at its cascade."""
    N = rays_o.shape[0]
    f = exp_step_factor
    use_window = (uniform_window and win_rows is not None and f == 0.0
                  and cascades == 1 and K % SEGMENT_J == 0)
    use_window_mc = (win_rows is not None and not use_window
                     and (cascades > 1 or f > 0.0) and K % J_MC == 0)
    if use_window:
        occ, ts = _occ_window_chain(rays_o, rays_d, t0, K // SEGMENT_J,
                                    win_rows, scale=scale,
                                    grid_size=grid_size, dt_min=dt_min)
        occ, ts = occ.reshape(N, K), ts.reshape(N, K)
    elif use_window_mc:
        occ, ts, _ = _occ_window_chain_mc(
            rays_o, rays_d, t0, K // J_MC, win_rows, cascades=cascades,
            scale=scale, grid_size=grid_size, exp_step_factor=f,
            dt_min=dt_min, dt_max=dt_max)
    else:
        k = torch.arange(K, dtype=torch.float32, device=rays_o.device)
        ts = chain_t(t0[:, None], k[None, :], f, dt_min, dt_max, fused=True)
        occ = occupancy_at(occ_grid, _positions(ts, rays_o, rays_d),
                           torch.clamp(ts * f, dt_min, dt_max), cascades,
                           scale, grid_size)
    return occ & hit[:, None] & (ts >= 0) & (ts < t2[:, None])


def march_rays_train(rays_o, rays_d, hits_t, occ_grid, noise, *,
                     cascades: int, scale: float, exp_step_factor: float,
                     grid_size: int, max_samples: int, pool_size: int,
                     chain_length: int = 0, skip_empty_span: bool = True,
                     win_rows=None, span_grid=None) -> MarchResults:
    """The general train march into the CSR pool
    (ngp_pl_tpu/ops/ray_march.py:873-973), for what the 8-step windowed
    march does not cover:
    - multi-cascade or exponential steps with `win_rows`: the two-window
      chain (`_occ_window_chain_mc`);
    - multi-cascade or exponential steps without: each step's cell of
      `occ_grid` at its cascade (the JAX package's z-line branch);
    - one cascade with uniform steps, cameras past `segment_march_dmax_ok`:
      the occupied-span pre-pass (`span_grid`, built from `occ_grid` when
      not given) cuts each chain to [t_s, t_e], then the grid lookup.
    The chain runs from t1 + calc_dt(t1) * noise for K = `chain_length`
    (max_samples by default) steps.  `chain_demand` is the span's step
    count when the pre-pass ran, else one past the last occupied step."""
    N = rays_o.shape[0]
    K = chain_length if chain_length > 0 else max_samples
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    chain_demand = None
    if skip_empty_span and cascades == 1 and f == 0.0:
        if span_grid is None:
            span_grid = occupied_span_prep(occ_grid, grid_size=grid_size)
        t1, t2, span_steps = occupied_span(rays_o, rays_d, t1, t2, span_grid,
                                           scale=scale, dt_min=dt_min)
        chain_demand = span_steps.max()
    t0 = _fma(noise, calc_dt(t1, f, max_samples, grid_size, scale), t1)
    occ = _chain_bits(rays_o, rays_d, t0, hit, t2, K, win_rows=win_rows,
                      occ_grid=occ_grid, cascades=cascades, scale=scale,
                      exp_step_factor=f, grid_size=grid_size, dt_min=dt_min,
                      dt_max=dt_max, uniform_window=False)

    kk1 = torch.arange(1, K + 1, dtype=torch.int32, device=occ.device)
    per_ray_need = torch.where(occ, kk1, 0).amax(dim=1)
    pool = _compact_to_pool(occ, t0, max_samples, pool_size, dt_min, f,
                            dt_max)
    return MarchResults(*pool[:4], counts=pool[4], offsets=pool[5],
                        total=pool[6], rm_counts=pool[7],
                        chain_demand=(per_ray_need.max()
                                      if chain_demand is None
                                      else chain_demand),
                        chain_demand_q=q99(per_ray_need),
                        per_ray_need=per_ray_need)
