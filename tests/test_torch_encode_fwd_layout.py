"""The encode forward (K1 at F=4, K3 at F=2) on the CPU: the plain version
on a ray-ordered train pool, and the layout and summation order of the
kernels' tensor-core design (csrc/hash_encode_fwd.cu).

- On the pool of the port's own train step (`tests/table_grad_pool.py`: a
  ray's samples in consecutive slots, unused slots at one position), the
  plain version matches the JAX package's interpreted Pallas kernel within
  1e-5 of max, h1 and the per-level features.
- The gather: lane (g, t) of a warp loads, for each of its two samples, the
  points of corners (dx, t >> 1, t & 1), dx = 0, 1, at base + 9 dx + 3 dy +
  dz.  For every local cell (lx, ly, lz) the four lanes of a quad read, in
  one instruction, points inside one 40-byte span (at most two 32-byte
  sectors) of the row, 8-byte aligned, among its 27 points.
- The contraction: A's columns given to (corner, feature) as the kernel
  gives them and B's rows bf16(w1) of the column's feature cover each
  (corner, feature) once per level; summed per 16-wide k-chunk and then
  over chunks and levels in f32, as the kernel's products accumulate, the
  result agrees with the plain version within K1_TOL (1e-5 of max), on
  random points and on the pool, h1 and feats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_torch.ops import hash_encoding as the
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops.hash_encoding_pallas import (
    encode_mlp_fwd_pallas,
    pack_table_f16,
    unpack_feats,
)
from tests.table_grad_pool import SmallTrainConfig, train_pool

torch.set_num_threads(2)

K1_TOL = 1e-5
SECTOR = 32
POINT_BYTES = 8           # F values of the table's type: 4 halves or 2 floats


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _pool(F):
    """The pool's x and w1 with a random table of the pool's grid, values
    U(-1, 1) on the used lanes (a seeded table is 1e-4 wide)."""
    x, _, w1, spec = train_pool(F)
    rng = np.random.default_rng(F)
    table = rng.uniform(-1.0, 1.0, (spec.total_rows, spec.row_width))
    table[:, 27 * F:] = 0.0
    return x, torch.from_numpy(table.astype(np.float32)), w1, spec


@pytest.mark.parametrize("F", [4, 2])
def test_plain_matches_interpreted_pallas_on_a_ray_ordered_pool(F):
    """h1 and the per-level features within 1e-5 of their max: the same
    rounding points, f32 sums in another order."""
    x, table, w1, spec = _pool(F)
    N, L, W = x.shape[0], spec.n_levels, spec.row_width
    assert N % 128 == 0
    c = SmallTrainConfig(n_levels=L, n_features=F,
                         log2_hashmap_size=12).ngp_config()
    spec_j = jhe.make_grid_spec(c.n_levels, c.n_features_per_level,
                                c.log2_hashmap_size, c.base_resolution,
                                c.per_level_scale)
    assert spec_j.offsets == spec.offsets
    # the JAX package clips x before its slot math; the unused slots of
    # the pool lie outside [0, 1]^3
    assert float(x.min()) < 0.0 or float(x.max()) > 1.0
    slot, local, frac = jhe._slots_local_frac_lm(
        jnp.clip(jnp.asarray(x.numpy()), 0.0, 1.0), spec_j)
    tj = jnp.asarray(table.numpy())
    rows = (pack_table_f16(tj) if F == 4 else tj)[slot.reshape(-1)]
    rows = rows.reshape(L, N, -1)
    h_j, ft2 = encode_mlp_fwd_pallas(
        rows, jhe._meta_T(local, frac, 1 if F == 4 else 2),
        jhe.expand_w1(jnp.asarray(w1.numpy()), spec_j), F=F, bn=N,
        interpret=True)
    feats = torch.empty((N, L * F))
    h_t = the.hash_encode_fwd_plain(x, the.encode_table(table, spec), w1,
                                    spec, feats)
    assert _rel(h_t.numpy(), h_j) <= K1_TOL
    f_j = np.moveaxis(np.asarray(unpack_feats(ft2, L, F, 1 if F == 4 else 2)),
                      0, 1).reshape(N, L * F)
    assert _rel(feats.numpy(), f_j) <= K1_TOL
    assert W == 32 * F


# --- the kernels' layout ----------------------------------------------------

def lane_corners(t):
    """The two corners (dx, dy, dz) lane t of a quad gathers: dx = 0, 1."""
    return [(dx, t >> 1, t & 1) for dx in (0, 1)]


def point(loc, corner):
    """The point of a brick row at local cell `loc` plus `corner`."""
    lx, ly, lz = (l + c for l, c in zip(loc, corner))
    return (lx * 3 + ly) * 3 + lz


LOCALS = [(lx, ly, lz) for lx in (0, 1) for ly in (0, 1) for lz in (0, 1)]


@pytest.mark.parametrize("F", [4, 2])
@pytest.mark.parametrize("loc", LOCALS)
def test_a_quads_load_spans_at_most_two_sectors(F, loc):
    """Per instruction (one dx) a quad reads the points base + 9 dx +
    {0, 1, 3, 4}: inside 40 bytes of the row, so at most two 32-byte
    sectors; the 8 corners of both instructions are the cell's 8 corners,
    8-byte aligned points among the row's 27 (the row is 32 F values)."""
    row_bytes = 32 * F * (2 if F == 4 else 4)
    assert row_bytes == 256
    seen = set()
    for dx in (0, 1):
        offs = []
        for t in range(4):
            c = lane_corners(t)[dx]
            assert c[0] == dx
            p = point(loc, c)
            assert 0 <= p < 27
            offs.append(p * POINT_BYTES)
            seen.add(c)
        lo, hi = min(offs), max(offs) + POINT_BYTES
        assert hi - lo <= 40
        assert all(o % POINT_BYTES == 0 for o in offs)
        assert len({o // SECTOR for o in offs}
                   | {(o + POINT_BYTES - 1) // SECTOR for o in offs}) <= 2
        assert hi <= row_bytes
    assert seen == {(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                    for dz in (0, 1)}


def a_columns(F):
    """(chunk, k) -> (corner, feature) of A's columns, as the kernel lays
    them out: lane t holds k = 2t, 2t+1, 2t+8, 2t+9 of each chunk.  F=4:
    chunk kc = dx, the four columns the 4 features of corner (kc, t >> 1,
    t & 1); F=2: one chunk, 2t + f corner (0, ...), 2t + 8 + f corner
    (1, ...)."""
    cols = {}
    for t in range(4):
        ks = (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
        if F == 4:
            for kc in (0, 1):
                for f, k in enumerate(ks):
                    cols[kc, k] = (lane_corners(t)[kc], f)
        else:
            for j, k in enumerate(ks):
                cols[0, k] = (lane_corners(t)[j // 2], j % 2)
    return cols


def b_feature(F, k):
    """The feature of B's row k: b0 holds rows 2t, 2t + 1 (features 0, 1),
    b1 rows 2t + 8, 2t + 9 (features 2, 3 at F=4, 0, 1 at F=2)."""
    return (k & 1) + (2 * ((k >> 3) & 1) if F == 4 else 0)


def emulate(x, table, w1, spec):
    """h1 and feats as the kernel composes them: per level and chunk the
    16 exact products bf16(v w) bf16(w1) summed in f32, the chunks and
    levels accumulated in f32 in the kernel's order; feats the same
    products against a 0/1 selector."""
    F = spec.n_features
    cols = a_columns(F)
    chunks = sorted({kc for kc, _ in cols})
    N = x.shape[0]
    slot, local, frac = the.slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
    p = local.float() + frac
    flat = table.reshape(-1).float()
    w1b = the._bf(w1)
    h1 = torch.zeros((N, 64))
    feats = torch.zeros((N, spec.out_dim))
    for l in range(spec.n_levels):
        fl = torch.zeros((N, F))
        for kc in chunks:
            a = torch.zeros((N, 16))
            b = torch.zeros((16, 64))
            sel = torch.zeros((16, F))
            for k in range(16):
                corner, f = cols[kc, k]
                assert b_feature(F, k) == f
                pc = local[l] + torch.tensor(corner)
                w = torch.ones(N)
                for ax in range(3):
                    w = w * torch.clamp_min(
                        1.0 - torch.abs(pc[:, ax].float() - p[l, :, ax]), 0.0)
                if F == 4:
                    w = the._bf(w)
                pt = (pc[:, 0] * 3 + pc[:, 1]) * 3 + pc[:, 2]
                v = flat[slot[l] * spec.row_width + pt * F + f]
                a[:, k] = the._bf(v * w)
                b[k] = w1b[l * F + f]
                sel[k, f] = 1.0
            h1 = h1 + a @ b
            fl = fl + a @ sel
        feats[:, l * F:(l + 1) * F] = fl
    return h1, feats


@pytest.mark.parametrize("F", [4, 2])
def test_the_columns_cover_each_corner_and_feature_once(F):
    cols = a_columns(F)
    assert len(cols) == 8 * F
    assert sorted(set(cols.values())) == sorted(
        ((dx, dy, dz), f) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
        for f in range(F))


@pytest.mark.parametrize("kind", ["random", "pool"])
@pytest.mark.parametrize("F", [4, 2])
def test_emulated_summation_order_matches_plain(F, kind):
    """Within K1_TOL of max on h1 and feats: only the order of the f32
    sums differs from the plain version."""
    if kind == "pool":
        x, table, w1, spec = _pool(F)
        table = the.encode_table(table, spec)
    else:
        spec = the.make_grid_spec(n_levels=4, n_features=F,
                                  log2_hashmap_size=12, base_resolution=4,
                                  per_level_scale=2.0)
        rng = np.random.default_rng(5)
        t = rng.uniform(-1.0, 1.0, (spec.total_rows, spec.row_width))
        t[:, 27 * F:] = 0.0
        table = the.encode_table(torch.from_numpy(t.astype(np.float32)), spec)
        x = torch.from_numpy(rng.uniform(-0.1, 1.1, (2048, 3))
                             .astype(np.float32))
        w1 = torch.from_numpy(rng.normal(0, 0.3, (spec.out_dim, 64))
                              .astype(np.float32))
    h_e, f_e = emulate(x, table, w1, spec)
    feats = torch.empty_like(f_e)
    h_p = the.hash_encode_fwd_plain(x, table, w1, spec, feats)
    assert _rel(h_e.numpy(), h_p.numpy()) <= K1_TOL
    assert _rel(f_e.numpy(), feats.numpy()) <= K1_TOL

