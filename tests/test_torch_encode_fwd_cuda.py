"""On the card only: the encode forward kernels (K1 at F=4, K3 at F=2)
against their plain version, run on the CPU, within 1e-5 of max on h1 and
on the per-level features (K1_TOL of chip_smoke.py: the kernels round where
the plain version does and sum exact products on the tensor cores, so only
the order of the f32 sums differs), on the inputs where their tiles of 16
samples and their corner layout could go wrong: ragged tiles (N = 1 ...
65,537), x on the cell edges of every level, at 0 and 1 and outside [0, 1]
(clipped), every local cell (lx, ly, lz) on every level, feats given and
not given (h1 bit-identical), the ray-ordered train pool of the port's own
train step (`tests/table_grad_pool.py`) and the card's two geometries.
Each launch counts once.

    python -m pytest -m cuda --noconftest tests/test_torch_encode_fwd_cuda.py
"""
import numpy as np
import pytest
import torch

from tests.table_grad_pool import train_pool

K1_TOL = 1e-5
# two dense levels (8 and 64 bricks) and two hashed ones (128 slots)
SPEC_KW = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4,
               per_level_scale=2.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")


def _spec(F):
    from ngp_pl_torch.ops import hash_encoding as he

    return he.make_grid_spec(n_features=F, **SPEC_KW)


def _table_w1(spec, seed):
    """U(-1, 1) on the used lanes and N(0, 0.3) weights, numpy seeded; the
    table the encode reads (the f16 copy at F=4)."""
    from ngp_pl_torch.ops import hash_encoding as he

    rng = np.random.default_rng(seed)
    F = spec.n_features
    t = rng.uniform(-1.0, 1.0, (spec.total_rows, spec.row_width))
    t[:, 27 * F:] = 0.0
    w1 = rng.normal(0, 0.3, (spec.out_dim, 64)).astype(np.float32)
    return (he.encode_table(torch.from_numpy(t.astype(np.float32)), spec),
            torch.from_numpy(w1))


def _check(x, table, w1, spec):
    """The kernel on the card with feats and without, against the plain
    version on the CPU; returns h1 from the card."""
    from ngp_pl_torch.ops import hash_encoding as he

    wrapper = (he.hash_encode_fwd_cuda if spec.n_features == 4
               else he.hash_encode_fwd_f2_cuda)
    xc, tc, wc = x.cuda(), table.cuda(), w1.cuda()
    n0 = wrapper.launches
    feats = torch.full((x.shape[0], spec.out_dim), float("nan"),
                       device="cuda")
    h1 = he.hash_encode_fwd(xc, tc, wc, spec, feats)
    h1_alone = he.hash_encode_fwd(xc, tc, wc, spec)
    assert wrapper.launches == n0 + 2
    ref_feats = torch.empty((x.shape[0], spec.out_dim))
    ref = he.hash_encode_fwd_plain(x, table, w1, spec, ref_feats)
    assert torch.equal(h1, h1_alone)
    h1, feats = h1.cpu(), feats.cpu()
    assert h1.shape == ref.shape
    assert bool(torch.isfinite(h1).all()) and bool(torch.isfinite(feats).all())
    assert float((h1 - ref).abs().max()) <= K1_TOL * float(ref.abs().max())
    assert float((feats - ref_feats).abs().max()) <= K1_TOL * float(
        ref_feats.abs().max())
    return h1


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 4097, 65537])
def test_random_points_at_ragged_sizes(F, n):
    _card()
    spec = _spec(F)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    _check(x, *_table_w1(spec, seed=n), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_cell_edges_ends_and_outside(F):
    """Points on the cell edges of every level (x = k / R_l per axis), the
    corners of [0, 1]^3 and points outside it, which the kernel clips."""
    _card()
    spec = _spec(F)
    rng = np.random.default_rng(3)
    xs = []
    for R in spec.resolutions:
        xs.append(rng.integers(0, R + 1, (300, 3)) / R)
    xs.append(np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                        for c in (0, 1)], dtype=np.float64))
    xs.append(rng.uniform(-0.5, 1.5, (300, 3)))
    xs.append(np.array([[-1e-7, 1.0 + 1e-7, 0.5], [-3.0, 4.0, 1.0]]))
    x = torch.from_numpy(np.concatenate(xs).astype(np.float32))
    _check(x, *_table_w1(spec, seed=4), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_every_local_cell_on_every_level(F):
    """For each level and each (lx, ly, lz) in {0, 1}^3, 40 points whose
    cell on that level has that local corner: the corner points start at
    both ends of the row."""
    _card()
    from ngp_pl_torch.ops import hash_encoding as he

    spec = _spec(F)
    rng = np.random.default_rng(5)
    xs = []
    for R in spec.resolutions:
        for bits in range(8):
            loc = np.array([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1])
            brick = rng.integers(0, R // 2, (40, 3))
            cell = np.minimum(2 * brick + loc, R - 1)
            xs.append((cell + rng.uniform(0.05, 0.95, (40, 3))) / R)
    x = torch.from_numpy(np.concatenate(xs).astype(np.float32))
    _, local, _ = he.slots_local_frac_lm(x, spec)
    codes = (local[..., 0] * 4 + local[..., 1] * 2 + local[..., 2])
    for l in range(spec.n_levels):
        assert set(codes[l].tolist()) == set(range(8))
    _check(x, *_table_w1(spec, seed=6), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_a_ray_ordered_train_pool(F):
    _card()
    from ngp_pl_torch.ops import hash_encoding as he

    x, _, w1, spec = train_pool(F)
    table, _ = _table_w1(spec, seed=7)
    assert table.dtype == he._ROW_DTYPE[F]
    _check(x, table, w1, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_the_cards_geometries_at_random_points(F):
    """The flagship L8F4 and the reference's L16F2 grid (T=2^19), 4,096
    random points."""
    _card()
    from ngp_pl_torch.benchmarking.train_setup import train_config
    from ngp_pl_torch.ops import hash_encoding as he

    c = train_config(**({} if F == 4 else dict(n_levels=16, n_features=2))
                     ).ngp_config()
    spec = he.make_grid_spec(c.n_levels, c.n_features_per_level,
                             c.log2_hashmap_size, c.base_resolution,
                             c.per_level_scale)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    _check(x, *_table_w1(spec, seed=12), spec)
