"""On the card only: the table-gradient kernels (K2+K5 at F=4, K4 at F=2)
against their plain version, run on the CPU, within 1e-5 of max (K2_TOL of
chip_smoke.py; the CPU sums d_wr = bf16(g) . bf16(w1) in the kernels' order,
so only the order of the table's f32 sums differs), on the inputs where
their merged reductions could go wrong: ragged warps (N = 1, 31, 33,
1,000), every lane on one point (one cell on every level, the largest
merge), random points (no merge), a ray-ordered train pool of the port's
own train step (`tests/table_grad_pool.py`), and every row zero (nothing
added at all).  Each launch counts once.

    python -m pytest -m cuda --noconftest tests/test_torch_table_grad_cuda.py
"""
import numpy as np
import pytest
import torch

from tests.table_grad_pool import train_pool

K2_TOL = 1e-5
# two dense levels (8 and 64 bricks) and two hashed ones (128 slots); every
# level has at most 32 cells per axis, so every level merges
SPEC_KW = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4,
               per_level_scale=2.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")


def _check(x, g, w1, spec):
    from ngp_pl_torch.ops import hash_encoding as he

    wrapper = (he.hash_encode_bwd_cuda if spec.n_features == 4
               else he.hash_encode_bwd_f2_cuda)
    n0 = wrapper.launches
    got = he.hash_encode_bwd(x.cuda(), g.cuda(), w1.cuda(), spec).cpu()
    assert wrapper.launches == n0 + 1
    ref = he.hash_encode_bwd_plain(x, g, w1, spec)
    assert got.shape == ref.shape
    if not bool((g != 0).any()):
        assert bool((got == 0).all())
        return
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= K2_TOL * float(ref.abs().max())


def _inputs(F, n, seed, one_point=False):
    from ngp_pl_torch.ops import hash_encoding as he

    spec = he.make_grid_spec(n_features=F, **SPEC_KW)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if one_point:
        x[:] = x[0]
    g = rng.normal(0, 1, (n, 64)).astype(np.float32)
    g[1::3] = 0.0
    w1 = rng.normal(0, 0.3, (spec.out_dim, 64)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(w1),
            spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_random_points_at_ragged_sizes(F, n):
    _card()
    x, g, w1, spec = _inputs(F, n, seed=n)
    g[0] = 1.0                       # at least one nonzero row
    _check(x, g, w1, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
@pytest.mark.parametrize("n", [32, 1000])
def test_every_lane_on_one_point(F, n):
    _card()
    _check(*_inputs(F, n, seed=7, one_point=True))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_a_ray_ordered_train_pool(F):
    _card()
    x, g, w1, spec = train_pool(F)
    assert bool((g[-1] == 0).all())
    _check(x, g, w1, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_every_row_zero(F):
    _card()
    x, g, w1, spec = _inputs(F, 1000, seed=9)
    g[:] = 0.0
    g[::7, 3] = -0.0
    _check(x, g, w1, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 2])
def test_the_cards_geometries_at_random_points(F):
    """The flagship L8F4 and the reference's L16F2 grid (T=2^19; 5 and 11
    merged levels), 4,096 random points."""
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
    g = torch.from_numpy(rng.normal(0, 1, (4096, 64)).astype(np.float32))
    w1 = torch.from_numpy(
        rng.normal(0, 0.3, (spec.out_dim, 64)).astype(np.float32))
    _check(x, g, w1, spec)
