"""The reference-layout grid ops and the multi-object intersections against
the JAX package on the CPU, all bit-equal: `morton3d` /
`morton3d_invert` (`ngp_pl_tpu/ops/morton.py`), `packbits` / `unpackbits`
(`ops/grid_ops.py`), `export_bitfield` (`models/occupancy.py:257-272`) at
one and four cascades, and `ray_aabb_intersect` / `ray_sphere_intersect`
(`ops/intersection.py:58-116`) with ties, misses, origins inside several
objects and zero direction components.

Sizes: grid 32, 1,000-40,000 codes, 300 rays against 40 objects."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.models import occupancy as jocc
from ngp_pl_tpu.ops import grid_ops as jgrid
from ngp_pl_tpu.ops import intersection as jint
from ngp_pl_tpu.ops import morton as jmorton
from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.models import occupancy as tocc
from ngp_pl_torch.ops import grid_ops as tgrid
from ngp_pl_torch.ops import intersection as tint
from ngp_pl_torch.ops import morton as tmorton

torch.set_num_threads(2)


def _cells(G=32):
    r = np.arange(G)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("coords", ["grid32", "below1024", "past1024"])
def test_morton3d_matches_jax(coords):
    """Every cell of G=32, random coords below 1024, and coords up to 2^20,
    where JAX's uint32 products wrap."""
    rng = np.random.default_rng(0)
    c = {"grid32": _cells(),
         "below1024": rng.integers(0, 1024, (40000, 3)),
         "past1024": rng.integers(0, 1 << 20, (40000, 3))}[coords]
    c = c.astype(np.int32)
    want = np.asarray(jmorton.morton3d(jnp.asarray(c)))
    got = tmorton.morton3d(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    back = np.asarray(jmorton.morton3d_invert(jnp.asarray(want)))
    got_back = tmorton.morton3d_invert(got)
    assert got_back.dtype == torch.int32
    np.testing.assert_array_equal(got_back.numpy(), back)
    if coords != "past1024":
        np.testing.assert_array_equal(back, c)


def test_morton3d_invert_matches_jax_on_any_code():
    codes = np.random.default_rng(1).integers(0, 1 << 32, 40000,
                                              dtype=np.uint64)
    want = np.asarray(jmorton.morton3d_invert(
        jnp.asarray(codes.astype(np.uint32))))
    got = tmorton.morton3d_invert(torch.from_numpy(codes.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packbits_unpackbits_match_jax():
    rng = np.random.default_rng(2)
    grid = rng.normal(size=4096).astype(np.float32)
    want = np.asarray(jgrid.packbits(jnp.asarray(grid), 0.3))
    got = tgrid.packbits(torch.from_numpy(grid), 0.3)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    bits = np.asarray(jgrid.unpackbits(jnp.asarray(want)))
    got_bits = tgrid.unpackbits(got)
    assert got_bits.dtype == torch.uint8
    np.testing.assert_array_equal(got_bits.numpy(), bits)
    np.testing.assert_array_equal(bits, (grid > 0.3).astype(np.uint8))


@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_export_bitfield_matches_jax(scale):
    """C=1 (scale 0.5) and C=4 (scale 4): C * G^3 / 8 bytes, bit-equal.
    JAX's function raises past the first cascade (its loop deletes `thr`,
    then deletes it again), so at C=4 JAX's bytes are its one-cascade
    function's for each cascade in turn, which is what its loop computes
    for each."""
    kw = dict(scale=scale, grid_size=32)
    jc, tc = JaxNGPConfig(**kw), NGPConfig(**kw)
    C, G = tc.cascades, tc.grid_size
    assert C == (1 if scale == 0.5 else 4)
    occ = (np.random.default_rng(3).random((C, G, G, G)) < 0.3).astype(
        np.uint8)
    one = JaxNGPConfig(scale=0.5, grid_size=G)
    want = np.concatenate([np.asarray(jocc.export_bitfield(
        jocc.init_grid_state(one)._replace(occ_grid=jnp.asarray(occ[c:c + 1])),
        one)) for c in range(C)])
    if C > 1:
        with pytest.raises(UnboundLocalError):
            jocc.export_bitfield(jocc.init_grid_state(jc)._replace(
                occ_grid=jnp.asarray(occ)), jc)
    ts = tocc.init_grid_state(tc, "cpu")
    ts.occ_grid = torch.from_numpy(occ)
    got = tocc.export_bitfield(ts, tc)
    assert got.dtype == torch.uint8 and got.shape == (C * G ** 3 // 8,)
    np.testing.assert_array_equal(got.numpy(), want)


def _rays(N=300, seed=4):
    """Rays from inside and outside the objects' region; every 7th has one
    zero direction component, every 11th two, every 13th an origin on a
    slab plane (0 * inf in the slab test)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    o[::3] *= 0.1                                  # inside several objects
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[::7, 0] = 0.0
    d[::11, 1:] = 0.0
    o[::13, 2] = 0.25                              # a box plane below
    return o, d


def _objects(V=40, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (V, 3)).astype(np.float32)
    c[:8] = rng.uniform(-0.05, 0.05, (8, 3))       # overlap the origin
    c[8:12] = np.float32([0.0, 0.0, 0.0])          # exact duplicates
    h = rng.uniform(0.05, 0.4, (V, 3)).astype(np.float32)
    h[:12, 2] = 0.25 - c[:12, 2]                   # planes at z = 0.25
    return c, h


def _check(want, got, max_hits):
    cnt, hits_t, idx = got
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(hits_t.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
    assert hits_t.shape[1] == min(max_hits, hits_t.shape[1])


@pytest.mark.parametrize("max_hits", [1, 6, 64])
def test_ray_aabb_intersect_matches_jax(max_hits):
    o, d = _rays()
    c, h = _objects()
    want = jint.ray_aabb_intersect(*map(jnp.asarray, (o, d, c, h)),
                                   max_hits)
    got = tint.ray_aabb_intersect(*map(torch.from_numpy, (o, d, c, h)),
                                  max_hits)
    _check(want, got, max_hits)
    cnt = got[0].numpy()
    assert (cnt == 0).any() and (cnt >= 8).any()   # misses and ties at 0
    near = got[1][..., 0].numpy()
    assert ((near[:, 1:] == 0) & (near[:, :-1] == 0)).any() or max_hits == 1


@pytest.mark.parametrize("radii_shape", ["S", "S3"])
def test_ray_sphere_intersect_matches_jax(radii_shape):
    o, d = _rays(seed=6)
    c, h = _objects(seed=7)
    r = h if radii_shape == "S3" else h[:, 0].copy()
    want = jint.ray_sphere_intersect(*map(jnp.asarray, (o, d, c, r)), 6)
    got = tint.ray_sphere_intersect(*map(torch.from_numpy, (o, d, c, r)), 6)
    _check(want, got, 6)
    assert (got[0].numpy() == 0).any() and (got[0].numpy() >= 6).any()


def test_single_box_unchanged_by_the_shared_slab_test():
    """The render path's single-box hits equal JAX's, zero components
    included."""
    o, d = _rays(seed=8)
    center, half = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    want = jint.ray_aabb_intersect_single(
        *map(jnp.asarray, (o, d, center, half)))
    got = tint.ray_aabb_intersect_single(
        *map(torch.from_numpy, (o, d, center, half)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
