"""Port parity: brick-row hash encoding and the plain K1 and K3 (fused hash
encode + first layer at F=4 and F=2) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The plain
versions keep the TPU kernels' rounding points, so they are held tightly
against `encode_mlp_fwd_pallas` run in interpret mode (its packed-f16 branch
for K1, its f32/paired branch for K3), and more loosely against the f32-row
XLA path `_encode_mlp_cv`."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops.hash_encoding_pallas import (
    encode_mlp_fwd_pallas,
    pack_table_f16,
    unpack_feats,
)
from ngp_pl_torch.ops import hash_encoding as the

torch.set_num_threads(2)

# two dense levels (8 and 64 bricks) and two hashed ones (32 slots)
SPEC_KW = dict(n_levels=4, n_features=4, log2_hashmap_size=10,
               base_resolution=4, per_level_scale=2.0)


def _inputs(N=256, seed=0, F=4):
    spec_j = jhe.make_grid_spec(**{**SPEC_KW, "n_features": F})
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (spec_j.total_rows, spec_j.row_width))
    table[:, 27 * F:] = 0.0
    table = table.astype(np.float32)
    w1 = (rng.normal(0, 0.3, (spec_j.out_dim, 64))).astype(np.float32)
    x = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [1, 0.5, 0], [0.999999, 1e-7, 0.5]]
    return spec_j, table, w1, x


def _spec_t(F=4):
    return the.make_grid_spec(**{**SPEC_KW, "n_features": F})


@pytest.mark.parametrize("kw", [
    SPEC_KW,
    dict(n_levels=8, n_features=4, log2_hashmap_size=19, base_resolution=16,
         per_level_scale=float(np.exp(np.log(2048 * 0.5 / 16) / 7))),
    dict(n_levels=16, n_features=2, log2_hashmap_size=19),
])
def test_grid_spec_matches(kw):
    a, b = jhe.make_grid_spec(**kw), the.make_grid_spec(**kw)
    for f in ("n_levels", "n_features", "log2_bricks", "resolutions",
              "brick_grids", "offsets", "sizes", "row_width", "total_rows",
              "out_dim"):
        assert getattr(a, f) == getattr(b, f), f


def test_flagship_geometry():
    """L=8, F=4, T=2^19 at scale 0.5: 102,752 brick rows of 128 lanes."""
    spec = the.make_grid_spec(
        8, 4, 19, 16, float(np.exp(np.log(2048 * 0.5 / 16) / 7)))
    assert spec.resolutions == (16, 28, 52, 95, 172, 312, 565, 1023)
    assert spec.sizes == (512, 2744, 17576) + (16384,) * 5
    assert spec.total_rows == 102752 and spec.row_width == 128


def test_l16f2_geometry():
    """The reference's L=16, F=2, T=2^19 grid at scale 0.5 (per-level scale
    64^(1/15)): R = 16 ... 1023, six dense levels and ten hashed ones of
    16,384 rows, 220,851 rows of 64 floats (56.5 MB f32)."""
    spec = the.make_grid_spec(16, 2, 19, 16,
                              float(np.exp(np.log(2048 * 0.5 / 16) / 15)))
    assert spec.resolutions[0] == 16 and spec.resolutions[-1] == 1023
    assert spec.sizes == (512, 1331, 2744, 5832, 13824, 32768) + (16384,) * 10
    assert spec.dense == (True,) * 6 + (False,) * 10
    assert spec.total_rows == 220851 and spec.row_width == 64
    assert spec.total_rows * spec.row_width * 4 == 56537856


@pytest.mark.parametrize("F", [4, 2])
def test_slots_local_frac_match(F):
    spec_j, _, _, x = _inputs(N=1024, F=F)
    spec_t = _spec_t(F)
    sj, lj, fj = jhe._slots_local_frac_lm(jnp.asarray(x), spec_j)
    st, lt, ft = the.slots_local_frac_lm(torch.from_numpy(x), spec_t)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("F", [4, 2])
def test_expand_w1_matches(F):
    spec_j, _, w1, _ = _inputs(F=F)
    np.testing.assert_array_equal(
        np.asarray(jhe.expand_w1(jnp.asarray(w1), spec_j)),
        the.expand_w1(torch.from_numpy(w1), _spec_t(F)).numpy())


def test_table_f16_clamps_and_keeps_subnormals():
    t = torch.tensor([[1e5, -1e5, 3e-5, -1e-7, 0.5]])
    h = the.table_f16(t)
    assert h.dtype == torch.float16
    np.testing.assert_array_equal(h.float().numpy()[0, :2], [65504, -65504])
    # f16 subnormals (below 6.1e-5) survive the cast
    assert h.float()[0, 2] != 0 and h.float()[0, 3] != 0


def test_plain_k1_matches_interpreted_pallas():
    """Tolerance 1e-5 of max |h1| (measured 1.1e-7): same rounding points
    (bf16 weights, bf16 weighted rows, bf16 w1), f32 sums in another order.
    Dropping the bf16 rounding of the weights moves h1 by 2e-3."""
    spec_j, table, w1, x = _inputs()
    N, L, W = x.shape[0], spec_j.n_levels, spec_j.row_width
    slot, local, frac = jhe._slots_local_frac_lm(jnp.asarray(x), spec_j)
    rows = pack_table_f16(jnp.asarray(table))[slot.reshape(-1)].reshape(
        L, N, W // 2)
    h_j, ft2 = encode_mlp_fwd_pallas(
        rows, jhe._meta_T(local, frac, 1),
        jhe.expand_w1(jnp.asarray(w1), spec_j), F=4, bn=128, interpret=True)
    spec_t = _spec_t()
    feats = torch.empty((N, L * 4))
    h_t = the.hash_encode_fwd_plain(
        torch.from_numpy(x), the.table_f16(torch.from_numpy(table)),
        torch.from_numpy(w1), spec_t, feats)
    h_j = np.asarray(h_j)
    scale = np.abs(h_j).max()
    assert np.abs(h_t.numpy() - h_j).max() / scale <= 1e-5
    f_j = np.moveaxis(np.asarray(unpack_feats(ft2, L, 4, 1)), 0, 1)
    f_j = f_j.reshape(N, L * 4)
    assert np.abs(feats.numpy() - f_j).max() / np.abs(f_j).max() <= 1e-5


def test_plain_k3_matches_interpreted_pallas():
    """K3: the f32/paired branch of `encode_mlp_fwd_pallas` (f32 rows, two
    samples per 128-lane row, block-diagonal w1), interpreted.  Same
    rounding points (f32 corner weights, bf16 weighted rows, bf16 w1), f32
    sums in another order: h1 and the per-level features within 1e-5 of
    their max (measured 9e-8 to 1.4e-7 on h1).  Rounding the weights to
    bf16, as K1 does, moves h1 by 3.1e-3."""
    spec_j, table, w1, x = _inputs(F=2)
    N, L, W = x.shape[0], spec_j.n_levels, spec_j.row_width
    slot, local, frac = jhe._slots_local_frac_lm(jnp.asarray(x), spec_j)
    rows = jnp.asarray(table)[slot.reshape(-1)].reshape(L, N, W)
    h_j, ft2 = encode_mlp_fwd_pallas(
        rows, jhe._meta_T(local, frac, 2),
        jhe.expand_w1(jnp.asarray(w1), spec_j), F=2, bn=128, interpret=True)
    feats = torch.empty((N, L * 2))
    table_t = torch.from_numpy(table)
    assert the.encode_table(table_t, _spec_t(2)) is table_t   # f32 rows
    h_t = the.hash_encode_fwd_plain(torch.from_numpy(x), table_t,
                                    torch.from_numpy(w1), _spec_t(2), feats)
    h_j = np.asarray(h_j)
    assert np.abs(h_t.numpy() - h_j).max() / np.abs(h_j).max() <= 1e-5
    f_j = np.moveaxis(np.asarray(unpack_feats(ft2, L, 2, 2)), 0, 1)
    f_j = f_j.reshape(N, L * 2)
    assert np.abs(feats.numpy() - f_j).max() / np.abs(f_j).max() <= 1e-5


@pytest.mark.parametrize("F,tol", [(4, 2e-2), (2, 1e-5)])
def test_plain_k1_matches_xla_path(F, tol):
    """Against the f32-row XLA path.  F=4: 2e-2 of max |h1|, as
    tests/test_pallas_encode.py holds the Pallas kernel (f16 table copy and
    bf16 weighted rows on one side only).  F=2: both read f32 rows, keep
    the weights in f32 and round the weighted rows to bf16, so 1e-5
    (measured 1.4e-7 over four seeds); XLA forms the weights as (1 - frac)
    and frac where K3 takes 1 - |c - p| with p = local + frac, which could
    round one weighted row to the other bf16 neighbour."""
    spec_j, table, w1, x = _inputs(F=F)
    h_j = np.asarray(jhe._encode_mlp_cv(
        spec_j, False, jnp.asarray(x), jnp.asarray(table),
        jhe.expand_w1(jnp.asarray(w1), spec_j)))
    spec_t = _spec_t(F)
    h_t = the.hash_encode_fwd(
        torch.from_numpy(x), the.encode_table(torch.from_numpy(table), spec_t),
        torch.from_numpy(w1), spec_t)
    assert np.abs(h_t.numpy() - h_j).max() / np.abs(h_j).max() <= tol


@pytest.mark.parametrize("F", [4, 2])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(F):
    spec_j, table, w1, x = _inputs(N=32, F=F)
    spec_t = _spec_t(F)
    counters = (the.hash_encode_fwd_cuda, the.hash_encode_fwd_f2_cuda)
    before = [c.launches for c in counters]
    args = (torch.from_numpy(x),
            the.encode_table(torch.from_numpy(table), spec_t),
            torch.from_numpy(w1), spec_t)
    torch.testing.assert_close(the.hash_encode_fwd(*args),
                               the.hash_encode_fwd_plain(*args),
                               rtol=0, atol=0)
    assert [c.launches for c in counters] == before


def _wrong_table_calls():
    """(case, call, message) of tables and grids the CUDA wrappers refuse
    before they look at the device."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((8, 3), generator=g)
    s2, s4 = _spec_t(2), _spec_t(4)
    t2 = the.init_hash_table(s2, g)
    t4 = the.init_hash_table(s4, g)
    w2, w4 = torch.zeros((s2.out_dim, 64)), torch.zeros((s4.out_dim, 64))
    gr = torch.zeros((8, 64))
    s3 = dataclasses.replace(s2, n_features=3)
    s17 = the.make_grid_spec(**{**SPEC_KW, "n_features": 2, "n_levels": 17})
    return {
        # K3 reads the f32 table, never an f16 copy
        "f16_table_to_k3": (lambda: the.hash_encode_fwd_f2_cuda(
            x, the.table_f16(t2), w2, s2), "torch.float32"),
        # K1 reads the f16 copy, never the f32 table
        "f32_table_to_k1": (lambda: the.hash_encode_fwd_cuda(
            x, t4, w4, s4), "torch.float16"),
        "f2_grid_to_k1": (lambda: the.hash_encode_fwd_cuda(
            x, the.table_f16(t2), w2, s2), "F=4"),
        "f3_grid_fwd": (lambda: the.hash_encode_fwd(
            x.to("meta"), t2, w2, s3), "F=4"),
        "f3_grid_bwd": (lambda: the.hash_encode_bwd(
            x.to("meta"), gr, w2, s3), "F=4"),
        "f4_grid_to_k4": (lambda: the.hash_encode_bwd_f2_cuda(
            x, gr, w4, s4), "F=2"),
        "17_levels": (lambda: the.hash_encode_fwd_f2_cuda(
            x, the.init_hash_table(s17, g), torch.zeros((34, 64)), s17),
            "at most 16 levels"),
    }


@pytest.mark.parametrize("case", ["f16_table_to_k3", "f32_table_to_k1",
                                  "f2_grid_to_k1", "f3_grid_fwd",
                                  "f3_grid_bwd", "f4_grid_to_k4",
                                  "17_levels"])
def test_cuda_wrappers_refuse_wrong_tables_and_f(case):
    """The kernels' own contracts, checked before the device: K1 takes the
    f16 copy, K3 the f32 table; F outside {2, 4} (dispatched, for a tensor
    that is not on the CPU, to K1 and K2+K5) and more than 16 levels are
    refused."""
    call, message = _wrong_table_calls()[case]
    with pytest.raises(ValueError, match=message):
        call()


@pytest.mark.parametrize("F", [4, 2])
def test_cuda_wrapper_refuses_cpu_tensors(F):
    """A wrapper never falls back: the kernel entry rejects CPU tensors."""
    spec_j, table, w1, x = _inputs(N=32, F=F)
    spec_t = _spec_t(F)
    wrapper = {4: the.hash_encode_fwd_cuda, 2: the.hash_encode_fwd_f2_cuda}[F]
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(torch.from_numpy(x),
                the.encode_table(torch.from_numpy(table), spec_t),
                torch.from_numpy(w1), spec_t)
