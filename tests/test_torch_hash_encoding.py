"""Port parity: brick-row hash encoding and the plain K1 (fused hash encode +
first layer) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The plain
K1 keeps the packed TPU kernel's rounding points, so it is held tightly
against `encode_mlp_fwd_pallas` run in interpret mode, and loosely against
the f32-row XLA path `_encode_mlp_cv` (whose table is not f16-rounded)."""
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

SPEC_KW = dict(n_levels=4, n_features=4, log2_hashmap_size=10,
               base_resolution=4, per_level_scale=2.0)


def _inputs(N=256, seed=0):
    spec_j = jhe.make_grid_spec(**SPEC_KW)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (spec_j.total_rows, spec_j.row_width))
    table[:, 108:] = 0.0
    table = table.astype(np.float32)
    w1 = (rng.normal(0, 0.3, (spec_j.out_dim, 64))).astype(np.float32)
    x = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [1, 0.5, 0], [0.999999, 1e-7, 0.5]]
    return spec_j, table, w1, x


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


def test_slots_local_frac_match():
    spec_j, _, _, x = _inputs(N=1024)
    spec_t = the.make_grid_spec(**SPEC_KW)
    sj, lj, fj = jhe._slots_local_frac_lm(jnp.asarray(x), spec_j)
    st, lt, ft = the.slots_local_frac_lm(torch.from_numpy(x), spec_t)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=0, atol=1e-6)


def test_expand_w1_matches():
    spec_j, _, w1, _ = _inputs()
    spec_t = the.make_grid_spec(**SPEC_KW)
    np.testing.assert_array_equal(
        np.asarray(jhe.expand_w1(jnp.asarray(w1), spec_j)),
        the.expand_w1(torch.from_numpy(w1), spec_t).numpy())


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
    spec_t = the.make_grid_spec(**SPEC_KW)
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


def test_plain_k1_matches_xla_path():
    """Against the f32-row XLA path: 2e-2 of max |h1|, as
    tests/test_pallas_encode.py holds the Pallas kernel (f16 table copy and
    bf16 weighted rows on one side only)."""
    spec_j, table, w1, x = _inputs()
    h_j = np.asarray(jhe._encode_mlp_cv(
        spec_j, False, jnp.asarray(x), jnp.asarray(table),
        jhe.expand_w1(jnp.asarray(w1), spec_j)))
    spec_t = the.make_grid_spec(**SPEC_KW)
    h_t = the.hash_encode_fwd(
        torch.from_numpy(x), the.table_f16(torch.from_numpy(table)),
        torch.from_numpy(w1), spec_t)
    assert np.abs(h_t.numpy() - h_j).max() / np.abs(h_j).max() <= 2e-2


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    spec_j, table, w1, x = _inputs(N=32)
    spec_t = the.make_grid_spec(**SPEC_KW)
    before = the.hash_encode_fwd_cuda.launches
    args = (torch.from_numpy(x), the.table_f16(torch.from_numpy(table)),
            torch.from_numpy(w1), spec_t)
    torch.testing.assert_close(the.hash_encode_fwd(*args),
                               the.hash_encode_fwd_plain(*args),
                               rtol=0, atol=0)
    assert the.hash_encode_fwd_cuda.launches == before


def test_dispatch_rejects_f2_rows_on_both_devices():
    """The F=2 geometry (K3) is not ported: the dispatcher refuses it
    before it looks at the device."""
    spec = the.make_grid_spec(n_levels=2, n_features=2, log2_hashmap_size=10,
                              base_resolution=4)
    g = torch.Generator().manual_seed(0)
    table = the.table_f16(the.init_hash_table(spec, g))
    with pytest.raises(NotImplementedError):
        the.hash_encode_fwd(torch.rand((8, 3), generator=g), table,
                            torch.zeros((spec.out_dim, 64)), spec)


def test_cuda_wrapper_refuses_cpu_tensors():
    """A wrapper never falls back: the kernel entry rejects CPU tensors."""
    spec_j, table, w1, x = _inputs(N=32)
    spec_t = the.make_grid_spec(**SPEC_KW)
    with pytest.raises(ValueError):
        the.hash_encode_fwd_cuda(torch.from_numpy(x),
                                 the.table_f16(torch.from_numpy(table)),
                                 torch.from_numpy(w1), spec_t)
