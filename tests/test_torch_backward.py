"""Port parity for the backward kernels' plain versions and the two
autograd Functions, against the JAX package's Pallas kernels run in
interpret mode on the CPU:

- the table gradient at F=4 (K2 fused with the K5 / XLA scatters) and at
  F=2 (K4 fused with the XLA scatter) against `encode_mlp_bwd_pallas`
  (unpaired and paired) followed by the per-level scatter-add, and at F=4
  by `scatter_onehot` for the dense levels;
- `HashEncodeMLP` against `jax.grad` of `_encode_mlp_pl_cv` at F=4 and F=2;
- K8 against the interpreted `_field_tail_bwd`, and `FieldTail` against
  `jax.grad` of `field_tail`;
- K6 against `scatter_accum`.

Inputs are made with numpy from a seed and fed to both packages.  Errors
are normalised by the largest magnitude of the JAX result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ngp_pl_tpu.ops import field_pallas as jfp
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops.hash_encoding_pallas import encode_mlp_bwd_pallas
from ngp_pl_tpu.ops.scatter_accum import scatter_accum, scatter_onehot
from ngp_pl_torch.ops import field_tail as tft
from ngp_pl_torch.ops import hash_encoding as the
from ngp_pl_torch.ops import scatter_rows as tsr
from ngp_pl_torch.ops.sh import sh_encode

torch.set_num_threads(2)

# two dense levels (8 and 64 bricks) and two hashed ones (128 slots)
SPEC_KW = dict(n_levels=4, n_features=4, log2_hashmap_size=12,
               base_resolution=4, per_level_scale=2.0)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _encode_inputs(N=256, seed=0, F=4):
    spec_j = jhe.make_grid_spec(**{**SPEC_KW, "n_features": F})
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (spec_j.total_rows, spec_j.row_width))
    table[:, 27 * F:] = 0.0
    w1 = rng.normal(0, 0.3, (spec_j.out_dim, 64)).astype(np.float32)
    x = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.999999]]
    g = rng.normal(0, 1, (N, 64)).astype(np.float32)
    return spec_j, table.astype(np.float32), w1, x, g


def _spec_t(F=4):
    return the.make_grid_spec(**{**SPEC_KW, "n_features": F})


def _jax_d_rows(spec_j, w1, x, g):
    """d_rows (L, N, W) bf16 of the unpaired (F=4) or paired (F=2) kernel."""
    F = spec_j.n_features
    slot, local, frac = jhe._slots_local_frac_lm(jnp.clip(x, 0.0, 1.0), spec_j)
    d_rows = encode_mlp_bwd_pallas(
        jhe._meta_T(local, frac, 2 if F == 2 else 1),
        jhe.expand_w1(jnp.asarray(w1), spec_j), jnp.asarray(g), F=F, bn=128,
        interpret=True)
    return slot, d_rows


@pytest.mark.parametrize("F", [4, 2])
def test_grid_has_dense_and_hashed_levels(F):
    spec = _spec_t(F)
    assert spec.dense == (True, True, False, False)
    assert spec.sizes == (8, 64, 128, 128)


@pytest.mark.parametrize("F", [4, 2])
def test_plain_table_grad_matches_pallas_bwd_and_scatters(F):
    """Against K2 (F=4) or K4 (F=2) interpreted + the per-level XLA
    scatter-add, and at F=4 K5 (`scatter_onehot`, interpreted) on the dense
    levels (the JAX package takes it only for 128-wide rows).  Same
    rounding points (bf16 g and w1, f32 d_wr, bf16 products, corner
    weights in bf16 at F=4 and f32 at F=2); only the f32 sums run in
    another order.  Tolerance 1e-5 of max |d_table| (measured 1.3e-7 at
    F=4, 0 on the dense levels; 7.8e-9 at F=2), as the card holds the
    kernels to their plain version; dropping one bf16 rounding point moves
    it by ~1e-3, rounding K4's weights to bf16 by 4.1e-3."""
    spec_j, _, w1, x, g = _encode_inputs(F=F)
    W = spec_j.row_width
    slot, d_rows = _jax_d_rows(spec_j, w1, x, g)
    parts = []
    for l in range(spec_j.n_levels):
        parts.append(jnp.zeros((spec_j.sizes[l], W), jnp.float32)
                     .at[slot[l] - spec_j.offsets[l]]
                     .add(d_rows[l].astype(jnp.float32)))
    d_ref = np.asarray(jnp.concatenate(parts, axis=0))
    d_t = the.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    torch.from_numpy(w1), _spec_t(F)).numpy()
    assert d_t.shape == d_ref.shape == (spec_j.total_rows, W)
    assert np.abs(d_ref).max() > 0
    assert _rel(d_t, d_ref) <= 1e-5
    assert (d_t[:, 27 * F:] == 0).all()
    if F == 2:
        return
    with pltpu.force_tpu_interpret_mode():
        for l in range(2):                    # the dense levels (R <= 4096)
            R, off = spec_j.sizes[l], spec_j.offsets[l]
            oh = np.asarray(scatter_onehot(
                d_rows[l].astype(jnp.float32), slot[l] - off,
                n_rows=-(-R // 8) * 8, exact=False))[:R]
            assert _rel(d_t[off:off + R], oh) <= 1e-5


@pytest.mark.parametrize("F", [4, 2])
def test_hash_encode_mlp_grads_match_jax_grad(F):
    """HashEncodeMLP's d_table (to the f32 table) and d_w1 against
    jax.grad of `_encode_mlp_pl_cv` (interpreted Pallas; f16 rows at F=4,
    f32 rows at F=2); h1 and d_w1 within 1e-5 (measured at most 1.9e-7).
    d_table within 1e-4 (measured 7.8e-6 at F=4, 9.1e-6 at F=2): the
    forward's h1, and so g's path into d_wr, is summed in another order,
    and one d_wr that differs in its last bit rounds a product to the
    other bf16 neighbour (2^-8 of that term)."""
    spec_j, table, w1, x, g = _encode_inputs(seed=1, F=F)

    def loss(t, w):
        return (jhe._encode_mlp_pl_cv(spec_j, 128, jnp.asarray(x), t, w)
                * jnp.asarray(g)).sum()

    with pltpu.force_tpu_interpret_mode():
        h_j = np.asarray(jhe._encode_mlp_pl_cv(
            spec_j, 128, jnp.asarray(x), jnp.asarray(table), jnp.asarray(w1)))
        dt_j, dw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                                   jnp.asarray(w1))
    spec_t = _spec_t(F)
    t_t = torch.nn.Parameter(torch.from_numpy(table))
    w_t = torch.nn.Parameter(torch.from_numpy(w1))
    h_t = the.hash_encode_mlp(torch.from_numpy(x), t_t, w_t,
                              the.encode_table(t_t.detach(), spec_t), spec_t)
    (h_t * torch.from_numpy(g)).sum().backward()
    assert _rel(h_t.detach().numpy(), h_j) <= 1e-5
    assert _rel(t_t.grad.numpy(), dt_j) <= 1e-4
    assert _rel(w_t.grad.numpy(), dw_j) <= 1e-5


def _tail_inputs(P=512, seed=2):
    rng = np.random.default_rng(seed)
    h1 = (rng.normal(0, 2.0, (P, 64))).astype(np.float32)
    h1[:8] *= 20.0                     # saturate the TruncExp clamp
    d = rng.normal(size=(P, 3)).astype(np.float32)
    sh = sh_encode(torch.from_numpy(
        (d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5)).numpy()
    ws = [(rng.normal(0, 0.3, s)).astype(np.float32)
          for s in ((64, 16), (32, 64), (64, 64), (64, 3))]
    g_sigma = rng.normal(0, 1e-2, P).astype(np.float32)
    g_rgb = rng.normal(0, 1, (P, 3)).astype(np.float32)
    return h1, sh, ws, g_sigma, g_rgb


def _wr3p(wr3):
    return jnp.pad(jnp.asarray(wr3), ((0, 0), (0, 5)))


def test_plain_k8_matches_interpreted_field_tail_bwd(monkeypatch):
    """dh1 and the four weight gradients against `_field_tail_bwd` run
    interpreted.  Same rounding points, f32 sums in another order: 1e-5
    of max |.| per output (measured at most 1.8e-8; dropping one bf16
    rounding point moves it by ~1e-3)."""
    monkeypatch.setattr(jfp, "_FORCE_INTERPRET", True)
    h1, sh, ws, g_sigma, g_rgb = _tail_inputs()
    P = h1.shape[0]
    g = np.zeros((8, P), np.float32)
    g[0], g[1:4] = g_sigma, g_rgb.T
    res = (jnp.asarray(h1), jnp.asarray(sh.T), jnp.asarray(ws[0]),
           jnp.asarray(ws[1]), jnp.asarray(ws[2]), _wr3p(ws[3]))
    out_j = jfp._field_tail_bwd(256, res, jnp.asarray(g))
    ref = [out_j[0], out_j[2], out_j[3], out_j[4], out_j[5][:, :3]]
    got = tft.field_tail_bwd_plain(*map(torch.from_numpy, (
        h1, sh, g_sigma, g_rgb, *ws)))
    for name, a, b in zip(("dh1", "dw2", "dwr1", "dwr2", "dwr3"), got, ref):
        assert a.shape == np.asarray(b).shape, name
        assert _rel(a.numpy(), b) <= 1e-5, name


def test_field_tail_fn_grads_match_jax_grad(monkeypatch):
    """FieldTail (K7 forward, K8 backward) against jax.grad through the
    custom VJP of `field_tail`: h1 and weight gradients within 1e-5
    (measured at most 1.6e-10), no gradient to sh."""
    monkeypatch.setattr(jfp, "_FORCE_INTERPRET", True)
    h1, sh, ws, g_sigma, g_rgb = _tail_inputs(seed=3)

    def loss(h, w2, wr1, wr2, wr3):
        out = jfp.field_tail(256, h, jnp.asarray(sh.T), w2, wr1, wr2,
                             jnp.pad(wr3, ((0, 0), (0, 5))))
        return (out[0] * g_sigma).sum() + (out[1:4].T * g_rgb).sum()

    grads_j = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(h1), *map(jnp.asarray, ws))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (h1, *ws)]
    sh_t = torch.from_numpy(sh).requires_grad_()
    sigma, rgb = tft.field_tail_fn(leaves[0], sh_t, *leaves[1:])
    ((sigma * torch.from_numpy(g_sigma)).sum()
     + (rgb * torch.from_numpy(g_rgb)).sum()).backward()
    for a, b in zip(leaves, grads_j):
        assert _rel(a.grad.numpy(), b) <= 1e-5
    assert sh_t.grad is None


@pytest.mark.parametrize("R,P", [(64, 500), (128, 2048)])
def test_plain_k6_matches_scatter_accum(R, P):
    """f32 sums in another order: 1e-5 relative (measured 0 here)."""
    rng = np.random.default_rng(R)
    d = rng.normal(size=(P, 128)).astype(np.float32)
    idx = rng.integers(0, R, P)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(scatter_accum(jnp.asarray(d),
                                       jnp.asarray(idx.astype(np.int32)),
                                       n_rows=R, block=256))
    got = tsr.scatter_rows(torch.from_numpy(d), torch.from_numpy(idx), R)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("F", [4, 2])
def test_cpu_dispatch_runs_plain_and_counts_no_launch(F):
    spec_j, _, w1, x, g = _encode_inputs(N=32, F=F)
    spec_t = _spec_t(F)
    counters = (the.hash_encode_bwd_cuda, the.hash_encode_bwd_f2_cuda,
                tft.field_tail_bwd_cuda, tsr.scatter_rows_cuda)
    before = [c.launches for c in counters]
    args = tuple(map(torch.from_numpy, (x, g, w1))) + (spec_t,)
    torch.testing.assert_close(the.hash_encode_bwd(*args),
                               the.hash_encode_bwd_plain(*args),
                               rtol=0, atol=0)
    h1, sh, ws, g_sigma, g_rgb = _tail_inputs(P=32)
    targs = tuple(map(torch.from_numpy, (h1, sh, g_sigma, g_rgb, *ws)))
    for a, b in zip(tft.field_tail_bwd(*targs),
                    tft.field_tail_bwd_plain(*targs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = torch.from_numpy(h1)
    idx = torch.arange(32) % 5
    torch.testing.assert_close(tsr.scatter_rows(rows, idx, 5),
                               tsr.scatter_rows_plain(rows, idx, 5),
                               rtol=0, atol=0)
    assert [c.launches for c in counters] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: each kernel entry rejects CPU tensors."""
    spec_j, _, w1, x, g = _encode_inputs(N=32)
    _, _, w1_2, _, _ = _encode_inputs(N=32, F=2)
    h1, sh, ws, g_sigma, g_rgb = _tail_inputs(P=32)
    calls = (
        lambda: the.hash_encode_bwd_cuda(*map(torch.from_numpy, (x, g, w1)),
                                         _spec_t(4)),
        lambda: the.hash_encode_bwd_f2_cuda(
            *map(torch.from_numpy, (x, g, w1_2)), _spec_t(2)),
        lambda: tft.field_tail_bwd_cuda(*map(torch.from_numpy, (
            h1, sh, g_sigma, g_rgb, *ws))),
        lambda: tsr.scatter_rows_cuda(torch.from_numpy(h1),
                                      torch.zeros(32, dtype=torch.int64), 4))
    for call in calls:
        with pytest.raises(ValueError):
            call()
