"""Port parity: SH, TruncExp, the plain K7 (fused field tail) and the NGP
field against the JAX package, with parameters carried over by
`params_from_numpy`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.ops.field_pallas import _field_tail_impl
from ngp_pl_tpu.ops.sh import sh_encode as jax_sh
from ngp_pl_tpu.ops.trunc_exp import trunc_exp as jax_trunc_exp
from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops import field_tail as tft
from ngp_pl_torch.ops.hash_encoding import table_f16
from ngp_pl_torch.ops.sh import sh_encode
from ngp_pl_torch.ops.trunc_exp import trunc_exp
from ngp_pl_torch.training.checkpoint import params_from_numpy

torch.set_num_threads(2)


def _tail_inputs(P=256, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(0, 1, (P, 64)).astype(np.float32)
    sh = rng.normal(0, 0.3, (P, 16)).astype(np.float32)
    ws = [rng.normal(0, 0.2, s).astype(np.float32)
          for s in ((64, 16), (32, 64), (64, 64), (64, 3))]
    # h0 = relu(h1) @ W2[:, 0] far past +30 and below -30: the clamp binds
    h1[0] = np.abs(h1[0]) * 100.0 * np.sign(ws[0][:, 0])
    h1[1] = np.abs(h1[1]) * 100.0 * -np.sign(ws[0][:, 0])
    return h1, sh, ws


def test_plain_k7_matches_interpreted_pallas():
    """sigma rtol 1e-5 (h is an f32 sum of exact bf16 products, summed in
    another order); rgb atol 4e-3 (an activation may round to the other
    bf16 neighbour when its f32 sum differs in the last bit)."""
    h1, sh, ws = _tail_inputs()
    wr3p = np.pad(ws[3], ((0, 0), (0, 5)))
    out = np.asarray(_field_tail_impl(
        128, jnp.asarray(h1), jnp.asarray(sh.T), *map(jnp.asarray, ws[:3]),
        jnp.asarray(wr3p), interpret=True))
    sigma, rgb = tft.field_tail_plain(torch.from_numpy(h1),
                                      torch.from_numpy(sh),
                                      *map(torch.from_numpy, ws))
    np.testing.assert_allclose(sigma.numpy(), out[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(rgb.numpy(), out[1:4].T, rtol=0, atol=4e-3)
    assert sigma[0] == pytest.approx(np.exp(30.0), rel=1e-6)
    assert sigma[1] == pytest.approx(np.exp(-30.0), rel=1e-6)


def test_field_tail_cpu_dispatch_and_cuda_refusal():
    h1, sh, ws = _tail_inputs(P=16)
    args = [torch.from_numpy(h1), torch.from_numpy(sh)] + [
        torch.from_numpy(w) for w in ws]
    before = tft.field_tail_cuda.launches
    s, r = tft.field_tail(*args)
    s_p, r_p = tft.field_tail_plain(*args)
    assert torch.equal(s, s_p) and torch.equal(r, r_p)
    assert tft.field_tail_cuda.launches == before
    with pytest.raises(ValueError):
        tft.field_tail_cuda(*args)


def test_field_tail_supported_matches():
    from ngp_pl_tpu.ops.field_pallas import field_tail_supported as jsup

    for kw in ({}, {"rgb_act": "None"}, {"rgb_layers": 3}):
        assert tft.field_tail_supported(NGPConfig(**kw)) == jsup(
            JaxNGPConfig(**kw))


def test_sh_matches():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d01 = (d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5
    for deg in (1, 2, 3, 4):
        np.testing.assert_allclose(
            sh_encode(torch.from_numpy(d01), deg).numpy(),
            np.asarray(jax_sh(jnp.asarray(d01), deg)), rtol=1e-6, atol=1e-7)


def test_trunc_exp_matches_with_gradient():
    x = np.array([-100.0, -20.0, -1.0, 0.0, 3.0, 20.0, 40.0, 100.0],
                 np.float32)
    y_j, vjp = jax.vjp(jax_trunc_exp, jnp.asarray(x))
    (g_j,) = vjp(jnp.ones_like(y_j))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = trunc_exp(xt)
    y_t.sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-6)
    assert float(y_t.detach()[-1]) == pytest.approx(np.exp(30.0), rel=1e-6)
    assert float(xt.grad[-1]) == pytest.approx(np.exp(15.0), rel=1e-6)


def _models(table_scale=1e3, F=4):
    kw = dict(scale=0.5, n_levels=4, n_features_per_level=F,
              log2_hashmap_size=12, grid_size=32)
    jngp = JaxNGP(JaxNGPConfig(**kw), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * table_scale
    tngp = NGP(NGPConfig(**kw), device="cpu")
    tngp.load_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jngp, params, tngp


def _points(N=512, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("F,rtol", [(4, 1e-2), (2, 1e-5)])
def test_ngp_density_matches_jax(F, rtol):
    """JAX's CPU density, jitted as every caller in the JAX package runs
    it, reads the f32 table (XLA path).  F=4: the port reads its f16 copy,
    sigma within 1% relative.  F=2: the port reads the f32 table too, with
    the same rounding points (f32 corner weights, bf16 weighted rows, bf16
    operands of the second layer, its output kept in f32 as XLA keeps it
    under jit), sigma within 1e-5 relative."""
    jngp, params, tngp = _models(F=F)
    x, _ = _points()
    s_j = np.asarray(jax.jit(jngp.density)(params, jnp.asarray(x)))
    with torch.no_grad():
        s_t = tngp.density(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=rtol)


@pytest.mark.parametrize("F", [4, 2])
def test_ngp_forward_matches_jax(F):
    """JAX's CPU forward runs the XLA tail (bf16-rounded between layers) on
    f32 rows; the port runs K7 numerics on the table the encode reads (the
    f16 copy at F=4, the f32 table at F=2): sigma 1% relative, rgb 1e-2
    absolute, as the two tails differ whatever the table."""
    jngp, params, tngp = _models(F=F)
    x, d = _points()
    s_j, r_j = jngp.forward(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        s_t, r_t = tngp(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-2)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=1e-2)


def test_density_keeps_the_second_layer_output_in_f32_as_jitted_jax():
    """`_mlp_apply` asks for a bf16 output of its bf16 matmul.  Eager JAX
    rounds it; under jit XLA drops the round trip to bf16 and back (its
    default excess precision), so the grid refresh, which runs jitted,
    reads an f32 h.  The port's density keeps that f32 output: at F=2,
    where both read the f32 table, h within 1e-6 of its max (bf16 rounding
    would miss by ~2e-3)."""
    jngp, params, tngp = _models(F=2)
    x, _ = _points()

    def feat(p, x):
        return jngp.density(p, x, return_feat=True)[1]

    h_eager = np.asarray(feat(params, jnp.asarray(x)))
    h_jit = np.asarray(jax.jit(feat)(params, jnp.asarray(x)))
    as_bf16 = np.asarray(jnp.asarray(h_jit).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    assert np.array_equal(h_eager, np.asarray(
        jnp.asarray(h_eager).astype(jnp.bfloat16).astype(jnp.float32)))
    assert not np.array_equal(h_jit, as_bf16)
    with torch.no_grad():
        s_t, h_t = tngp.density(torch.from_numpy(x), return_feat=True)
    err = np.abs(h_t.numpy() - h_jit).max() / np.abs(h_jit).max()
    assert err <= 1e-6, err
    np.testing.assert_allclose(s_t.numpy(), np.exp(h_jit[:, 0]), rtol=1e-5)


@pytest.mark.parametrize("F", [4, 2])
def test_ngp_params_layout_matches_jax(F):
    jngp, params, tngp = _models(table_scale=1.0, F=F)
    got = tngp.params_numpy()
    assert got["hash_table"].shape == params["hash_table"].shape
    assert got["hash_table"].shape[1] == 32 * F
    for name in ("sigma_mlp", "rgb_mlp"):
        assert [w.shape for w in got[name]] == [w.shape for w in params[name]]
        for a, b in zip(got[name], params[name]):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_ngp_rejects_uncovered_heads():
    """The heads are the Sigmoid and the HDR ("None") one; the JAX package
    has no other (it would look for tonemappers it never made)."""
    with pytest.raises(NotImplementedError):
        NGP(NGPConfig(rgb_act="Softplus"), device="cpu")


def test_ngp_table16_built_once_and_refreshed_on_update():
    """At F=4 field queries share one f16 table copy until the table
    changes."""
    kw = dict(scale=0.5, n_levels=4, n_features_per_level=4,
              log2_hashmap_size=12, grid_size=32)
    tngp = NGP(NGPConfig(**kw), device="cpu")
    x, _ = _points(N=64)
    with torch.no_grad():
        s0 = tngp.density(torch.from_numpy(x))
    t16 = tngp.encode_table()
    assert t16.dtype == torch.float16
    assert tngp.encode_table() is t16
    params = tngp.params_numpy()
    params["hash_table"] = params["hash_table"] * 1e3
    tngp.load_params(params)
    t16_new = tngp.encode_table()
    assert t16_new is not t16
    torch.testing.assert_close(
        t16_new, table_f16(torch.from_numpy(params["hash_table"])),
        rtol=0, atol=0)
    with torch.no_grad():
        s1 = tngp.density(torch.from_numpy(x))
    assert not torch.equal(s0, s1)


def test_ngp_f2_encodes_the_f32_table_itself():
    """At F=2 the encode reads the f32 parameter itself: no copy is made,
    so an update is seen at once."""
    kw = dict(scale=0.5, n_levels=4, n_features_per_level=2,
              log2_hashmap_size=12, grid_size=32)
    tngp = NGP(NGPConfig(**kw), device="cpu")
    t = tngp.encode_table()
    assert t.dtype == torch.float32 and t.shape[1] == 64
    assert t.data_ptr() == tngp.hash_table.data_ptr()
    assert not t.requires_grad
    x, _ = _points(N=64)
    with torch.no_grad():
        s0 = tngp.density(torch.from_numpy(x))
        tngp.hash_table.mul_(1e3)
        s1 = tngp.density(torch.from_numpy(x))
    assert not torch.equal(s0, s1)
