"""Port parity for the render slice: scene hits, the occupied-span pre-pass,
one marching round, the test-time compositor, the occupancy grid build and
the whole round renderer, against the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.models import occupancy as jocc
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.rendering import make_device_round_renderer
from ngp_pl_tpu.models.rendering import scene_hits as jax_scene_hits
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.ops.volume_render import composite_test_round as jax_comp
from ngp_pl_torch.config import NGPConfig, RenderConfig
from ngp_pl_torch.models import occupancy as tocc
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.rendering import (
    RoundRenderer,
    bucket_ladder,
    scene_hits,
)
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.ops.volume_render import composite_test_round

torch.set_num_threads(2)

G = 32
MODEL_KW = dict(scale=0.5, n_levels=4, n_features_per_level=4,
                log2_hashmap_size=12, grid_size=G)
DT_MIN = float(np.sqrt(3.0) / 1024)


def _occ(seed=0, frac=0.3):
    rng = np.random.default_rng(seed)
    occ = (rng.random((1, G, G, G)) < frac).astype(np.uint8)
    occ[:, :6] = 0                  # an empty slab the span pass must skip
    return occ


def _rays(N=300, seed=0):
    rng = np.random.default_rng(seed)
    cam = np.array([0.2, -1.4, 0.5], np.float32)
    fwd = -cam / np.linalg.norm(cam)
    d = rng.normal(size=(N, 3)) * 0.25 + fwd
    ro = np.tile(cam, (N, 1)).astype(np.float32)
    rd = d.astype(np.float32)
    rd[:8] = -rd[:8]                # rays pointing away: they miss the box
    return ro, rd


def _hits(ro, rd):
    return np.array(jax.jit(lambda o, d: jax_scene_hits(o, d, 0.5))(ro, rd))


def test_scene_hits_match():
    ro, rd = _rays()
    t = scene_hits(torch.from_numpy(ro), torch.from_numpy(rd), 0.5).numpy()
    np.testing.assert_array_equal(t, _hits(ro, rd))
    assert (t[:8] == -1).all()


@pytest.mark.parametrize("n_samples,chain", [(8, 256), (64, 256), (16, 128)])
def test_march_round_matches(n_samples, chain):
    """Identical valid masks and counts; ts within 1e-6 (the closed-form
    chain t0 + k * dt_min may be contracted into one FMA by XLA)."""
    ro, rd = _rays()
    h = _hits(ro, rd)
    occ = _occ()
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              max_samples=1024, n_samples=n_samples, chain_length=chain)
    j = jrm.march_rays_test_round(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(h[:, 0]),
        jnp.asarray(h[:, 1]), jnp.asarray(occ), **kw)
    t = trm.march_rays_test_round(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(h[:, 0]),
        torch.from_numpy(h[:, 1]), torch.from_numpy(occ), **kw)
    valid = np.asarray(j[2])
    assert valid.sum() > 100
    np.testing.assert_array_equal(t[2].numpy(), valid)
    np.testing.assert_array_equal(t[4].numpy(), np.asarray(j[4]))
    np.testing.assert_allclose(t[0].numpy()[valid], np.asarray(j[0])[valid],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-7)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("f,scale,grid", [(0.0, 0.5, 128), (1.0 / 256, 4.0, 128)])
def test_chain_t_and_calc_dt_match(f, scale, grid):
    """The closed-form dt-chain, also its exponential branch (scale > 0.5)."""
    dt_min = DT_MIN
    dt_max = float(np.sqrt(3.0)) * 2.0 * scale / grid
    t0 = np.array([[0.01], [0.3], [1.7], [6.0]], np.float32)
    k = np.arange(600, dtype=np.float32)[None, :]
    j = np.array(jrm._chain_t(jnp.asarray(t0), jnp.asarray(k), f, dt_min,
                              dt_max))
    t = trm.chain_t(torch.from_numpy(t0), torch.from_numpy(k), f, dt_min,
                    dt_max).numpy()
    np.testing.assert_allclose(t, j, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(
        trm.calc_dt(torch.from_numpy(j), f, 1024, grid, scale).numpy(),
        np.asarray(jrm.calc_dt(jnp.asarray(j), f, 1024, grid, scale)),
        rtol=1e-6)


def test_occupied_span_matches():
    ro, rd = _rays()
    h = _hits(ro, rd)
    occ = _occ()
    lines = jrm.occupied_span_prep(jnp.asarray(occ), grid_size=G)
    j = jrm.occupied_span(jnp.asarray(ro), jnp.asarray(rd),
                          jnp.asarray(h[:, 0]), jnp.asarray(h[:, 1]), None,
                          scale=0.5, grid_size=G, dt_min=DT_MIN,
                          span_lines=lines)
    span = trm.occupied_span_prep(torch.from_numpy(occ), grid_size=G)
    t = trm.occupied_span(torch.from_numpy(ro), torch.from_numpy(rd),
                          torch.from_numpy(h[:, 0]), torch.from_numpy(h[:, 1]),
                          span, scale=0.5, dt_min=DT_MIN)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (t[2].numpy()[:8] == 0).all() and (t[2].numpy() > 0).sum() > 100


@pytest.mark.parametrize("sigma_scale", [1.0, 1e9])
def test_composite_round_matches(sigma_scale):
    """Including the huge-sigma case that SD_CLAMP bounds."""
    rng = np.random.default_rng(3)
    N, S = 64, 16
    sig = (rng.random((N, S)) * 50 * sigma_scale).astype(np.float32)
    rgbs = rng.random((N, S, 3)).astype(np.float32)
    dts = np.full((N, S), DT_MIN, np.float32)
    ts = np.cumsum(dts, axis=1) + 0.5
    valid = rng.random((N, S)) < 0.8
    opa = (rng.random(N) * 0.5).astype(np.float32)
    dep = rng.random(N).astype(np.float32)
    rgb = rng.random((N, 3)).astype(np.float32)
    alive = rng.random(N) < 0.9
    j = jax_comp(*map(jnp.asarray, (sig, rgbs, dts, ts, valid, opa, dep, rgb,
                                    alive)), 1e-4)
    t = composite_test_round(*map(torch.from_numpy, (
        sig, rgbs, dts, ts, valid, opa, dep, rgb, alive)), 1e-4)
    for a, b in zip(j[:3], t[:3]):
        assert np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def test_bucket_ladder():
    """The 800x800 ladder; the JAX renderer's own choice of these buckets is
    held in test_round_renderer_bucket_ladder_matches_jax."""
    assert bucket_ladder(131072, 1) == [
        (131072, 8, 256), (65536, 16, 128), (32768, 32, 128),
        (16384, 64, 256), (8192, 64, 256), (4096, 64, 256), (2048, 64, 256),
        (1024, 64, 256), (512, 64, 256)]
    assert bucket_ladder(256, 1) == [(256, 64, 256)]


def _grid_inputs():
    from ngp_pl_tpu.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(split="train", downsample=0.125, read_meta=False)
    # three cameras leave part of the box unseen
    return ds.K, ds.poses[:3], ds.img_wh


def test_mark_invisible_cells_matches():
    """Same camera coverage per cell; a cell exactly on an image border may
    flip with the summation order of the projection (<= 0.1% of cells)."""
    K, poses, (w, h) = _grid_inputs()
    jc, tc = JaxNGPConfig(**MODEL_KW), NGPConfig(**MODEL_KW)
    js = jocc.mark_invisible_cells(jocc.init_grid_state(jc), jnp.asarray(K),
                                   jnp.asarray(poses), cfg=jc, img_w=w,
                                   img_h=h)
    ts = tocc.mark_invisible_cells(tocc.init_grid_state(tc, "cpu"), K, poses,
                                   cfg=tc, img_w=w, img_h=h)
    d_j, d_t = np.asarray(js.density_grid), ts.density_grid.numpy()
    assert (d_j == -1).sum() > 100 and (d_j == 0).sum() > 1000
    assert (d_j != d_t).mean() <= 1e-3
    assert (np.asarray(js.count_grid) != ts.count_grid.numpy()).mean() <= 1e-3


@pytest.mark.parametrize("F", [4, 2])
def test_warmup_density_refresh_matches(F):
    """JAX's noise is handed in.  Densities within 1% (at F=4 the JAX CPU
    density reads the f32 table, the port the f16 copy); occupancy agrees
    except where a density lies within that 1% of the threshold."""
    K, poses, (w, h) = _grid_inputs()
    kw = {**MODEL_KW, "n_features_per_level": F}
    jc, tc = JaxNGPConfig(**kw), NGPConfig(**kw)
    jngp = JaxNGP(jc, need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e3
    tngp = NGP(tc, device="cpu")
    tngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    thr = 0.01 * 1024 / np.sqrt(3.0)

    js = jocc.mark_invisible_cells(jocc.init_grid_state(jc), jnp.asarray(K),
                                   jnp.asarray(poses), cfg=jc, img_w=w,
                                   img_h=h)
    key = jax.random.PRNGKey(7)
    js = jocc.make_update_density_grid(jngp, jc)(
        params, js, key, jnp.asarray(thr, jnp.float32), warmup=True)
    _, k_noise = jax.random.split(key)
    noise = np.array(jax.random.uniform(k_noise, (G ** 3, 3), minval=-1.0,
                                          maxval=1.0))[None]

    ts = tocc.mark_invisible_cells(tocc.init_grid_state(tc, "cpu"), K, poses,
                                   cfg=tc, img_w=w, img_h=h)
    ts = tocc.update_density_grid(tngp, ts, thr,
                                  noise=torch.from_numpy(noise))
    d_j, d_t = np.asarray(js.density_grid), ts.density_grid.numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-2, atol=0)
    assert float(ts.mean_density) == pytest.approx(float(js.mean_density),
                                                   rel=1e-2)
    occ_j, occ_t = np.asarray(js.occ_grid), ts.occ_grid.numpy()
    assert 0.05 < occ_j.mean() < 0.95
    t_j = min(float(js.mean_density), thr)
    near = np.abs(d_j - t_j).reshape(occ_j.shape) <= 1e-2 * t_j
    assert ((occ_j != occ_t) & ~near).sum() == 0


def test_refresh_sanitises_nan_density():
    tc = NGPConfig(**MODEL_KW)
    ngp = NGP(tc, device="cpu")
    with torch.no_grad():
        ngp.sigma_mlp[1].fill_(float("nan"))
    st = tocc.update_density_grid(ngp, tocc.init_grid_state(tc, "cpu"), 5.9,
                                  generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(st.density_grid).all()
    assert torch.isfinite(st.mean_density)


def _render_models(F=4):
    kw = {**MODEL_KW, "n_features_per_level": F}
    jngp = JaxNGP(JaxNGPConfig(**kw), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e4
    # a denser sigma head so that rays terminate inside the box
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(8.0)
    tngp = NGP(NGPConfig(**kw), device="cpu")
    tngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    return jngp, params, tngp


@pytest.mark.parametrize("F", [4, 2])
def test_round_renderer_matches_jax(F):
    """The whole slice at grid 32, L=4, 300 rays, chunk 256, with the F=4
    (K1) and the F=2 (K3) encode: rgb and opacity within 5e-3, depth
    within 1e-2, total samples within 1%."""
    jngp, params, tngp = _render_models(F)
    occ = _occ()
    ro, rd = _rays()
    out_j = make_device_round_renderer(jngp, JaxRenderConfig(), chunk=256)(
        params, jnp.asarray(occ), ro, rd)
    out_t = RoundRenderer(tngp, RenderConfig(), chunk=256).render_image(
        torch.from_numpy(occ), torch.from_numpy(ro), torch.from_numpy(rd))
    assert out_t["opacity"].max() > 0.99            # some rays terminate
    np.testing.assert_allclose(out_t["rgb"].numpy(), out_j["rgb"], atol=5e-3)
    np.testing.assert_allclose(out_t["opacity"].numpy(), out_j["opacity"],
                               atol=5e-3)
    np.testing.assert_allclose(out_t["depth"].numpy(), out_j["depth"],
                               atol=1e-2)
    assert out_t["total_samples"] == pytest.approx(out_j["total_samples"],
                                                   rel=1e-2)
    assert out_t["alive_rays"] == out_j["alive_rays"]


def _ladder_renders(monkeypatch, frac):
    """3,000 rays at chunk 4096 through both renderers; the port's bucket
    picks are recorded."""
    jngp, params, tngp = _render_models()
    occ = _occ(frac=frac)
    ro, rd = _rays(N=3000)
    out_j = make_device_round_renderer(jngp, JaxRenderConfig(), chunk=4096)(
        params, jnp.asarray(occ), ro, rd)
    used = []
    pick = RoundRenderer._bucket
    monkeypatch.setattr(RoundRenderer, "_bucket",
                        lambda self, n: used.append(pick(self, n)) or used[-1])
    renderer = RoundRenderer(tngp, RenderConfig(), chunk=4096)
    out_t = renderer.render_image(
        torch.from_numpy(occ), torch.from_numpy(ro), torch.from_numpy(rd))
    assert renderer.buckets == [(4096, 8, 256), (2048, 16, 128),
                                (1024, 32, 128), (512, 64, 256)]
    assert set(used) == set(renderer.buckets)      # the whole ladder
    return out_j, out_t, used


def test_round_renderer_bucket_ladder_matches_jax(monkeypatch):
    """The rays step down the whole ladder: 8 samples with a 256-step chain,
    then 16, 32 and 64.  Rounds equal, total samples within 1%, depth within
    1e-2, rgb and opacity within 5e-2 on every ray and within 5e-3 on all
    but 0.5% of rays.  The few rays beyond 5e-3 end on a steep surface where
    the two fields' numerics differ (JAX's CPU field reads f32 rows through
    the XLA path, the port keeps the TPU kernels' bf16 rounding points);
    they differ as much at chunk 256, with one bucket."""
    out_j, out_t, used = _ladder_renders(monkeypatch, frac=0.3)
    assert out_t["rounds"] == out_j["rounds"] == len(used)
    assert out_t["total_samples"] == pytest.approx(out_j["total_samples"],
                                                   rel=1e-2)
    np.testing.assert_allclose(out_t["depth"].numpy(), out_j["depth"],
                               atol=1e-2)
    for k in ("rgb", "opacity"):
        err = np.abs(out_t[k].numpy() - out_j[k]).reshape(3000, -1).max(1)
        assert err.max() <= 5e-2, k
        assert (err > 5e-3).mean() <= 5e-3, k


def test_round_renderer_bucket_chains_match_jax_sparse(monkeypatch):
    """On a sparse grid rays cross empty cells beyond a round's chain, so
    each bucket's chain length sets how many rounds a chunk takes: rounds
    equal and total samples within 1% of JAX's."""
    out_j, out_t, used = _ladder_renders(monkeypatch, frac=0.05)
    assert out_t["rounds"] == out_j["rounds"] == len(used)
    assert out_t["total_samples"] == pytest.approx(out_j["total_samples"],
                                                   rel=1e-2)


def test_round_renderer_empty_scene():
    jngp, params, tngp = _render_models()
    occ = np.zeros((1, G, G, G), np.uint8)
    ro, rd = _rays(N=64)
    out_j = make_device_round_renderer(jngp, JaxRenderConfig(), chunk=256)(
        params, jnp.asarray(occ), ro, rd)
    out_t = RoundRenderer(tngp, RenderConfig(), chunk=256).render_image(
        torch.from_numpy(occ), torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_array_equal(out_t["opacity"].numpy(), 0.0)
    np.testing.assert_array_equal(out_t["rgb"].numpy(), 1.0)   # white bg
    assert out_t["total_samples"] == out_j["total_samples"] == 0
    assert out_t["rounds"] == out_j["rounds"] == 0
    np.testing.assert_array_equal(out_j["opacity"], 0.0)

