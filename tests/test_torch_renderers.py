"""The JAX package's two other renderers and the round renderer's tuning
arguments, against the JAX package on the CPU, at the sizes of
tests/test_round_renderer.py: grid 32 with an occupied 16^3 cube, L=4,
T=2^12, max_samples 256, 256 rays from (0, 0, -1.5), the seeded hash
table x1e3 (the JAX test's densities: opacities up to ~0.4).

Limits: the one-pass renderers march the same pool bit for bit, so their
total samples are equal; rgb and opacity within 5e-3 and depth within
1e-2, tests/test_torch_render.py's limits of the round renderer (the two
fields' numerics differ: JAX's CPU field reads f32 rows through XLA, the
port rounds where the TPU kernels round).  The port's own renderers
against its one-pass renderer, the JAX test's twin: rgb and opacity within
its 2e-3, depth within its 5e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.rendering import (
    make_device_round_renderer,
    make_round_renderer,
    make_test_renderer,
)
from ngp_pl_torch.config import NGPConfig, RenderConfig
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.rendering import (
    HostRoundRenderer,
    RoundRenderer,
    TestRenderer,
)

torch.set_num_threads(2)

G = 32
N_RAYS = 256
MODEL_KW = dict(scale=0.5, n_levels=4, n_features_per_level=4,
                log2_hashmap_size=12, grid_size=G)
RCFG_KW = dict(max_samples=256)
JAX_TOL = dict(rgb=5e-3, opacity=5e-3, depth=1e-2)
TWIN_TOL = dict(rgb=2e-3, opacity=2e-3, depth=5e-3)


@pytest.fixture(scope="module")
def scene():
    """(JAX model, its params, the port's model, occupancy grid, rays_o,
    rays_d) of the JAX test."""
    jngp = JaxNGP(JaxNGPConfig(**MODEL_KW), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e3
    tngp = NGP(NGPConfig(**MODEL_KW), device="cpu")
    tngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    occ = np.zeros((1, G, G, G), np.uint8)
    occ[0, 8:24, 8:24, 8:24] = 1
    d = (jax.random.normal(jax.random.PRNGKey(1), (N_RAYS, 3))
         * jnp.asarray([[0.3, 0.3, 0.1]]) + jnp.asarray([[0.0, 0.0, 1.0]]))
    rd = np.array(d / jnp.linalg.norm(d, axis=-1, keepdims=True),
                  np.float32)
    ro = np.tile(np.float32([[0.0, 0.0, -1.5]]), (N_RAYS, 1))
    return jngp, params, tngp, occ, ro, rd


def _port(renderer, scene):
    *_, occ, ro, rd = scene
    return renderer.render_image(torch.from_numpy(occ), torch.from_numpy(ro),
                                 torch.from_numpy(rd))


def _jax(render, scene):
    _, params, _, occ, ro, rd = scene
    return render(params, jnp.asarray(occ), ro, rd)


def _close(got, ref, tol):
    for k, atol in tol.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("use_window", [True, False])
def test_test_renderer_matches_jax(scene, use_window):
    """Both marches (the 8-step windows, the grid with the span skip), 256
    rays in chunks of 192 so that the last chunk is padded."""
    jngp, _, tngp, *_ = scene
    kw = dict(chunk=192, pool_mult=256, use_window=use_window)
    ref = _jax(make_test_renderer(jngp, JaxRenderConfig(**RCFG_KW), **kw),
               scene)
    got = _port(TestRenderer(tngp, RenderConfig(**RCFG_KW), **kw), scene)
    assert got["total_samples"] == ref["total_samples"] > 0
    _close(got, ref, JAX_TOL)


def test_host_round_renderer_matches_jax(scene):
    jngp, _, tngp, *_ = scene
    ref = _jax(make_round_renderer(jngp, JaxRenderConfig(**RCFG_KW)), scene)
    got = _port(HostRoundRenderer(tngp, RenderConfig(**RCFG_KW)), scene)
    assert got["total_samples"] == ref["total_samples"] > 0
    _close(got, ref, JAX_TOL)


# each of make_device_round_renderer's tuning arguments on its own; the
# buckets' first slots (128) hold fewer than the ~200 alive rays, so the
# first rounds process the first alive rays only
ROUND_ARGS = {
    "buckets": dict(buckets=[(128, 4, 32), (64, 16, 64), (32, 64, 100)]),
    "max_rounds": dict(max_rounds=2),
    "span_super_factor": dict(span_super_factor=2),
    "t_threshold": dict(t_threshold=1e-2),
    "debug_const_field": dict(debug_const_field=True),
}


@pytest.mark.parametrize("arg", list(ROUND_ARGS))
def test_round_renderer_arguments_match_jax(scene, arg, monkeypatch):
    """Rounds and total samples equal, the outputs within JAX_TOL; the
    constant field evaluates no field, so neither K1 nor K7 runs."""
    jngp, _, tngp, *_ = scene
    kw = dict(chunk=256, **ROUND_ARGS[arg])
    ref = _jax(make_device_round_renderer(jngp, JaxRenderConfig(**RCFG_KW),
                                          **kw), scene)
    calls = []
    if arg == "debug_const_field":
        monkeypatch.setattr(tngp, "forward",
                            lambda *a, **k: calls.append(a) or None)
    got = _port(RoundRenderer(tngp, RenderConfig(**RCFG_KW), **kw), scene)
    assert not calls
    assert got["rounds"] == ref["rounds"]
    assert got["total_samples"] == ref["total_samples"] > 0
    _close(got, ref, JAX_TOL)


@pytest.mark.parametrize("renderer", ["host_rounds", "rounds"])
def test_round_renderers_match_one_pass(scene, renderer):
    """The JAX test's twin in the port: each round renderer against the
    one-pass renderer (chunk 256, pool x256) on the same scene."""
    tngp = scene[2]
    rcfg = RenderConfig(**RCFG_KW)
    ref = _port(TestRenderer(tngp, rcfg, chunk=N_RAYS, pool_mult=256), scene)
    got = _port(HostRoundRenderer(tngp, rcfg) if renderer == "host_rounds"
                else RoundRenderer(tngp, rcfg, chunk=256), scene)
    _close(got, ref, TWIN_TOL)
