"""Port parity for the multi-cascade / exponential-step slice (scale > 0.5)
against the JAX package on the CPU: the cascade lookup (`mip_from_pos`,
`mip_from_dt`, `_grid_coords`, `occupancy_at`, `occupancy_at_lines`), the
chain's XLA exp, the two-window chain `_occ_window_chain_mc` with its
fallbacks, `march_rays_train` in its three branches, the strided march and
the test round in their multi-cascade branches, the exp-step scene chain,
the round renderer at cascades 3, one scale-2 train step, the system's
march choice and buckets, the scaled synthetic scene; and the march
against the CUDA-behaviour spec of tests/cuda_spec.py.

The port fuses what XLA fuses but takes torch's float32 `exp`, which
differs from XLA's CPU one by an ulp in about a tenth of the arguments, so
chain positions and step sizes are held within two ulps (TS_RTOL).  Such
an ulp flips an occupancy bit only at a cell edge, and no chain position
of these inputs lies that close to one: bits, counts, owners, offsets and
demands are compared for equality.  Sizes: grid 32, L=4, log2 T=12, a few
hundred rays."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_pl_tpu.models.ngp as jngp_mod
from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models import rendering as jrender
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.training import losses as jlosses
from ngp_pl_tpu.training import train_step as jts
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import NGPConfig, RenderConfig, TrainConfig
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.rendering import (
    RoundRenderer,
    bucket_ladder,
    compute_scene_chain_length,
)
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import load_train_state
from ngp_pl_torch.training.system import NeRFSystem
from tests.test_golden_parity import _scene, _spec_march

torch.set_num_threads(2)

G = 32
F_EXP = 1.0 / 256
MS = 1024
SCALES = {3: 2.0, 4: 4.0}          # cascades -> scale
N_RAYS = 256
TS_RTOL = 2.5e-7                   # two float32 ulps


def _dt(scale):
    return math.sqrt(3.0) / MS, math.sqrt(3.0) * 2.0 * scale / G


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _grid(kind, C, seed=0):
    """Occupancy of every cascade: a shell per cascade plus scattered
    cells, uniform random, full or empty."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.random((C, G, G, G)) < 0.3).astype(np.uint8)
    if kind in ("full", "empty"):
        return np.full((C, G, G, G), kind == "full", np.uint8)
    c = (np.arange(G) + 0.5) / G * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    occ = (np.abs(r - 0.45) < 0.12)[None] | (rng.random((C, G, G, G)) < 0.02)
    return occ.astype(np.uint8)


def _rays(scale, N=N_RAYS, seed=0, spread=0.25, norm=1.0, dist=None):
    """Rays from a camera outside the box, at `dist` (3 x scale) from its
    centre, towards it, 4 pointing away; `norm` scales the directions."""
    rng = np.random.default_rng(seed)
    cam = np.array([0.2, -1.4, 0.5], np.float32) * (dist or 3 * scale) / 1.5
    fwd = -cam / np.linalg.norm(cam)
    rd = rng.normal(size=(N, 3)) * spread + fwd
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True) * norm
    rd[:4] = -rd[:4]
    return np.tile(cam, (N, 1)).astype(np.float32), rd.astype(np.float32)


def _hits(ro, rd, scale):
    return np.array(jax.jit(lambda o, d: jrender.scene_hits(o, d, scale))(
        ro, rd))


def _noise(N=N_RAYS, seed=5):
    return np.random.default_rng(seed).random(N).astype(np.float32)


def _close(a, b, name, exp_steps=True):
    """Chain positions or step sizes within TS_RTOL under exponential
    steps, equal under uniform ones (no exp on the chain)."""
    if not exp_steps:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TS_RTOL,
                               atol=0, err_msg=name)


# -- the cascade lookup -----------------------------------------------------

def _boundary_points(scale, C, seed=0):
    """Random points of the box, and points whose largest |coordinate| is
    exactly 2^k (the cascade boundaries) or one ulp either side."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-scale, scale, (4000, 3)).astype(np.float32)]
    for k in range(-3, C - 1):
        for u in (-1, 0, 1):
            v = np.float32(2.0 ** k)
            v = np.nextafter(v, np.float32(u * np.inf)) if u else v
            p = rng.uniform(-1, 1, (64, 3)).astype(np.float32) * v
            p[np.arange(64), rng.integers(0, 3, 64)] = v * rng.choice(
                [-1, 1], 64)
            pts.append(p.astype(np.float32))
    return np.concatenate(pts)


def _boundary_dts(scale):
    """Step sizes in [dt_min, dt_max] and at dt * G = 2^k exactly or one
    ulp either side."""
    dt_min, dt_max = _dt(scale)
    rng = np.random.default_rng(1)
    dts = [rng.uniform(dt_min, dt_max, 4000).astype(np.float32)]
    for k in range(-2, 4):
        v = np.float32(2.0 ** k / G)
        dts.append(np.array([np.nextafter(v, np.float32(-1)), v,
                             np.nextafter(v, np.float32(1))], np.float32))
    return np.concatenate(dts)


@pytest.mark.parametrize("C", [3, 4])
def test_cascade_lookup_matches_jax(C):
    """mip_from_pos, mip_from_dt, the cells of `_grid_coords` and the
    occupancy bits of `occupancy_at` and `occupancy_at_lines` equal JAX's,
    points on the cascade boundaries included."""
    scale = SCALES[C]
    pts = _boundary_points(scale, C)
    dts = _boundary_dts(scale)
    dts = np.resize(dts, len(pts)).astype(np.float32)
    np.testing.assert_array_equal(
        trm.mip_from_pos(_t(pts), C).numpy(),
        np.asarray(jrm.mip_from_pos(jnp.asarray(pts), C)))
    np.testing.assert_array_equal(
        trm.mip_from_dt(_t(dts), G, C).numpy(),
        np.asarray(jrm.mip_from_dt(jnp.asarray(dts), G, C)))
    mip_j, n_j = jax.jit(lambda x, d: jrm._grid_coords(x, d, C, scale, G))(
        pts, dts)
    mip_t, n_t = trm.grid_coords(_t(pts), _t(dts), C, scale, G)
    np.testing.assert_array_equal(mip_t.numpy(), np.asarray(mip_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert len(set(mip_t.tolist())) == C            # every cascade seen
    occ = _grid("random", C)
    want = np.asarray(jrm.occupancy_at(jnp.asarray(occ), jnp.asarray(pts),
                                       jnp.asarray(dts), C, scale, G))
    np.testing.assert_array_equal(
        trm.occupancy_at(_t(occ), _t(pts), _t(dts), C, scale, G).numpy(),
        want)
    rows_t = trm.occupancy_lines(_t(occ))
    np.testing.assert_array_equal(
        trm.occupancy_at_lines(rows_t, mip_t, n_t, G).numpy(),
        np.asarray(jrm.occupancy_at_lines(
            jrm.occupancy_lines(jnp.asarray(occ)), mip_j, n_j, G)))
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("C", [3, 4])
def test_exp_chain_matches_jax(C):
    """The closed-form exponential chain from jittered starts in every
    phase (linear, geometric, linear at dt_max) is JAX's `_chain_t`
    within TS_RTOL."""
    scale = SCALES[C]
    dt_min, dt_max = _dt(scale)
    rng = np.random.default_rng(C)
    t0 = np.concatenate([rng.uniform(0.01, 3 * scale, 500),
                         [-1.0, 0.0, dt_min / F_EXP,
                          dt_max / F_EXP]]).astype(np.float32)
    k = np.arange(2 * MS, dtype=np.float32)[None]
    want = np.asarray(jax.jit(lambda a, b: jrm._chain_t(
        a[:, None], b, F_EXP, dt_min, dt_max))(t0, k))
    got = trm.chain_t(_t(t0)[:, None], _t(k), F_EXP, dt_min, dt_max)
    _close(got.numpy(), want, "ts")
    assert (np.diff(want[:-4], axis=1) > dt_min * 1.5).any()   # geometric


# -- the two-window chain ---------------------------------------------------

@pytest.mark.parametrize("grid", ["shell", "random", "full", "empty"])
@pytest.mark.parametrize("C", [3, 4])
def test_window_chain_mc_matches_jax(C, grid):
    """Bits of `_occ_window_chain_mc` equal JAX's over 512 chain steps,
    positions and step sizes within TS_RTOL, fallbacks included: on the empty grid every
    occupied bit is a fallback (a step outside its window or between the
    interval's cascades): directions of norm 2 from a camera 15 away keep
    the step size's cascade at 0 while a step crosses ~1.9 of its cells,
    so steps leave their window near the centre."""
    scale = SCALES[C]
    dt_min, dt_max = _dt(scale)
    occ = _grid(grid, C)
    ro, rd = _rays(scale, N=128, norm=2.0, dist=15.0, spread=0.05)
    t0 = _hits(ro, rd, scale)[:, 0] + _noise(128) * dt_min
    KA = 128
    want = jax.jit(lambda o, d, t, w: jrm._occ_window_chain_mc(
        o, d, t, KA, w, cascades=C, scale=scale, grid_size=G,
        exp_step_factor=F_EXP, dt_min=dt_min, dt_max=dt_max))(
        ro, rd, t0, jrm.occupancy_windows(jnp.asarray(occ)))
    got = trm._occ_window_chain_mc(
        _t(ro), _t(rd), _t(t0), KA, trm.occupancy_windows(_t(occ)),
        cascades=C, scale=scale, grid_size=G, exp_step_factor=F_EXP,
        dt_min=dt_min, dt_max=dt_max)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), want[1], "ts")
    _close(got[2].numpy(), want[2], "dts")
    if grid == "empty":
        assert got[0].any()                          # the fallbacks
    if grid == "full":
        assert got[0].all()


def test_window_march_mc_ok_matches_jax():
    for d_norm, f, C in ((1.0, F_EXP, 4), (2.5, F_EXP, 4), (1.0, 1 / 32, 4),
                         (1.0, 0.0, 1), (1.0, 0.0, 3)):
        d = np.ones((5, 3), np.float32) * d_norm / np.sqrt(3)
        assert trm.window_march_mc_ok(d, f, C) == jrm.window_march_mc_ok(
            d, f, C), (d_norm, f, C)


# -- the train marches and the test round -----------------------------------

def _assert_pool(got, want, exp_steps=True):
    """Positions and deltas as `_close` holds them, the rest of the pool
    equal."""
    for k in ("ts", "deltas"):
        _close(getattr(got, k).numpy(), getattr(want, k), k, exp_steps)
    for k in ("ray_idx", "valid", "counts", "offsets", "total", "rm_counts",
              "chain_demand", "chain_demand_q"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("grid,mult", [("shell", 64), ("shell", 4),
                                       ("random", 16), ("full", 8),
                                       ("empty", 8)])
@pytest.mark.parametrize("C", [3, 4])
def test_train_pool_matches_jax(C, grid, mult, window):
    """`march_rays_train` at cascades 3 and 4, with the two-window chain
    and with the grid lookup: the pool is JAX's (owners, validity, per-ray
    counts and offsets, demand; positions and deltas within TS_RTOL),
    saturated pools (x4, full grid) included."""
    scale = SCALES[C]
    occ = _grid(grid, C)
    ro, rd = _rays(scale)
    hits, noise = _hits(ro, rd, scale), _noise()
    kw = dict(cascades=C, scale=scale, exp_step_factor=F_EXP, grid_size=G,
              max_samples=MS, pool_size=N_RAYS * mult, chain_length=2 * MS)
    want = jrm.march_rays_train(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(hits),
        jnp.asarray(occ), jnp.asarray(noise),
        occ_rows=jrm.occupancy_lines(jnp.asarray(occ)),
        win_rows=jrm.occupancy_windows(jnp.asarray(occ)) if window
        else None, **kw)
    got = trm.march_rays_train(
        _t(ro), _t(rd), _t(hits), _t(occ), _t(noise),
        win_rows=trm.occupancy_windows(_t(occ)) if window else None, **kw)
    _assert_pool(got, want)
    if grid != "empty":
        assert int(want.total) > 0


@pytest.mark.parametrize("grid", ["shell", "random"])
def test_train_pool_span_branch_matches_jax(grid):
    """One cascade, uniform steps, no windows (cameras past
    `segment_march_dmax_ok`): the occupied-span pre-pass cuts each chain,
    then the grid lookup; the pool and the span's chain demand are
    JAX's."""
    occ = _grid(grid, 1)
    ro, rd = _rays(0.5)
    hits, noise = _hits(ro, rd, 0.5), _noise()
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              max_samples=MS, pool_size=N_RAYS * 16, chain_length=1152)
    want = jrm.march_rays_train(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(hits),
        jnp.asarray(occ), jnp.asarray(noise), **kw)
    got = trm.march_rays_train(_t(ro), _t(rd), _t(hits), _t(occ),
                               _t(noise), **kw)
    _assert_pool(got, want, exp_steps=False)
    assert int(want.total) > 0


@pytest.mark.parametrize("branch", ["window_mc", "lines_mc", "lines_c1"])
def test_strided_march_other_branches_match_jax(branch):
    """`march_rays_train_strided`'s multi-cascade window branch, its z-line
    branch at cascades 3 and at one cascade without windows: kept
    positions, validity, per-ray counts, demand and the deltas of valid
    slots are JAX's, positions and deltas within TS_RTOL under exponential
    steps and equal at one cascade."""
    C = 1 if branch == "lines_c1" else 3
    scale = 0.5 if C == 1 else SCALES[3]
    f = 0.0 if C == 1 else F_EXP
    occ = _grid("shell", C)
    ro, rd = _rays(scale)
    hits, noise = _hits(ro, rd, scale), _noise()
    win = branch == "window_mc"
    kw = dict(cascades=C, scale=scale, exp_step_factor=f, grid_size=G,
              max_samples=MS, n_samples=8, chain_length=1024)
    want = jrm.march_rays_train_strided(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(hits),
        jnp.asarray(noise), jnp.asarray(occ),
        win_rows=jrm.occupancy_windows(jnp.asarray(occ)) if win else None,
        **kw)
    got = trm.march_rays_train_strided(
        _t(ro), _t(rd), _t(hits), _t(noise),
        trm.occupancy_windows(_t(occ)) if win else None, occ_grid=_t(occ),
        **kw)
    valid = np.asarray(want.valid)
    for k in ("valid", "counts", "rm_counts", "total", "chain_demand",
              "chain_demand_q"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    _close(got.ts.numpy(), want.ts, "ts", f > 0.0)
    _close(got.deltas.numpy()[valid], np.asarray(want.deltas)[valid],
           "deltas", f > 0.0)
    assert valid.sum() > 0 and (np.asarray(want.rm_counts) > 8).any()


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("C", [3, 4])
def test_test_round_matches_jax(C, window):
    """`march_rays_test_round` under multi-cascade / exponential steps,
    with the two-window chain and with the grid at each step's cascade:
    validity and counts are JAX's, positions and step sizes of the kept
    samples and the resume cursor within TS_RTOL."""
    scale = SCALES[C]
    occ = _grid("shell", C)
    ro, rd = _rays(scale)
    hits = _hits(ro, rd, scale)
    t_start = np.where(hits[:, 0] >= 0, hits[:, 0] + _noise() * 0.01,
                       -1.0).astype(np.float32)
    kw = dict(cascades=C, scale=scale, exp_step_factor=F_EXP, grid_size=G,
              max_samples=MS, n_samples=16, chain_length=256)
    want = jrm.march_rays_test_round(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_start),
        jnp.asarray(hits[:, 1]), jnp.asarray(occ),
        occ_rows=jrm.occupancy_lines(jnp.asarray(occ)),
        win_rows=jrm.occupancy_windows(jnp.asarray(occ)) if window
        else None, **kw)
    got = trm.march_rays_test_round(
        _t(ro), _t(rd), _t(t_start), _t(hits[:, 1]), _t(occ),
        win_rows=trm.occupancy_windows(_t(occ)) if window else None, **kw)
    valid = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), valid)
    for i, name in ((0, "ts"), (1, "dts")):
        _close(got[i].numpy()[valid], np.asarray(want[i])[valid], name)
    _close(got[3].numpy(), want[3], "t_next")
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert valid.sum() > 0


def test_golden_spec_multi_cascade_exp_stepping():
    """The port's march against the sequential CUDA-behaviour spec
    (tests/cuda_spec.py) on its cascades-3, exponential-step scene, under
    the rule that test_golden_parity.py holds the JAX package to: per ray
    the same samples within 1e-4 / 2e-4, or (closed form against repeated
    addition at a cell edge) a count off by at most 2 on at most 1/16 of
    the rays."""
    Gs, scale, ms = 16, 2.0, 512
    occ, o, dirs, noise = _scene(seed=11, G=Gs, cascades=3, scale=scale,
                                 max_samples=ms, occ_p=0.1)
    spec = _spec_march(occ, o, dirs, noise, cascades=3, scale=scale,
                       exp_step_factor=F_EXP, G=Gs, max_samples=ms)
    n = len(dirs)
    ro = torch.tensor(np.broadcast_to(o, (n, 3)), dtype=torch.float32)
    rd = torch.tensor(dirs, dtype=torch.float32)
    from ngp_pl_torch.models.rendering import scene_hits

    m = trm.march_rays_train(
        ro, rd, scene_hits(ro, rd, 2.0 ** (3 - 2)), _t(occ),
        torch.tensor(noise, dtype=torch.float32), cascades=3, scale=scale,
        exp_step_factor=F_EXP, grid_size=Gs, max_samples=ms,
        pool_size=n * 128, chain_length=1024, skip_empty_span=False)
    counts, offs, ts = m.counts.numpy(), m.offsets.numpy(), m.ts.numpy()
    ours = [ts[offs[i]:offs[i] + counts[i]] for i in range(n)]
    assert sum(len(s) for s in spec) > 50
    mismatched = 0
    for i, (s, u) in enumerate(zip(spec, ours)):
        if len(s) != len(u):
            mismatched += 1
            assert abs(len(s) - len(u)) <= 2, (i, len(s), len(u))
            continue
        np.testing.assert_allclose(u, np.asarray(s, np.float32), rtol=1e-4,
                                   atol=2e-4, err_msg=f"ray {i}")
    assert mismatched <= max(1, n // 16), mismatched


# -- the scene, the chain bound and the system ------------------------------

@pytest.mark.parametrize("scale,ws", [(2.0, 4.0), (4.0, 8.0)])
def test_scene_chain_length_exp_matches_jax(scale, ws):
    """The simulated clamped-geometric chain of the scaled scene's train
    cameras equals JAX's, and under uniform steps the old bound holds."""
    ds = JaxSynthetic(split="train", img_size=24, n_train=4, world_scale=ws,
                      read_meta=False)
    want = jrender.compute_scene_chain_length(ds.poses, ds.directions, scale,
                                              F_EXP, MS, G)
    got = compute_scene_chain_length(ds.poses, ds.directions, scale, F_EXP,
                                     MS, G)
    assert got == want and 128 <= got <= 2 * MS
    assert compute_scene_chain_length(
        ds.poses, ds.directions, scale, 0.0, MS, G) == \
        jrender.compute_scene_chain_length(ds.poses, ds.directions, scale,
                                           0.0, MS, G)


def test_scaled_synthetic_scene_matches_jax():
    """SyntheticDataset(world_scale=8, bg=0): poses equal, images within
    1e-4 of JAX's, as test_ground_truth_matches holds the unscaled scene."""
    for split in ("train", "test"):
        j = JaxSynthetic(split=split, img_size=16, n_train=3, n_test=2,
                         world_scale=8.0, bg=0.0)
        t = SyntheticDataset(split=split, img_size=16, n_train=3, n_test=2,
                             world_scale=8.0, bg=0.0, device="cpu")
        np.testing.assert_array_equal(t.poses, j.poses)
        np.testing.assert_allclose(t.rays.numpy(), j.rays, rtol=0,
                                   atol=1e-4)
        assert j.rays.min() == 0.0                  # black background
        assert j.rays.max() > 0.5


@dataclasses.dataclass(frozen=True)
class SmallMC(TrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


@dataclasses.dataclass(frozen=True)
class JaxSmallMC(JaxTrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def _mc_systems(scale=4.0, norm=1.0):
    ws = scale / 0.5
    kw = dict(dataset_name="synthetic", batch_size=256, num_epochs=2,
              scale=scale, exp_name="mc_test", no_save_test=True)
    js = JaxSystem(JaxSmallMC(**kw, num_devices=1),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2, world_scale=ws,
                                              bg=0.0),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1, world_scale=ws,
                                             bg=0.0))
    ts = NeRFSystem(SmallMC(**kw), device="cpu",
                    train_dataset=SyntheticDataset(
                        split="train", img_size=24, n_train=2,
                        world_scale=ws, bg=0.0, device="cpu"),
                    test_dataset=SyntheticDataset(
                        split="test", img_size=24, n_test=1, world_scale=ws,
                        bg=0.0, device="cpu"))
    return js, ts


def test_system_march_choice_and_buckets_match_jax():
    """At scale 4 on the scaled scene: the window rule (two-window chain for
    train and test cameras), the pool buckets with (96, 128, 160), the
    exp-step chain and its buckets and the rounds chain are JAX's; without
    windows the step still trains (the grid lookup)."""
    js, ts = _mc_systems()
    assert ts.cfg.cascades == js.cfg.cascades == 4
    assert ts.window_march == js.window_march is True
    assert ts.test_window
    assert ts._pool_buckets == js._pool_buckets
    assert ts._pool_buckets[-3:] == (96, 128, 160)
    assert ts.chain_full == js.chain_full
    assert ts._chain_buckets == js._chain_buckets
    assert ts._rounds_chain == js._rounds_chain
    assert (ts.layout, ts._pool_mult, ts.chain_length) == (
        js.layout, js._pool_mult, js.chain_length)
    ts.on_train_start()
    ts.window_march = False
    m = ts.step_block()
    assert math.isfinite(float(m["loss"])) and int(m["n_skipped"]) == 0


def test_two_blocks_at_scale_4_on_cpu():
    """The port alone at scale 4 on the scaled scene: two 16-step blocks in
    `auto` with the two-window march, a black background; finite loss whose
    mean falls, every cascade marked, no skipped step."""
    _, ts = _mc_systems()
    hist = ts.fit(max_steps=32, log_every=16, quiet=True)
    assert [h["step"] for h in hist] == [16, 32]
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["skipped_total"] == 0
    assert ts.grid_state.occ_grid.shape[0] == 4
    occupied = ts.grid_state.occ_grid.reshape(4, -1).float().mean(1)
    assert (occupied > 0).all()


# -- the round renderer and one train step ----------------------------------

def _mc_models(scale=2.0, F=4):
    kw = dict(scale=scale, n_levels=4, n_features_per_level=F,
              log2_hashmap_size=12, grid_size=G)
    jngp = JaxNGP(JaxNGPConfig(**kw), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e4
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(8.0)
    tngp = NGP(NGPConfig(**kw), device="cpu")
    tngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    return jngp, params, tngp


def _mc_render_grid():
    occ = np.zeros((3, G, G, G), np.uint8)
    occ[0, 8:24, 8:24, 8:24] = 1
    occ[1, 12:20, 12:20, 12:20] = 1
    occ[2, 10:22, 10:22, 14:18] = 1
    return occ


@pytest.mark.parametrize("use_window", [True, False])
def test_round_renderer_at_cascades_3_matches_jax(use_window):
    """The whole round renderer at scale 2 (3 cascades, exponential steps,
    no span pass, at least 4 samples per round, black background), with
    and without the two-window chain, against `make_device_round_renderer`
    (as tests/test_round_renderer.py holds JAX): rgb and opacity within
    5e-3, depth within 1e-2, total samples within 1%, rounds equal."""
    jngp, params, tngp = _mc_models()
    occ = _mc_render_grid()
    N = 256
    rng = np.random.default_rng(1)
    d = rng.normal(size=(N, 3)) * np.array([0.3, 0.3, 0.1]) + [0, 0, 1.0]
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.tile(np.array([[0.1, -0.05, -5.0]], np.float32), (N, 1))
    rd[:8] = -rd[:8]
    out_j = jrender.make_device_round_renderer(
        jngp, JaxRenderConfig(), chunk=N, use_window=use_window)(
        params, jnp.asarray(occ), ro, rd)
    renderer = RoundRenderer(tngp, RenderConfig(), chunk=N,
                             use_window=use_window)
    assert renderer.buckets == bucket_ladder(N, 4)
    out_t = renderer.render_image(_t(occ), _t(ro), _t(rd))
    assert out_t["opacity"].max() > 0.99
    assert float(out_t["rgb"][:8].abs().max()) == 0.0     # black, missed
    np.testing.assert_allclose(out_t["rgb"].numpy(), out_j["rgb"], atol=5e-3)
    np.testing.assert_allclose(out_t["opacity"].numpy(), out_j["opacity"],
                               atol=5e-3)
    np.testing.assert_allclose(out_t["depth"].numpy(), out_j["depth"],
                               atol=1e-2)
    assert out_t["total_samples"] == pytest.approx(out_j["total_samples"],
                                                   rel=1e-2)
    assert out_t["rounds"] == out_j["rounds"]


@pytest.mark.parametrize("bg", ["black", "random"])
def test_one_scale2_train_step_matches_jax(monkeypatch, bg):
    """One CSR step at scale 2 (3 cascades, the two-window march) from
    identical params, Adam state (count 5), rays, noise and background
    (black, or an explicit uniform draw): the pool is JAX's (positions
    and deltas within TS_RTOL); loss within
    1e-5; every gradient within 2e-3 of its max; updated params within
    1e-3 * lr and moments within 1e-3 of their max, as the one-step test
    of tests/test_torch_train.py holds the single-cascade step."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    jngp, params, _ = _mc_models()
    params = jax.tree_util.tree_map(np.array, params)
    jngp.fused_tail = True
    occ = _grid("shell", 3)
    rng = np.random.default_rng(9)
    ro, rd = _rays(SCALES[3], seed=3)
    target = rng.random((N_RAYS, 3)).astype(np.float32)
    noise = _noise()
    bg_rgb = (np.zeros(3, np.float32) if bg == "black"
              else rng.random(3).astype(np.float32))
    win_j = jrm.occupancy_windows(jnp.asarray(occ))

    def loss_fn(p):
        res = jrender.render_rays_train_csr(
            jngp, p, jnp.asarray(occ), jnp.asarray(ro), jnp.asarray(rd),
            jnp.asarray(noise), jnp.asarray(bg_rgb), rcfg=JaxRenderConfig(),
            pool_mult=8, chain_length=1024, win_rows=win_j)
        return jlosses.total_loss(jlosses.nerf_loss(
            res, jnp.asarray(target), lambda_opacity=1e-3)), res

    with pltpu.force_tpu_interpret_mode():
        (loss_j, res_j), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params))
    loss_j = float(loss_j)

    def leaves(tree):
        return [np.asarray(tree["hash_table"])] + [
            np.asarray(w) for k in ("sigma_mlp", "rgb_mlp") for w in tree[k]]

    def nest(ls):
        return {"hash_table": ls[0], "sigma_mlp": ls[1:3],
                "rgb_mlp": ls[3:6]}

    g_leaves = leaves(grads_j)
    mu = nest([(0.5 * g * rng.uniform(0.5, 1.5, g.shape)).astype(np.float32)
               for g in g_leaves])
    nu = nest([(g * g * rng.uniform(1.0, 2.0, g.shape) + 1e-8).astype(
        np.float32) for g in g_leaves])
    tcfg_kw = dict(lr=1e-2, num_epochs=2, iters_per_epoch=4)
    opt_j = jts.make_optimizer(JaxTrainConfig(**tcfg_kw))
    st = opt_j.init(params)
    st = (st[0]._replace(count=jnp.asarray(5, jnp.int32), mu=mu, nu=nu),
          st[1]._replace(count=jnp.asarray(5, jnp.int32)))
    upd, st_new = opt_j.update(grads_j, st, params)
    params_new_j = optax.apply_updates(params, upd)

    _, _, ngp = _mc_models()
    ngp.load_params(params)
    opt = tts.Adam([w for _, _, w in ngp._slots()],
                   tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0), eps=1e-15)
    load_train_state(ngp, opt, params, mu, nu, 5)
    tcfg = TrainConfig(**tcfg_kw, scale=2.0)
    res_t, loss_of = tts.train_render(
        ngp, trm.occupancy_windows(_t(occ)), _t(ro), _t(rd), _t(noise),
        _t(bg_rgb), tcfg=tcfg, rcfg=RenderConfig(), n_samples=8,
        chain_length=1024, layout="csr", occ_grid=_t(occ))
    for f in ("ray_idx", "offsets", "rm_counts"):
        np.testing.assert_array_equal(res_t[f].numpy(),
                                      np.asarray(res_j[f]), err_msg=f)
    for f in ("ts", "deltas"):
        _close(res_t[f].numpy(), res_j[f], f)
    assert 0 < int(res_j["rm_samples"]) < 8 * N_RAYS
    loss_t = loss_of(_t(target))
    assert float(loss_t.detach()) == pytest.approx(loss_j, rel=1e-5)
    grads_t = torch.autograd.grad(loss_t, opt.params)
    for i, (a, b) in enumerate(zip(grads_t, g_leaves)):
        assert np.abs(b).max() > 0, i
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 2e-3, (i, err)
    with torch.no_grad():
        opt.step([g.detach() for g in grads_t])
    lr = float(tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0)(5))
    p_t = [w.detach().numpy() for _, _, w in ngp._slots()]
    for a, b in zip(p_t, leaves(params_new_j)):
        assert np.abs(a - b).max() <= 1e-3 * lr
    for a, b in zip([m.numpy() for m in opt.mu + opt.nu],
                    leaves(st_new[0].mu) + leaves(st_new[0].nu)):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
