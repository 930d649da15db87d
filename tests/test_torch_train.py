"""Port parity for the training slice against the JAX package on the CPU:
the packed occupancy windows, the windowed train march and its CSR pool,
the occupancy refresh of training (sublattice phases, erosion), the CSR
compositor and the losses, one whole train step (loss, gradients, Adam
update, from a carried-over train state), the non-finite skip, the demand
controller, the lr schedule and batch sampling; and a two-block run of the
port alone.  One train step is also held against JAX's in the strided and
rounds layouts (tests/test_torch_layouts.py holds their parts).

Sizes: grid 32, L=4, log2 T=12, 256 rays, pool x8.  Inputs are made with
numpy from a seed and fed to both packages."""
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
from ngp_pl_tpu.datasets.ray_utils import get_rays as jax_get_rays
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models import occupancy as jocc
from ngp_pl_tpu.models import rendering as jrender
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.rendering import render_rays_train_csr as jax_render
from ngp_pl_tpu.models.rendering import scene_hits as jax_scene_hits
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.ops.volume_render import composite_train as jax_composite
from ngp_pl_tpu.training import losses as jlosses
from ngp_pl_tpu.training import train_step as jts
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import NGPConfig, RenderConfig, TrainConfig
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models import occupancy as tocc
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.ops.volume_render import composite_train
from ngp_pl_torch.training import losses as tlosses
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import (
    load_train_state,
    train_state_numpy,
)
from ngp_pl_torch.training.system import NeRFSystem

torch.set_num_threads(2)

G = 32
MODEL_KW = dict(scale=0.5, n_levels=4, log2_hashmap_size=12, grid_size=G)
MARCH_KW = dict(scale=0.5, grid_size=G, max_samples=1024)
CHAIN = 1152          # > max_samples: the per-ray cap branch of the pool
N_RAYS = 256


def _shell_grid(seed=0, noise=0.02):
    """A hollow sphere plus scattered cells, like a pruned real scene."""
    rng = np.random.default_rng(seed)
    c = (np.arange(G) + 0.5) / G * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    occ = (np.abs(r - 0.45) < 0.12) | (rng.random((G, G, G)) < noise)
    return occ.astype(np.uint8)[None]


def _rays(N=N_RAYS, seed=0):
    rng = np.random.default_rng(seed)
    cam = np.array([0.2, -1.4, 0.5], np.float32)
    fwd = -cam / np.linalg.norm(cam)
    rd = (rng.normal(size=(N, 3)) * 0.25 + fwd).astype(np.float32)
    rd[:4] = -rd[:4]                 # rays that miss the box
    return np.tile(cam, (N, 1)).astype(np.float32), rd


def _hits(ro, rd):
    return np.array(jax.jit(lambda o, d: jax_scene_hits(o, d, 0.5))(ro, rd))


def _staged_samples(occ, ro, rd, noise, pool_size, chain=CHAIN):
    """How many pool samples the TPU's group staging holds: it keeps the
    first 2 * (pool_size // GRP) non-empty groups of GRP candidates (GRP =
    32, halved while it does not divide the chain;
    ngp_pl_tpu/ops/ray_march.py:790-801).  Counted before the per-ray cap,
    which these rays do not reach."""
    h = _hits(ro, rd)
    t0 = trm._fma(torch.from_numpy(noise), trm._f32(math.sqrt(3) / 1024),
                  torch.from_numpy(h[:, 0]))
    K = -(-chain // 8) * 8
    bits, ts = trm._occ_window_chain(
        torch.from_numpy(ro), torch.from_numpy(rd), t0, K // 8,
        trm.occupancy_windows(torch.from_numpy(occ)), scale=0.5,
        grid_size=G, dt_min=math.sqrt(3) / 1024)
    ts = ts.reshape(len(ro), K)
    ok = bits.reshape(len(ro), K) & (ts >= 0) & (
        ts < torch.from_numpy(h[:, 1])[:, None]) & (
        torch.from_numpy(h[:, 0])[:, None] >= 0)
    grp = 32
    while K % grp:
        grp //= 2
    groups = ok.reshape(-1, grp).sum(1)
    groups = groups[groups > 0]
    return int(groups[:max(2 * (pool_size // grp), 1)].sum())


@pytest.mark.parametrize("grid", ["shell", "random", "full", "empty"])
def test_occupancy_windows_bit_identical(grid):
    occ = {"shell": _shell_grid(),
           "random": (np.random.default_rng(1).random((1, G, G, G)) < 0.3
                      ).astype(np.uint8),
           "full": np.ones((1, G, G, G), np.uint8),
           "empty": np.zeros((1, G, G, G), np.uint8)}[grid]
    j = np.asarray(jrm.occupancy_windows(jnp.asarray(occ)))
    t = trm.occupancy_windows(torch.from_numpy(occ))
    assert t.dtype == torch.int32 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)


@pytest.mark.parametrize("grid,mult", [("shell", 64), ("shell", 8),
                                       ("full", 8)])
def test_train_pool_identical(grid, mult):
    """The same pool as `march_rays_train_window`, bit for bit: ts, deltas,
    ray_idx (N in unused slots), valid, counts, offsets, total, rm_counts and
    the chain demands.  The x8 pools saturate: whole tail rays drop out (on
    the full grid, as in grid warmup, every in-box step is occupied)."""
    occ = _shell_grid() if grid == "shell" else np.ones((1, G, G, G),
                                                        np.uint8)
    ro, rd = _rays()
    noise = np.random.default_rng(5).random(N_RAYS).astype(np.float32)
    h = _hits(ro, rd)
    P = N_RAYS * mult
    # below the TPU's staging budget the two compactions agree
    assert _staged_samples(occ, ro, rd, noise, P) >= P or mult == 64
    kw = dict(MARCH_KW, pool_size=P, chain_length=CHAIN)
    j = jrm.march_rays_train_window(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(h), jnp.asarray(noise),
        jrm.occupancy_windows(jnp.asarray(occ)), **kw)
    t = trm.march_rays_train_window(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(h),
        torch.from_numpy(noise), trm.occupancy_windows(torch.from_numpy(occ)),
        **kw)
    total = int(j.total)
    assert total > 1000
    if mult == 8:
        assert total == P                          # saturated
        assert int(np.asarray(j.counts).sum()) == P
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def _sparse_pools(chain, P=N_RAYS * 8):
    """The JAX and port pools of a batch on a sparse grid (4% of cells),
    where the TPU's staging holds fewer samples than the pool has slots;
    also that staged count."""
    occ = (np.random.default_rng(7).random((1, G, G, G)) < 0.04).astype(
        np.uint8)
    ro, rd = _rays()
    noise = np.random.default_rng(5).random(N_RAYS).astype(np.float32)
    staged = _staged_samples(occ, ro, rd, noise, P, chain)
    h = _hits(ro, rd)
    kw = dict(MARCH_KW, pool_size=P, chain_length=chain)
    j = jrm.march_rays_train_window(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(h), jnp.asarray(noise),
        jrm.occupancy_windows(jnp.asarray(occ)), **kw)
    t = trm.march_rays_train_window(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(h),
        torch.from_numpy(noise), trm.occupancy_windows(torch.from_numpy(occ)),
        **kw)
    return j, t, staged


# chain lengths whose candidate groups have 32 and 16 lanes (at 16, as at
# 8, the group's kb[2:4] are the reference's zero padding)
@pytest.mark.parametrize("chain", [CHAIN, 1136])
def test_pool_matches_jax_past_the_tpu_staging_budget(chain):
    """Past the samples its staged groups hold, the JAX package's pool
    slots repeat the last staged group's position (a defect of the
    reference); the port reproduces it, so the whole pool is bit-identical:
    ts, ray_idx, valid, counts, offsets and total (and every other field)."""
    j, t, staged = _sparse_pools(chain)
    assert staged < int(j.total)
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_pool_bookkeeping_and_repeated_slot_past_the_tpu_staging_budget():
    """Past the staging budget the pool's bookkeeping still keeps every
    sample: rm_counts and offsets count each occupied candidate, and the
    saturated pool's counts fill it with the head of the batch, as without
    the budget.  Its slots do not: every valid slot past the staged count
    holds one (ray, t), the last staged group's last candidate at GRP 32
    (the reference defect), while the slots before it are distinct and
    ordered by (ray, t)."""
    _, t, staged = _sparse_pools(CHAIN)
    total = int(t.total)
    rm = t.rm_counts.numpy()
    assert total == N_RAYS * 8 == int(t.counts.sum()) < int(rm.sum())
    np.testing.assert_array_equal(t.offsets.numpy(), np.cumsum(rm) - rm)
    np.testing.assert_array_equal(
        t.counts.numpy(), np.clip(total - (np.cumsum(rm) - rm), 0, rm))
    ray, ts = t.ray_idx.numpy()[:total], t.ts.numpy()[:total]
    assert staged < total
    assert len(set(zip(ray[staged:], ts[staged:]))) == 1
    head = np.stack([ray[:staged], ts[:staged]])
    assert len(set(map(tuple, head.T))) == staged
    same = np.diff(ray[:staged]) == 0
    assert (np.diff(ray[:staged]) >= 0).all()
    assert (np.diff(ts[:staged])[same] > 0).all()


@pytest.mark.parametrize("chain", [256, 1136])
def test_pool_compaction_reads_nothing_on_the_host(chain):
    """The train step is host-bound, so the compaction, staging budget
    included, queues its work without reading a value back: no
    `aten._local_scalar_dense` (what `.item()` and a 0-dim tensor index
    call), at GRP 32 and at GRP 16 past the per-ray cap."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    occ = torch.rand((64, chain), generator=g) < 0.05
    t0 = torch.rand(64, generator=g)
    with Ops() as ops:
        trm._compact_to_pool(occ, t0, 1024, 512, 0.01)
    assert ops.names and not [n for n in ops.names if "local_scalar" in n]


def test_jax_nth_set_bit_is_31_past_the_popcount():
    """The JAX package's `_nth_set_bit` over random words and j in [0, 40):
    the (j+1)-th set bit below the popcount, and 31 wherever j >= popcount,
    the case the port's compaction writes as the constant step kb[3] + 7
    (31 >> 3 = 3, 31 & 7 = 7)."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2 ** 32, 4096, dtype=np.int64)
    words[:64] = 0
    words[64:128] = 2 ** 32 - 1
    words[128:512] &= rng.integers(0, 2 ** 32, 384, dtype=np.int64)
    j = rng.integers(0, 40, 4096).astype(np.int32)
    got = np.asarray(jrm._nth_set_bit(jnp.asarray(words.astype(np.uint32)),
                                      jnp.asarray(j)))
    pop = np.array([bin(int(w)).count("1") for w in words])
    past = j >= pop
    assert past.sum() > 500 and (got[past] == 31).all()
    for w, jj, pos in zip(words[~past], j[~past], got[~past]):
        bits = [b for b in range(32) if (int(w) >> b) & 1]
        assert pos == bits[jj]


def _jax_model(scale_table=1e3, seed=0, F=4):
    jngp = JaxNGP(JaxNGPConfig(**MODEL_KW, n_features_per_level=F),
                  need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(seed))
    params["hash_table"] = params["hash_table"] * scale_table
    return jngp, jax.tree_util.tree_map(np.array, params)


def _port_model(params):
    F = params["hash_table"].shape[1] // 32
    ngp = NGP(NGPConfig(**MODEL_KW, n_features_per_level=F), device="cpu")
    ngp.load_params(params)
    return ngp


def _jax_noise(key, C, M):
    out = []
    for _ in range(C):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, (M, 3), minval=-1.0,
                                               maxval=1.0)))
    return np.stack(out)


def _port_state(js):
    return tocc.OccupancyGridState(
        density_grid=torch.from_numpy(np.array(js.density_grid)),
        count_grid=torch.from_numpy(np.array(js.count_grid)),
        occ_grid=torch.from_numpy(np.array(js.occ_grid)),
        mean_density=torch.tensor(float(js.mean_density)))


def _assert_refresh_close(js, ts, thr):
    """Densities within 1% (JAX's CPU density reads the f32 table through
    XLA, the port the f16 copy through K1's rounding points); occupancy
    equal except within that 1% of the threshold; the windows are those of
    the port's grid."""
    d_j, d_t = np.asarray(js.density_grid), ts.density_grid.numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-2, atol=1e-6)
    occ_j, occ_t = np.asarray(js.occ_grid), ts.occ_grid.numpy()
    t_j = min(float(js.mean_density), thr)
    near = np.abs(d_j - t_j).reshape(occ_j.shape) <= 1e-2 * t_j
    assert ((occ_j != occ_t) & ~near).sum() == 0
    np.testing.assert_array_equal(
        ts.win_rows.numpy(),
        trm.occupancy_windows(ts.occ_grid).numpy())


@pytest.mark.parametrize("erode", [False, True])
def test_training_refresh_phases_match(erode):
    """Warmup refresh, then the sublattice refresh at phases 0-3 (each cell
    refreshed once, all decayed every time), with and without erosion;
    JAX's jitter is handed in.  Each refresh starts both packages from the
    JAX state."""
    jngp, params = _jax_model()
    tngp = _port_model(params)
    jc = JaxNGPConfig(**MODEL_KW, n_features_per_level=4)
    thr = 0.01 * 1024 / np.sqrt(3.0)
    ds = JaxSynthetic(split="train", downsample=0.125, read_meta=False)
    js = jocc.mark_invisible_cells(
        jocc.init_grid_state(jc), jnp.asarray(ds.K), jnp.asarray(ds.poses[:3]),
        cfg=jc, img_w=ds.img_wh[0], img_h=ds.img_wh[1])
    update = jocc.make_update_density_grid(jngp, jc)
    for step, (warm, phase) in enumerate([(True, 0), (False, 0), (False, 1),
                                          (False, 2), (False, 3)]):
        key = jax.random.PRNGKey(11 + step)
        ts = tocc.update_density_grid(
            tngp, _port_state(js), thr, warmup=warm, phase=phase,
            erode=erode, noise=torch.from_numpy(
                _jax_noise(key, 1, G ** 3 if warm else G ** 3 // 4)))
        js = update(params, js, key, jnp.asarray(thr, jnp.float32),
                    warmup=warm, erode=erode, phase=phase)
        _assert_refresh_close(js, ts, thr)
    occ = np.asarray(js.occ_grid)
    assert 0.02 < occ.mean() < 0.98


def _composite_inputs(sigma_scale, seed=3):
    rng = np.random.default_rng(seed)
    N, P = 64, 2048
    counts = rng.integers(0, 40, N)
    counts[:3] = 0
    while counts.sum() > P - 100:
        counts = counts // 2 + 1
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(counts.sum())
    ray = np.full(P, N, np.int32)
    ray[:total] = np.repeat(np.arange(N), counts)
    valid = np.arange(P) < total
    sig = (rng.random(P) * 400 * sigma_scale).astype(np.float32)
    rgbs = rng.random((P, 3)).astype(np.float32)
    deltas = np.full(P, math.sqrt(3) / 1024, np.float32)
    ts = (rng.random(P) + 0.5).astype(np.float32)
    return sig, rgbs, deltas, ts, ray, valid, offsets, N


@pytest.mark.parametrize("sigma_scale", [1.0, 1e10])
def test_composite_train_and_losses_match(sigma_scale):
    """Outputs within 1e-4, gradients of the loss with respect to sigma and
    rgb within 1e-4 of max: the compositor differences one global f32
    prefix sum over the pool, which reaches ~1e3 here (one ulp 6e-5), and
    the two frameworks associate it differently.  sigma * delta ~ 1e10 (the
    late-training density runaway that SD_CLAMP bounds) stays finite."""
    sig, rgbs, deltas, ts, ray, valid, offsets, N = _composite_inputs(
        sigma_scale)
    target = np.random.default_rng(4).random((N, 3)).astype(np.float32)

    def jloss(s, c):
        out = jax_composite(s, c, jnp.asarray(deltas), jnp.asarray(ts),
                            jnp.asarray(ray), jnp.asarray(valid),
                            jnp.asarray(offsets), n_rays=N)
        out["rgb"] = out["rgb"] + (1.0 - out["opacity"][:, None])
        return jlosses.total_loss(jlosses.nerf_loss(out, target)), out

    (l_j, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(sig), jnp.asarray(rgbs))
    s_t = torch.from_numpy(sig).requires_grad_()
    c_t = torch.from_numpy(rgbs).requires_grad_()
    o_t = composite_train(s_t, c_t, *map(torch.from_numpy, (
        deltas, ts, ray.astype(np.int64), valid, offsets)), n_rays=N)
    o_t["rgb"] = o_t["rgb"] + (1.0 - o_t["opacity"][:, None])
    l_t = tlosses.total_loss(tlosses.nerf_loss(o_t, torch.from_numpy(target)))
    g_t = torch.autograd.grad(l_t, (s_t, c_t))
    for k in ("opacity", "depth", "rgb", "ws"):
        v = o_t[k].detach().numpy()
        assert np.isfinite(v).all(), k
        np.testing.assert_allclose(v, np.asarray(o_j[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(o_t["vr_samples"].numpy(),
                                  np.asarray(o_j["vr_samples"]))
    assert float(l_t.detach()) == pytest.approx(float(l_j), rel=1e-5)
    for a, b in zip(g_t, g_j):
        assert np.isfinite(a.numpy()).all()
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(np.abs(b).max(),
                                                         1e-12)


def test_cosine_schedule_matches():
    j = jts.cosine_epoch_schedule(1e-2, 3, 5, 30.0)
    t = tts.cosine_epoch_schedule(1e-2, 3, 5, 30.0)
    for step in (0, 4, 5, 9, 10, 14, 15, 40):
        assert t(step) == pytest.approx(float(j(jnp.asarray(step))),
                                        rel=1e-6)


def test_batch_rays_match_jax():
    """Batched get_rays against JAX's (einsum over one pose per ray, 1e-6);
    sample_batch draws in range, on the store's device, one image per batch
    under same_image."""
    ds = SyntheticDataset(split="train", downsample=0.125, device="cpu")
    rng = np.random.default_rng(0)
    img = rng.integers(0, len(ds.poses), 64)
    pix = rng.integers(0, ds.directions.shape[0], 64)
    ro_j, rd_j = jax_get_rays(jnp.asarray(ds.directions[pix]),
                              jnp.asarray(ds.poses[img]))
    ro_t, rd_t = get_rays(torch.from_numpy(ds.directions[pix]),
                          torch.from_numpy(ds.poses[img]))
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)
    store = ds.rays
    assert store.shape == (24, ds.directions.shape[0], 3)
    gen = torch.Generator().manual_seed(0)
    for strategy in ("all_images", "same_image"):
        i, p, rgb = tts.sample_batch(store, 128, strategy, gen)
        assert rgb.shape == (128, 3)
        assert 0 <= int(i.min()) and int(i.max()) < 24
        torch.testing.assert_close(rgb, store[i, p])
        if strategy == "same_image":
            assert int(i.unique().numel()) == 1


def _step_inputs(F=4):
    jngp, params = _jax_model(scale_table=1e3, seed=2, F=F)
    params["sigma_mlp"][1][:, 0] *= 4.0          # rays terminate
    occ = _shell_grid()
    ro, rd = _rays()
    rng = np.random.default_rng(9)
    target = rng.random((N_RAYS, 3)).astype(np.float32)
    noise = rng.random(N_RAYS).astype(np.float32)
    return jngp, params, occ, ro, rd, target, noise


# (JAX render, its sample budget keyword, budget, chain) of each layout in
# the one-step tests: the budget is the pool's multiple or S, the chain a
# multiple of 32 (strided) and of 8 (rounds), N * S a multiple of 2048
LAYOUT_STEP = {"csr": (jax_render, "pool_mult", 8, CHAIN),
               "strided": (jrender.render_rays_train, "n_samples", 8, CHAIN),
               "rounds": (jrender.render_rays_train_rounds, "n_samples", 8,
                          256)}


def _jax_loss_and_grads(monkeypatch, jngp, params, occ, ro, rd, target,
                        noise, layout="csr", lam=0.0, budget=None,
                        chain=None):
    """JAX's train loss in `layout` (the rounds render takes the distortion
    weight `lam` too) through its TPU field path (Pallas K1/K7 run
    interpreted), as `loss_fn` runs it on the chip."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    jngp.fused_tail = True
    win = jrm.occupancy_windows(jnp.asarray(occ))
    render, key, b, c = LAYOUT_STEP[layout]
    kw = {key: budget or b, "chain_length": chain or c}
    if layout == "rounds":
        kw["lambda_distortion"] = lam

    def loss_fn(p):
        res = render(jngp, p, jnp.asarray(occ), jnp.asarray(ro),
                     jnp.asarray(rd), jnp.asarray(noise),
                     jnp.ones((3,), jnp.float32), rcfg=JaxRenderConfig(),
                     win_rows=win, **kw)
        loss = jlosses.total_loss(jlosses.nerf_loss(
            res, jnp.asarray(target), lambda_opacity=1e-3,
            lambda_distortion=lam))
        return loss, res

    with pltpu.force_tpu_interpret_mode():
        (loss, res), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), res, grads


def _leaves(tree):
    return [np.asarray(tree["hash_table"])] + [
        np.asarray(w) for name in ("sigma_mlp", "rgb_mlp") for w in tree[name]]


TCFG = dict(lr=1e-2, num_epochs=2, iters_per_epoch=4)


# distortion weight of each layout's step: the rounds render carries it
# through its rounds
STEP_LAM = {"csr": 0.0, "strided": 0.0, "rounds": 1e-2}


@pytest.mark.parametrize("F,layout", [
    pytest.param(4, "csr", id="4"), pytest.param(2, "csr", id="2"),
    pytest.param(4, "strided", id="strided-4"),
    pytest.param(4, "rounds", id="rounds-4")])
def test_one_train_step_matches_jax(monkeypatch, F, layout):
    """From identical params, Adam state (count 5, so epoch 1 of the
    cosine), rays, noise and background, with the F=4 (K1, K2+K5) and the
    F=2 (K3, K4) encode, in the CSR layout and at F=4 in the strided and
    rounds layouts (rounds with the distortion loss): the pool is
    identical (CSR; the strided block's ts and valid, and in both other
    layouts the per-ray counts, the loss mask and, under rounds, the rays
    alive after the last round); loss within 1e-5; every
    gradient within 2e-3 of its max (bf16 rounding flips where an f32 sum
    differs in its last bit; the hash table's gradient is a sum of bf16
    products into few rows); the updated params within 1e-3 * lr and the
    moments within 1e-3 of their max."""
    jngp, params, occ, ro, rd, target, noise = _step_inputs(F)
    lam = STEP_LAM[layout]
    loss_j, res_j, grads_j = _jax_loss_and_grads(
        monkeypatch, jngp, params, occ, ro, rd, target, noise, layout, lam)

    rng = np.random.default_rng(1)
    g_leaves = _leaves(grads_j)
    mu = [0.5 * g * rng.uniform(0.5, 1.5, g.shape) for g in g_leaves]
    nu = [g * g * rng.uniform(1.0, 2.0, g.shape) + 1e-8 for g in g_leaves]

    def nest(ls):
        return {"hash_table": ls[0], "sigma_mlp": ls[1:3], "rgb_mlp": ls[3:6]}

    mu_n = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), nest(mu))
    nu_n = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), nest(nu))

    opt_j = jts.make_optimizer(JaxTrainConfig(**TCFG))
    st = opt_j.init(params)
    st = (st[0]._replace(count=jnp.asarray(5, jnp.int32), mu=mu_n, nu=nu_n),
          st[1]._replace(count=jnp.asarray(5, jnp.int32)))
    upd, st_new = opt_j.update(grads_j, st, params)
    params_new_j = optax.apply_updates(params, upd)

    # the port: gradients from its render + loss
    tcfg = TrainConfig(**TCFG, distortion_loss_w=lam)
    rcfg = RenderConfig()
    ngp = _port_model(params)
    win = trm.occupancy_windows(torch.from_numpy(occ))
    args = (torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(noise), torch.ones(3))
    _, _, budget, chain = LAYOUT_STEP[layout]
    res_t, loss_of = tts.train_render(ngp, win, *args, tcfg=tcfg, rcfg=rcfg,
                                      n_samples=budget, chain_length=chain,
                                      layout=layout)
    same = {"csr": ("ts", "ray_idx", "offsets", "rm_counts"),
            "strided": ("ts", "valid", "rm_counts", "loss_mask"),
            "rounds": ("rm_counts", "vr_counts", "loss_mask",
                       "rounds_alive_end")}[layout]
    for f in same:
        np.testing.assert_array_equal(res_t[f].numpy(), np.asarray(res_j[f]),
                                      err_msg=f)
    if layout == "csr":
        assert int(res_t["rm_samples"]) == int(res_j["rm_samples"]) \
            == 8 * N_RAYS
    else:                    # some rays are left out of the loss, not all
        assert 0 < int(res_t["loss_mask"].sum()) < N_RAYS
    loss_t = loss_of(torch.from_numpy(target))
    assert float(loss_t.detach()) == pytest.approx(loss_j, rel=1e-5)
    params_t = [w for _, _, w in ngp._slots()]
    grads_t = torch.autograd.grad(loss_t, params_t)
    for i, (a, b) in enumerate(zip(grads_t, g_leaves)):
        assert np.abs(b).max() > 0, i
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 2e-3, (i, err)

    # the port's train_step from the carried-over state
    ngp = _port_model(params)
    opt = tts.Adam([w for _, _, w in ngp._slots()],
                   tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0), eps=1e-15)
    load_train_state(ngp, opt, params, mu_n, nu_n, 5)
    m = tts.train_step(ngp, opt, win, *args[:2], torch.from_numpy(target),
                       *args[2:], tcfg=tcfg, rcfg=rcfg, n_samples=budget,
                       chain_length=chain, layout=layout)
    assert bool(m["grads_finite"]) and int(m["n_skipped"]) == 0
    assert float(m["loss"]) == pytest.approx(loss_j, rel=1e-5)
    p_t, mu_t, nu_t, count = train_state_numpy(ngp, opt)
    assert count == 6 == int(st_new[0].count) == int(st_new[1].count)
    lr = float(tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0)(5))
    for a, b in zip(_leaves(p_t), _leaves(params_new_j)):
        assert np.abs(a - b).max() <= 1e-3 * lr
    for a, b in zip(_leaves(mu_t) + _leaves(nu_t),
                    _leaves(st_new[0].mu) + _leaves(st_new[0].nu)):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    # the table the encode reads follows the update: the f16 copy at F=4,
    # the f32 table itself at F=2
    want = np.asarray(p_t["hash_table"], {4: np.float16, 2: np.float32}[F])
    np.testing.assert_array_equal(ngp.encode_table().float().numpy(),
                                  want.astype(np.float32))


def test_nonfinite_step_is_skipped():
    """A NaN target on a ray that hits the scene makes the gradients
    non-finite: params and
    moments are kept, the count still advances, so the next step's lr and
    bias correction use count + 1 (train_step.py:204-230)."""
    _, params, occ, ro, rd, target, noise = _step_inputs()
    ngp = _port_model(params)
    opt = tts.Adam([w for _, _, w in ngp._slots()],
                   tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0), eps=1e-15)
    rng = np.random.default_rng(3)
    mu = [rng.normal(0, 1e-3, p.shape).astype(np.float32) for p in opt.params]
    for d, s in zip(opt.mu, mu):
        d.copy_(torch.from_numpy(s))
    opt.count = 3
    before = [p.detach().clone() for p in opt.params]
    version = ngp.hash_table._version
    bad = target.copy()
    bad[6, 0] = np.nan               # a ray with samples in the pool
    win = trm.occupancy_windows(torch.from_numpy(occ))
    m = tts.train_step(ngp, opt, win, torch.from_numpy(ro),
                       torch.from_numpy(rd), torch.from_numpy(bad),
                       torch.from_numpy(noise), torch.ones(3),
                       tcfg=TrainConfig(**TCFG), rcfg=RenderConfig(),
                       n_samples=8, chain_length=CHAIN)
    assert not bool(m["grads_finite"]) and int(m["n_skipped"]) == 1
    assert opt.count == 4
    for p, b in zip(opt.params, before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)
    for v, s in zip(opt.mu, mu):
        np.testing.assert_array_equal(v.numpy(), s)
    for v in opt.nu:
        assert (v == 0).all()
    assert ngp.hash_table._version > version     # updated in place


def _jax_csr_system():
    tcfg = JaxTrainConfig(dataset_name="synthetic", batch_size=1024,
                          num_epochs=2, exp_name="demand_test",
                          no_save_test=True, train_layout="csr")
    return JaxSystem(tcfg,
                     train_dataset=JaxSynthetic(split="train", img_size=24,
                                                n_train=2),
                     test_dataset=JaxSynthetic(split="test", img_size=24,
                                               n_test=1))


@dataclasses.dataclass(frozen=True)
class SmallTrainConfig(TrainConfig):
    """The CPU tests' model: grid 32, L=4, T=2^12."""

    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def _port_system(batch_size=1024, img_size=24, n_train=2, **kw):
    tcfg = SmallTrainConfig(batch_size=batch_size, num_epochs=2, **kw)
    return NeRFSystem(
        tcfg, device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                       n_train=n_train, device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                      n_test=1, device="cpu"))


def test_demand_controller_matches_jax():
    """The CSR branch of `_consume_demand`, one interval late, sticky-down,
    warmup hold, NaN/inf sanitised: the same pool multiplier and chain
    length as JAX's NeRFSystem after every demand vector."""
    js, ts = _jax_csr_system(), _port_system(train_layout="csr")
    assert ts.chain_full == js.chain_full
    assert ts._chain_buckets == js._chain_buckets
    rng = np.random.default_rng(0)
    vecs = []
    for i in range(60):
        rm_mean = rng.uniform(4, 70) if i % 15 < 10 else rng.uniform(4, 12)
        v = np.asarray([rm_mean * 1024, 900, rng.uniform(50, 1200), 300, 30,
                        25, 18, 0, rm_mean], np.float32)
        if i == 30:
            v[2], v[8] = np.nan, np.inf
        vecs.append(v)
    for i, v in enumerate(vecs):
        for s in (js, ts):
            s._host_step = 16 * (i + 1)     # crosses grid warmup at 256
            s._consume_demand({"demand_vec": v})
        assert (ts._pool_mult, ts.chain_length) == (js._pool_mult,
                                                    js.chain_length), i
        assert ts.layout == js.layout == "csr"
    assert len({s for s in ts._pool_buckets}) > 1


@pytest.mark.parametrize("layout", ["auto", "strided", "rounds"])
def test_system_accepts_the_other_layouts(layout):
    """Each layout is accepted and starts where JAX's NeRFSystem starts
    (system.py:203-207): "auto" in CSR, the others in their own, with the
    same budget and the same chain for the first step."""
    tcfg = dict(dataset_name="synthetic", batch_size=1024, num_epochs=2,
                train_layout=layout)
    js = JaxSystem(JaxTrainConfig(**tcfg, exp_name="demand_test",
                                  no_save_test=True),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1))
    ts = _port_system(train_layout=layout)
    assert ts.layout == js.layout == ("csr" if layout == "auto" else layout)
    assert ts._pool_mult == js._pool_mult
    assert ts._rounds_chain == js._rounds_chain
    assert ts.step_chain() == (js._rounds_chain if layout == "rounds"
                               else js.chain_length)


def test_system_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="train_layout"):
        NeRFSystem(TrainConfig(train_layout="dense"), device="cpu")


def test_system_refuses_random_bg():
    """The JAX trainer draws a random background only for exp-stepping
    scenes, which the port does not train yet."""
    with pytest.raises(NotImplementedError, match="later"):
        NeRFSystem(TrainConfig(random_bg=True), device="cpu")


@pytest.mark.parametrize("F", [4, 2])
def test_two_blocks_on_cpu(monkeypatch, F):
    """The port alone: two 16-step blocks at 256 rays, each after one grid
    refresh (warmup phase); finite loss whose mean falls from the first
    block to the second, no skipped step."""
    system = _port_system(batch_size=256, img_size=32, n_train=4,
                          log_every=16, n_features=F, train_layout="csr")
    assert system.ngp.hash_table.shape[1] == 32 * F
    refreshes, losses = [], []
    refresh, step = system._refresh_grid, system._train_step
    monkeypatch.setattr(system, "_refresh_grid",
                        lambda i: refreshes.append(i) or refresh(i))
    monkeypatch.setattr(system, "_train_step",
                        lambda: losses.append(step()) or losses[-1])
    hist = system.fit(max_steps=32)
    assert refreshes == [0, 16]
    assert [h["step"] for h in hist] == [16, 32]
    loss = np.array([float(m["loss"]) for m in losses])
    assert len(loss) == 32 and np.isfinite(loss).all()
    assert loss[16:].mean() < loss[:16].mean()
    assert hist[-1]["skipped_total"] == 0
    assert system.optimizer.count == 32
    assert system.grid_state.win_rows.dtype == torch.int32
