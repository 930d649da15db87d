"""Port parity for the strided and rounds train layouts, `auto` and the
distortion loss against the JAX package on the CPU: the strided pool and
the windowed test round (bit for bit), the strided compositor and both
forms of the distortion loss, the strided and rounds renders with their
losses and gradients (Pallas K1/K7 run interpreted on the JAX side), the
demand controller in every mode; and the port alone training two blocks in
each layout, and an `auto` system that moves to the strided layout and
trains there.  One whole train step in each layout is in
tests/test_torch_train.py.

Sizes: grid 32, L=4, log2 T=12, 256 rays (512 for the rounds render, so
that its later rounds have fewer slots than alive rays).  Inputs are made
with numpy from a seed and fed to both packages."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.ops import distortion as jdist
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.ops import volume_render as jvr
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import RenderConfig
from ngp_pl_torch.datasets.synthetic import SyntheticDataset, _lookat_pose
from ngp_pl_torch.models import rendering as trender
from ngp_pl_torch.ops import distortion as tdist
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.ops import volume_render as tvr
from ngp_pl_torch.training import losses as tlosses
from ngp_pl_torch.training.system import NeRFSystem
from tests.test_system_demand import dv
from tests.test_torch_train import (
    CHAIN,
    G,
    MARCH_KW,
    N_RAYS,
    SmallTrainConfig,
    _composite_inputs,
    _hits,
    _jax_loss_and_grads,
    _leaves,
    _port_model,
    _port_system,
    _rays,
    _shell_grid,
    _step_inputs,
)
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic

torch.set_num_threads(2)

DT_MIN = math.sqrt(3.0) / 1024
GRIDS = {
    "shell": _shell_grid,
    "random": lambda: (np.random.default_rng(1).random((1, G, G, G)) < 0.3
                       ).astype(np.uint8),
    "full": lambda: np.ones((1, G, G, G), np.uint8),
    "empty": lambda: np.zeros((1, G, G, G), np.uint8),
}


def _noise(n=N_RAYS, seed=5):
    return np.random.default_rng(seed).random(n).astype(np.float32)


@pytest.mark.parametrize("S", [8, 64])
@pytest.mark.parametrize("grid", ["shell", "random", "full", "empty"])
def test_strided_pool_identical(grid, S):
    """The same block as `march_rays_train_strided`'s window branch, bit for
    bit, with a chain above max_samples: ts (0 on invalid slots), deltas,
    valid, counts, rm_counts (not capped at S or max_samples), total and
    the chain demands."""
    occ = GRIDS[grid]()
    ro, rd = _rays()
    noise = _noise()
    h = _hits(ro, rd)
    kw = dict(MARCH_KW, n_samples=S, chain_length=CHAIN)
    j = jrm.march_rays_train_strided(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(h), jnp.asarray(noise),
        None, cascades=1, exp_step_factor=0.0,
        win_rows=jrm.occupancy_windows(jnp.asarray(occ)), **kw)
    t = trm.march_rays_train_strided(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(h),
        torch.from_numpy(noise), trm.occupancy_windows(torch.from_numpy(occ)),
        **kw)
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    rm = t.rm_counts.numpy()
    if grid == "empty":
        assert rm.max() == 0 and not t.valid.any()
    elif grid == "full":          # every in-box step, past max_samples
        assert (rm > 0).all() == (np.asarray(h)[:, 0] >= 0).all()
        assert rm.max() > 1024
    else:                         # some rays cut at S, some not
        assert (rm > S).any() and ((rm > 0) & (rm <= S)).any()


def _round_inputs(seed=3):
    """Cursors of a train round: the jittered entry, or some way into the
    box; rays that miss it start at their far bound, as in the rounds."""
    ro, rd = _rays()
    h = _hits(ro, rd)
    rng = np.random.default_rng(seed)
    t0 = (h[:, 0] + _noise() * np.float32(DT_MIN)).astype(np.float32)
    ahead = rng.random(N_RAYS) < 0.5
    t0 = np.where(ahead, t0 + rng.uniform(0, 0.4, N_RAYS), t0)
    t_start = np.where(h[:, 0] >= 0, t0, h[:, 1]).astype(np.float32)
    return ro, rd, t_start, h[:, 1].copy()


@pytest.mark.parametrize("S,chain", [(16, 256), (64, 512)])
@pytest.mark.parametrize("grid", ["shell", "random", "full"])
def test_windowed_test_round_identical(grid, S, chain):
    """`march_rays_test_round` with `win_rows`, as the train rounds call it:
    valid, n_eff, t_next and deltas bit-identical to JAX's windowed branch,
    ts on the valid slots (the invalid ones hold placeholders: the port's
    search gives K there, JAX's bit search another index)."""
    occ = GRIDS[grid]()
    ro, rd, t_start, t_end = _round_inputs()
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              max_samples=1024, n_samples=S, chain_length=chain)
    j = jrm.march_rays_test_round(
        *map(jnp.asarray, (ro, rd, t_start, t_end, occ)), **kw,
        win_rows=jrm.occupancy_windows(jnp.asarray(occ)))
    t = trm.march_rays_test_round(
        *map(torch.from_numpy, (ro, rd, t_start, t_end)), None, **kw,
        win_rows=trm.occupancy_windows(torch.from_numpy(occ)))
    j = [np.asarray(a) for a in j]
    ts, dts, valid, t_next, n_eff = (a.numpy() for a in t)
    np.testing.assert_array_equal(valid, j[2])
    np.testing.assert_array_equal(n_eff, j[4])
    np.testing.assert_array_equal(t_next, j[3])
    np.testing.assert_array_equal(dts, j[1])
    np.testing.assert_array_equal(ts[valid], j[0][valid])
    assert valid.any() and (n_eff < S).any()
    if grid != "shell":
        assert (n_eff == S).any()


def test_windowed_test_round_is_the_direct_lookup_off_the_cell_edges():
    """The windowed round agrees with the direct lookup of the renderer's
    round (`occ_grid`, positions o + t d in two roundings) wherever no
    position lies within 1e-5 of a cell edge: there the two roundings can
    pick different cells."""
    occ = _shell_grid()
    ro, rd, t_start, t_end = _round_inputs()
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              max_samples=1024, n_samples=16, chain_length=256)
    args = [torch.from_numpy(a) for a in (ro, rd, t_start, t_end)]
    win = trm.march_rays_test_round(
        *args, None, **kw,
        win_rows=trm.occupancy_windows(torch.from_numpy(occ)))
    direct = trm.march_rays_test_round(*args, torch.from_numpy(occ), **kw)
    k = torch.arange(257, dtype=torch.float64)
    xyz = (args[0].double()[:, None, :] + (args[2].double()[:, None]
           + k * DT_MIN)[..., None] * args[1].double()[:, None, :])
    u = (xyz / 0.5 + 1.0) * 0.5 * G
    edge = ((u - u.round()).abs() < 1e-5 * G).any(dim=2).any(dim=1)
    ok = ~edge
    assert ok.sum() > N_RAYS // 2
    for a, b in zip(win[2:], direct[2:]):
        np.testing.assert_array_equal(a[ok].numpy(), b[ok].numpy())
    # positions in one rounding and in two: within two f32 ulps
    np.testing.assert_allclose(win[0][ok][win[2][ok]].numpy(),
                               direct[0][ok][direct[2][ok]].numpy(),
                               rtol=2.5e-7, atol=0)


def _strided_inputs(sigma_scale, N=64, S=32, seed=3):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, S + 1, N)
    counts[:3] = 0
    counts[3:6] = S
    valid = np.arange(S)[None, :] < counts[:, None]
    sig = (rng.random((N, S)) * 400 * sigma_scale).astype(np.float32)
    rgbs = rng.random((N, S, 3)).astype(np.float32)
    deltas = np.full((N, S), DT_MIN, np.float32)
    ts = np.where(valid, np.sort(rng.random((N, S)) + 0.5, axis=1),
                  0.0).astype(np.float32)
    return sig, rgbs, deltas, ts, valid


def _close_of_max(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all(), what
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), what


# The distortion's DVGO form differences two products of prefix sums,
# 2 (wts_in ws_ex - ws_in wts_ex), which cancel: on the strided inputs each
# package's f32 value misses a float64 evaluation of the same form on the
# same weights by 3-4e-6 of the largest, so it is held to 1e-5 of its max
# (the compositor to 1e-6).  The CSR form takes its prefix sums by
# differencing global ones over the pool, as the CSR compositor does
# (tests/test_torch_train.py holds that to 1e-4 for this reason): they
# reach ~64 here, one ulp 7.6e-6 against per-ray values of ~0.2.
DIST_TOL = 1e-5
CSR_DIST_TOL = 1e-4


@pytest.mark.parametrize("sigma_scale", [1.0, 1e10])
def test_composite_strided_and_distortion_match(sigma_scale):
    """`composite_train_strided` and `distortion_loss_strided` on the same
    (N, S) block, and the CSR `distortion_loss` on a pool: the compositor's
    outputs and the gradients of a weighted sum of the outputs within 1e-6
    of their max, vr_samples identical, the distortion and its gradient
    within DIST_TOL; sigma * delta ~ 1e10 (SD_CLAMP's case) stays
    finite."""
    sig, rgbs, deltas, ts, valid = _strided_inputs(sigma_scale)
    N, S = sig.shape
    rng = np.random.default_rng(8)
    c = [rng.random(N).astype(np.float32) for _ in range(3)] + [
        rng.random((N, 3)).astype(np.float32)]

    def weigh(out, dist, xp):
        w = c if xp is jnp else [torch.from_numpy(a) for a in c]
        return (xp.sum(out["opacity"] * w[0]) + xp.sum(out["depth"] * w[1])
                + xp.sum(dist * w[2]) + xp.sum(out["rgb"] * w[3]))

    def jloss(s, r):
        out = jvr.composite_train_strided(
            s, jnp.moveaxis(r, -1, 0), jnp.asarray(deltas), jnp.asarray(ts),
            jnp.asarray(valid))
        dist = jdist.distortion_loss_strided(out["ws"], jnp.asarray(deltas),
                                             jnp.asarray(ts),
                                             jnp.asarray(valid))
        return weigh(out, dist, jnp), (out, dist)

    (_, (o_j, d_j)), g_j = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(sig),
                                             jnp.asarray(rgbs))
    s_t = torch.from_numpy(sig).requires_grad_()
    r_t = torch.from_numpy(rgbs).requires_grad_()
    o_t = tvr.composite_train_strided(
        s_t, r_t, *map(torch.from_numpy, (deltas, ts, valid)))
    d_t = tdist.distortion_loss_strided(
        o_t["ws"], *map(torch.from_numpy, (deltas, ts, valid)))
    g_t = torch.autograd.grad(weigh(o_t, d_t, torch), (s_t, r_t))
    for k in ("opacity", "depth", "rgb", "ws"):
        _close_of_max(o_t[k].detach(), o_j[k], 1e-6, k)
    np.testing.assert_array_equal(o_t["vr_samples"].numpy(),
                                  np.asarray(o_j["vr_samples"]))
    _close_of_max(d_t.detach(), d_j, DIST_TOL, "distortion")
    for a, b, k in zip(g_t, g_j, ("d sigma", "d rgb")):
        _close_of_max(a, b, 1e-6, k)

    # the CSR form on a pool of the same kind, with weights from the CSR
    # compositor; gradients with respect to those weights
    sig, _, deltas, ts, ray, valid, offsets, N = _composite_inputs(
        sigma_scale)
    ws = np.array(jvr.composite_train(
        jnp.asarray(sig), jnp.ones((sig.shape[0], 3)), jnp.asarray(deltas),
        jnp.asarray(ts), jnp.asarray(ray), jnp.asarray(valid),
        jnp.asarray(offsets), n_rays=N)["ws"])
    cj = rng.random(N).astype(np.float32)

    def jcsr(w):
        d = jdist.distortion_loss(w, jnp.asarray(deltas), jnp.asarray(ts),
                                  jnp.asarray(ray), jnp.asarray(valid),
                                  jnp.asarray(offsets), N)
        return jnp.sum(d * cj), d

    (_, d_j), g_j = jax.value_and_grad(jcsr, has_aux=True)(jnp.asarray(ws))
    w_t = torch.from_numpy(ws).requires_grad_()
    d_t = tdist.distortion_loss(
        w_t, *map(torch.from_numpy, (deltas, ts, ray.astype(np.int64), valid,
                                     offsets)), n_rays=N)
    (g_t,) = torch.autograd.grad((d_t * torch.from_numpy(cj)).sum(), w_t)
    _close_of_max(d_t.detach(), d_j, CSR_DIST_TOL, "CSR distortion")
    _close_of_max(g_t, g_j, CSR_DIST_TOL, "CSR d ws")
    assert float(np.asarray(d_j).max()) > 0


def _port_render(layout, ngp, occ, ro, rd, noise, **kw):
    render = {"strided": trender.render_rays_train,
              "rounds": trender.render_rays_train_rounds}[layout]
    return render(ngp, trm.occupancy_windows(torch.from_numpy(occ)),
                  *map(torch.from_numpy, (ro, rd, noise)), torch.ones(3),
                  rcfg=RenderConfig(), **kw)


def _render_parity(monkeypatch, layout, F, lam, n_rays, budget, chain):
    """The render of `layout` and its loss in both packages from the same
    params, grid, rays and noise: the loss within 1e-5, each parameter's
    gradient within 2e-3 of its max, the loss mask identical.  Returns
    both renders' outputs."""
    jngp, params, occ, _, _, target, _ = _step_inputs(F)
    ro, rd = _rays(n_rays)
    rng = np.random.default_rng(12)
    target = rng.random((n_rays, 3)).astype(np.float32)
    noise = rng.random(n_rays).astype(np.float32)
    loss_j, res_j, grads_j = _jax_loss_and_grads(
        monkeypatch, jngp, params, occ, ro, rd, target, noise, layout, lam,
        budget, chain)
    ngp = _port_model(params)
    kw = dict(n_samples=budget, chain_length=chain)
    if layout == "rounds":
        kw["lambda_distortion"] = lam
    res_t = _port_render(layout, ngp, occ, ro, rd, noise, **kw)
    loss_t = tlosses.total_loss(tlosses.nerf_loss(
        res_t, torch.from_numpy(target), lambda_opacity=1e-3,
        lambda_distortion=lam))
    assert float(loss_t.detach()) == pytest.approx(loss_j, rel=1e-5)
    grads_t = torch.autograd.grad(loss_t, [w for _, _, w in ngp._slots()])
    for i, (a, b) in enumerate(zip(grads_t, _leaves(grads_j))):
        assert np.abs(b).max() > 0, i
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= 2e-3, (i, err)
    mask = res_t["loss_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(res_j["loss_mask"]))
    assert 0 < mask.sum() < n_rays
    return res_t, res_j


@pytest.mark.parametrize("F,lam", [(4, 0.0), (2, 0.0), (4, 1e-2)])
def test_strided_render_and_loss_match_jax(monkeypatch, F, lam):
    """`render_rays_train` against JAX's at F=4 (K1, K2+K5) and F=2 (K3,
    K4), with and without the distortion loss, S = 16: besides the limits
    of `_render_parity`, the block's ts and valid and the per-ray counts
    identical, opacity, depth and rgb within 1e-5 of their max."""
    res_t, res_j = _render_parity(monkeypatch, "strided", F, lam, N_RAYS,
                                  16, CHAIN)
    for f in ("ts", "valid", "rm_counts", "vr_counts"):
        np.testing.assert_array_equal(res_t[f].numpy(), np.asarray(res_j[f]),
                                      err_msg=f)
    for f in ("opacity", "depth", "rgb"):
        _close_of_max(res_t[f].detach(), res_j[f], 1e-5, f)


@pytest.mark.parametrize("lam", [0.0, 1e-2])
def test_rounds_render_and_loss_match_jax(monkeypatch, lam):
    """`render_rays_train_rounds` against JAX's over 512 rays, S = 8 and a
    256-step chain per round: slots 512, 256, 256, 256, so alive rays are
    dropped past round 0.  Besides the limits of `_render_parity`: rgb,
    opacity, depth and the distortion within 1e-5 of their max, the
    per-ray counts, the rays alive after the last round and the slot total
    identical."""
    res_t, res_j = _render_parity(monkeypatch, "rounds", 4, lam, 512, 8, 256)
    for f in ("rm_counts", "vr_counts", "rounds_alive_end", "total_slots"):
        np.testing.assert_array_equal(res_t[f].numpy(), np.asarray(res_j[f]),
                                      err_msg=f)
    assert int(res_t["total_slots"]) == 512 + 3 * 256
    assert 0 < int(res_t["rounds_alive_end"]) < 512
    for f in ("rgb", "opacity", "depth", "distortion"):
        b = np.asarray(res_j[f])
        if f == "distortion" and lam == 0:
            assert not b.any() and not res_t[f].any()
            continue
        _close_of_max(res_t[f].detach(), b, 1e-5, f)


def _jax_system(layout):
    tcfg = JaxTrainConfig(dataset_name="synthetic", batch_size=1024,
                          num_epochs=2, exp_name="demand_test",
                          no_save_test=True, train_layout=layout)
    return JaxSystem(tcfg,
                     train_dataset=JaxSynthetic(split="train", img_size=24,
                                                n_train=2),
                     test_dataset=JaxSynthetic(split="test", img_size=24,
                                               n_test=1))


def _demand_story():
    """(host step, layout, budget, demand vector) of each call: the
    scenarios of tests/test_system_demand.py one after another, each from
    the state its test sets (None keeps the state): the warmup hold, sizing
    from the pre-clip mean, a heavy tail, tight demand and its flip, the
    flip back, sticky-down, the chain tracking q99, the rounds growth and
    decay; then a random walk with NaN and inf."""
    W = 10 * 256
    calls = [(1, "csr", 32, dv(rm_mean_pre=60.0))] * 2
    calls += [(W, "csr", 24, dv(rm_mean=24.0, rm_mean_pre=40.0, rm_q=300))]
    calls += [(W, None, None, dv(rm_mean=24.0, rm_mean_pre=40.0, rm_q=300))]
    calls += [(W, "csr", 32, dv(rm_mean_pre=15.0, rm_q=300))]
    calls += [(W, None, None, dv(rm_mean_pre=15.0, rm_q=300))] * 5
    calls += [(W, "csr", 32, dv(rm_mean_pre=20.0, rm_q=24))]
    calls += [(W, None, None, dv(rm_mean_pre=20.0, rm_q=24))] * 3
    calls += [(W, "strided", 32, dv(rm_mean_pre=18.0, rm_q=200))]
    calls += [(W, None, None, dv(rm_mean_pre=18.0, rm_q=200))] * 2
    calls += [(W, "csr", 56, dv(rm_mean_pre=20.0, rm_q=300))]
    calls += [(W, None, None, dv(rm_mean_pre=20.0, rm_q=300))] * 2
    calls += [(W, None, None, dv(rm_mean_pre=60.0, rm_q=300))] * 2
    calls += [(W, "csr", 32, dv(rm_mean_pre=20.0, rm_q=300, chain_q=100))]
    calls += [(W, None, None, dv(rm_mean_pre=20.0, rm_q=300,
                                 chain_q=100))] * 39
    calls += [(W, None, None, dv(rm_mean_pre=20.0, rm_q=300,
                                 chain_q=2000))] * 2
    calls += [(W, "rounds", 8, dv(vr_mean=6.0, alive_end=0.5 * 1024))]
    calls += [(W, None, None, dv(vr_mean=6.0, alive_end=0.5 * 1024))]
    calls += [(W, "rounds", 32, dv(vr_mean=6.0, alive_end=0))]
    calls += [(W, None, None, dv(vr_mean=6.0, alive_end=0))] * 9
    rng = np.random.default_rng(0)
    for i in range(60):
        v = dv(rm_mean_pre=rng.uniform(2, 70), rm_q=rng.uniform(4, 200),
               chain_q=rng.uniform(50, 1200), vr_mean=rng.uniform(2, 40),
               alive_end=rng.uniform(0, 300))
        if i == 30:
            v[2], v[3], v[8] = np.nan, np.inf, np.inf
        calls.append((W + 16 * i, None, None, v))
    return calls


def _reset(system, layout, mult):
    """The state tests/test_system_demand.py's `reset` sets."""
    system.layout = layout
    system._pool_mult = mult
    system._pool_demand = 0.0
    system._layout_vote = 0
    system._shrink_votes = 0
    system._pending_demand = None


@pytest.mark.parametrize("mode", ["auto", "strided", "rounds", "csr"])
def test_demand_controller_matches_jax_in_every_mode(mode):
    """`_consume_demand` in each train_layout mode against JAX's
    NeRFSystem, fed the demand vectors of tests/test_system_demand.py and a
    random walk: after every vector (layout, budget, chain) identical, and
    the budget's running demand and the layout vote too."""
    js, ts = _jax_system(mode), _port_system(train_layout=mode)
    assert ts.layout == js.layout
    assert ts._chain_buckets == js._chain_buckets
    seen = set()
    for i, (step, layout, mult, v) in enumerate(_demand_story()):
        for s in (js, ts):
            if layout is not None:
                _reset(s, layout if mode == "auto" or layout == mode
                       else s.layout, mult)
                s._chain_demand = float(s._chain_buckets[-1])
                s.chain_length = s._chain_buckets[-1]
            s._host_step = step
            s._consume_demand({"demand_vec": v})
        got = (ts.layout, ts._pool_mult, ts.chain_length)
        assert got == (js.layout, js._pool_mult, js.chain_length), i
        assert ts._pool_demand == pytest.approx(js._pool_demand, rel=1e-12)
        assert ts._layout_vote == js._layout_vote, i
        seen.add(got)
    layouts = {g[0] for g in seen}
    if mode == "auto":
        assert layouts == {"csr", "strided", "rounds"}   # reset to rounds
    assert len({g[1] for g in seen}) > 2
    # the rounds chain is fixed; the others follow the q99 chain demand
    assert (len({g[2] for g in seen}) > 1) == (mode != "rounds")


def _slab_grid():
    """One cell thick, horizontal: every ray that crosses it takes ~18 to
    ~40 samples there, so the per-ray demand is tight."""
    occ = np.zeros((1, G, G, G), np.uint8)
    occ[0, :, :, G // 2] = 1
    return occ


@dataclasses.dataclass(frozen=True)
class QuickWarmupConfig(SmallTrainConfig):
    """The CPU tests' model with a one-block grid warmup."""

    grid_warmup_steps: int = 16


@pytest.mark.parametrize("layout", ["csr", "strided", "rounds"])
def test_two_blocks_in_each_layout_on_cpu(layout):
    """The port alone, each layout pinned, distortion on: two 16-step blocks
    at 256 rays on the occupancy grid of a one-cell slab (the refresh held
    off, so that the strided rows cover the rays): finite losses, no
    skipped step, the layout kept, the budget's sample counts; the
    strided and rounds steps report the share of the batch outside the
    loss, and rounds its rays alive after the last round and its slots."""
    system = _port_system(batch_size=256, img_size=32, n_train=4,
                          train_layout=layout, distortion_loss_w=1e-2)
    occ = torch.from_numpy(_slab_grid())
    system.grid_state.occ_grid = occ
    system.grid_state.win_rows = trm.occupancy_windows(occ)
    system._refresh_grid = lambda step_i: None
    before = system.ngp.hash_table.detach().clone()
    blocks = [system.step_block() for _ in range(2)]
    for m in blocks:
        assert math.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        assert int(m["n_skipped"]) == 0
        share = float(m["dropped_share"])
        if layout == "csr":
            assert share == 0.0
        else:
            assert 0.0 <= share < 0.5
        if layout == "rounds":
            assert int(m["total_slots"]) == 256 * 4
            assert 0 <= int(m["rounds_alive_end"]) < 256
        else:
            assert int(m["total_slots"]) == 0
    assert system.layout == layout and system.optimizer.count == 32
    assert not torch.equal(system.ngp.hash_table.detach(), before)


def test_auto_moves_to_strided_and_trains_there():
    """An `auto` system (warmup one block) on the slab's grid, its cameras
    moved to 80 degrees above it at distance 0.8, so that every ray that
    reaches the slab crosses it in ~19-22 steps (the scene's own cameras
    look at it from 15-55 degrees: a heavy tail, and CSR): CSR first; once
    the demand read one interval late is tight for two intervals it moves
    to the strided layout with S covering the q99 per-ray demand, and the
    next block trains there (finite loss, no skipped step, rays in the
    loss)."""
    tcfg = QuickWarmupConfig(batch_size=256, num_epochs=2)
    system = NeRFSystem(
        tcfg, device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=32, n_train=4,
                                       device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=32, n_test=1,
                                      device="cpu"))
    occ = torch.from_numpy(_slab_grid())
    system.grid_state.occ_grid = occ
    system.grid_state.win_rows = trm.occupancy_windows(occ)
    system._refresh_grid = lambda step_i: None
    el = np.deg2rad(80.0)
    system.poses = torch.from_numpy(np.stack([_lookat_pose(0.8 * np.array(
        [np.cos(t) * np.cos(el), np.sin(t) * np.cos(el), np.sin(el)]))
        for t in (0.0, 2.0, 4.0, 6.0)]))
    layouts = []
    for _ in range(6):
        m = system.step_block()
        layouts.append(system.layout)
        if system.layout == "strided":
            break
    # block 1 primes the one-interval-late read (and ends the warmup);
    # blocks 2 and 3 read tight demand: the second agreeing vote moves
    assert layouts == ["csr", "csr", "strided"]
    q99 = float(m["demand_vec"][3])
    assert 0 < q99 * 1.05 <= system._pool_mult <= 64
    m = system.step_block()
    assert system.layout == "strided"
    assert math.isfinite(float(m["loss"])) and int(m["n_skipped"]) == 0
    assert float(m["dropped_share"]) < 0.5
    assert int(m["rm_counts_max"]) > 0
