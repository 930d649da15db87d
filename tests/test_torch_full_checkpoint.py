"""Port parity for full checkpoints (params, Adam state, grid state and
step in the JAX package's npz keys) in both directions, at F=4 and F=2:
the key set against a JAX `NeRFSystem.save`; a JAX checkpoint written
after three JAX steps resumes in the port bit for bit and its next step
matches JAX's; a port checkpoint loads into JAX's `NeRFSystem.load` with
the packed rows JAX derives and renders a test view as the port does; the
packed z-lines and their dilation; the port's own round trip, the
partial-update load, and what it refuses.

Sizes: grid 32, L=4, log2 T=12, 256 rays, pool x8, 24x24 views; inputs
from numpy seeds, the noise and the rays passed in explicitly."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_pl_tpu.models.ngp as jngp_mod
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models import occupancy as jocc
from ngp_pl_tpu.models.rendering import render_rays_train_csr as jax_render
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.training import losses as jlosses
from ngp_pl_tpu.training import train_step as jts
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import RenderConfig, TrainConfig
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models import occupancy as tocc
from ngp_pl_torch.models.rendering import RoundRenderer
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import (
    load_train_state,
    train_state_numpy,
)
from ngp_pl_torch.training.system import NeRFSystem
from tests.test_torch_train import (
    CHAIN,
    _jax_model,
    _leaves,
    _shell_grid,
    _step_inputs,
)

torch.set_num_threads(2)

G = 32
# lr schedule of both packages' optimizers: epoch 1 from step 2 on
TCFG = dict(batch_size=256, lr=1e-2, num_epochs=2, iters_per_epoch=2,
            train_layout="csr")


@dataclasses.dataclass(frozen=True)
class SmallTrainConfig(TrainConfig):
    """The CPU tests' model: grid 32 (or `grid`), L=4, T=2^12."""

    n_levels: int = 4
    log2_hashmap_size: int = 12
    grid: int = G

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=self.grid)


@dataclasses.dataclass(frozen=True)
class JaxSmallTrainConfig(JaxTrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def _port_system(F=4, **kw):
    return NeRFSystem(
        SmallTrainConfig(n_features=F, **{**TCFG, **kw}), device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=24, n_train=2,
                                       device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=24, n_test=1,
                                      device="cpu"))


def _jax_system(F=4):
    return JaxSystem(
        JaxSmallTrainConfig(dataset_name="synthetic", n_features=F,
                            exp_name="ckpt_test", no_save_test=True, **TCFG),
        train_dataset=JaxSynthetic(split="train", img_size=24, n_train=2),
        test_dataset=JaxSynthetic(split="test", img_size=24, n_test=1))


def _archive(path):
    with np.load(path) as f:
        return dict(f)


def _jax_grad_fn(monkeypatch, jngp, occ, ro, rd, target, noise):
    """JAX's CSR train loss and gradients (pool x8) on one batch, through
    its TPU field path with the Pallas K1/K7 interpreted, as the one-step
    test runs them; compiled once for every params of the same shapes."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    jngp.fused_tail = True
    win = jrm.occupancy_windows(jnp.asarray(occ))

    def loss_fn(p):
        res = jax_render(jngp, p, jnp.asarray(occ), jnp.asarray(ro),
                         jnp.asarray(rd), jnp.asarray(noise),
                         jnp.ones((3,), jnp.float32), rcfg=JaxRenderConfig(),
                         win_rows=win, pool_mult=8, chain_length=CHAIN)
        return jlosses.total_loss(jlosses.nerf_loss(
            res, jnp.asarray(target), lambda_opacity=1e-3,
            lambda_distortion=0.0)), res

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def call(params):
        with pltpu.force_tpu_interpret_mode():
            (loss, res), grads = fn(params)
        return float(loss), res, grads

    return call


@pytest.mark.parametrize("F", [4, 2])
def test_full_checkpoint_keys_match_jax_save(tmp_path, F):
    """Same keys, shapes and dtypes as a JAX NeRFSystem.save of the same
    model: params, grid.* (rows as uint32), opt[0].count / mu / nu,
    opt[1].count and __step__."""
    _jax_system(F).save(os.path.join(tmp_path, "jax.npz"))
    _port_system(F).save(os.path.join(tmp_path, "port.npz"))
    j = _archive(os.path.join(tmp_path, "jax.npz"))
    t = _archive(os.path.join(tmp_path, "port.npz"))
    assert set(t) == set(j)
    assert {"grid.win_rows", "opt[0].count", "opt[1].count",
            "opt[0].mu['hash_table']", "opt[0].nu['rgb_mlp'][2]",
            "__step__"} <= set(t)
    for k in j:
        assert (t[k].shape, t[k].dtype) == (j[k].shape, j[k].dtype), k


def _jax_steps(monkeypatch, F, n):
    """n JAX train steps from the one-step test's state on its batch:
    (grad fn, params, optax state, optimizer, batch)."""
    jngp, params, occ, ro, rd, target, noise = _step_inputs(F)
    grad = _jax_grad_fn(monkeypatch, jngp, occ, ro, rd, target, noise)
    opt = jts.make_optimizer(JaxTrainConfig(**TCFG))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(params)
    for _ in range(n):
        _, _, g = grad(params)
        upd, st = opt.update(g, st, params)
        params = optax.apply_updates(params, upd)
    return grad, params, st, opt, (occ, ro, rd, target, noise)


@pytest.mark.parametrize("F", [4, 2])
def test_jax_checkpoint_resumes_in_the_port(monkeypatch, tmp_path, F):
    """Three JAX steps, then JAX's NeRFSystem.save with the grid state of
    the batch's occupancy: the port's load is bit-equal (params, moments,
    count, step and every grid field, the windows as int32), and the next
    step on the same batch matches JAX's next step within the one-step
    test's limits: pool identical, loss 1e-5 relative, every gradient 2e-3
    of its max, params 1e-3 * lr, moments 1e-3 of their max."""
    grad, params, st, opt, (occ, ro, rd, target, noise) = _jax_steps(
        monkeypatch, F, 3)
    rng = np.random.default_rng(4)
    occ_rows, dil_rows, win_rows = jocc.grid_rows(jnp.asarray(occ), 1, G)
    js = _jax_system(F)
    js.grid_state = js.grid_state._replace(
        density_grid=jnp.asarray(rng.random((1, G ** 3), np.float32)),
        count_grid=jnp.asarray(rng.random((1, G ** 3), np.float32)),
        occ_grid=jnp.asarray(occ), mean_density=jnp.float32(0.37),
        occ_rows=occ_rows, dil_rows=dil_rows, win_rows=win_rows)
    js.state = js.state._replace(params=params, opt_state=st,
                                 step=jnp.asarray(3, jnp.int32))
    path = os.path.join(tmp_path, "jax_full.npz")
    js.save(path)

    ts = _port_system(F)
    ts.load(path)
    p_t, mu_t, nu_t, count = train_state_numpy(ts.ngp, ts.optimizer)
    for a, b in zip(_leaves(p_t) + _leaves(mu_t) + _leaves(nu_t),
                    _leaves(params) + _leaves(st[0].mu) + _leaves(st[0].nu)):
        np.testing.assert_array_equal(a, b)
    assert count == ts._host_step == 3 == int(st[0].count)
    gs = ts.grid_state
    for name in ("density_grid", "count_grid", "occ_grid", "mean_density"):
        np.testing.assert_array_equal(getattr(gs, name).numpy(),
                                      np.asarray(getattr(js.grid_state, name)))
    assert gs.win_rows.dtype == torch.int32
    np.testing.assert_array_equal(gs.win_rows.numpy().view(np.uint32),
                                  np.asarray(win_rows))

    loss_j, res_j, grads_j = grad(params)
    upd, st_new = opt.update(grads_j, st, params)
    params_new = optax.apply_updates(params, upd)
    args = (torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(noise), torch.ones(3))
    res_t, loss_of = tts.train_render(
        ts.ngp, gs.win_rows, *args, tcfg=ts.tcfg, rcfg=RenderConfig(),
        n_samples=8, chain_length=CHAIN)
    for k in ("ts", "ray_idx", "offsets", "rm_counts"):
        np.testing.assert_array_equal(res_t[k].numpy(), np.asarray(res_j[k]))
    loss_t = loss_of(torch.from_numpy(target))
    assert float(loss_t.detach()) == pytest.approx(loss_j, rel=1e-5)
    grads_t = torch.autograd.grad(loss_t, ts.optimizer.params)
    for i, (a, b) in enumerate(zip(grads_t, _leaves(grads_j))):
        assert np.abs(a.numpy() - b).max() <= 2e-3 * np.abs(b).max(), i

    m = tts.train_step(ts.ngp, ts.optimizer, gs.win_rows, *args[:2],
                       torch.from_numpy(target), *args[2:], tcfg=ts.tcfg,
                       rcfg=RenderConfig(), n_samples=8, chain_length=CHAIN)
    assert int(m["n_skipped"]) == 0
    assert float(m["loss"]) == pytest.approx(loss_j, rel=1e-5)
    p_t, mu_t, nu_t, count = train_state_numpy(ts.ngp, ts.optimizer)
    assert count == 4 == int(st_new[0].count) == int(st_new[1].count)
    lr = float(tts.cosine_epoch_schedule(1e-2, 2, 2, 30.0)(3))
    for a, b in zip(_leaves(p_t), _leaves(params_new)):
        assert np.abs(a - b).max() <= 1e-3 * lr
    for a, b in zip(_leaves(mu_t) + _leaves(nu_t),
                    _leaves(st_new[0].mu) + _leaves(st_new[0].nu)):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def _trained_port_system(F, count=7):
    """A port system with a field whose camera rays reach opacity ~0.6 (a
    denser one's steep surfaces part JAX's CPU field and the port's, whose
    numerics differ, by more than the render limits; see the render
    test), random Adam moments, `count` steps and the grid of one warmup
    refresh of that field."""
    _, params = _jax_model(scale_table=1e3, seed=0, F=F)
    params["sigma_mlp"][1][:, 0] *= 8.0
    ts = _port_system(F)
    rng = np.random.default_rng(5)
    mu, nu = ({k: (rng.normal(size=v.shape).astype(np.float32)
                   if k == "hash_table" else
                   [rng.normal(size=w.shape).astype(np.float32) for w in v])
               for k, v in params.items()} for _ in range(2))
    load_train_state(ts.ngp, ts.optimizer, params, mu, nu, count)
    ts._host_step = count
    ts.on_train_start()
    ts._refresh_grid(0)
    return ts


@pytest.mark.parametrize("F", [4, 2])
def test_port_checkpoint_loads_into_jax(tmp_path, F):
    """The port's full checkpoint through JAX's NeRFSystem.load: its packed
    rows are what JAX's grid_rows makes of its occ_grid, bit for bit;
    params, moments, counts and step arrive unchanged; JAX's render of the
    test view from the loaded state agrees with the port's within the
    render test's limits (rgb and opacity 5e-3, depth 1e-2)."""
    ts = _trained_port_system(F)
    occ = ts.grid_state.occ_grid.numpy()
    assert 0 < occ.sum() < occ.size
    path = os.path.join(tmp_path, "port_full.npz")
    ts.save(path)
    arc = _archive(path)
    for name, rows in zip(("occ_rows", "dil_rows", "win_rows"),
                          jocc.grid_rows(jnp.asarray(occ), 1, G)):
        assert arc[f"grid.{name}"].dtype == np.uint32
        np.testing.assert_array_equal(arc[f"grid.{name}"], np.asarray(rows))

    js = _jax_system(F)
    js.load(path)
    p_t, mu_t, nu_t, _ = train_state_numpy(ts.ngp, ts.optimizer)
    st = js.state.opt_state
    for a, b in zip(_leaves(js.state.params) + _leaves(st[0].mu)
                    + _leaves(st[0].nu),
                    _leaves(p_t) + _leaves(mu_t) + _leaves(nu_t)):
        np.testing.assert_array_equal(a, b)
    assert (int(st[0].count), int(st[1].count), int(js.state.step),
            js._host_step) == (7, 7, 7, 7)
    np.testing.assert_array_equal(np.asarray(js.grid_state.density_grid),
                                  ts.grid_state.density_grid.numpy())

    item = js.test_dataset.test_item(0)
    out_j = js.render_image.from_pose(
        js.state.params, js.grid_state.occ_grid,
        js.test_dataset.directions, item["pose"])
    out_t = RoundRenderer(ts.ngp, ts.rcfg).render_pose(
        ts.grid_state.occ_grid, torch.from_numpy(ts.test_dataset.directions),
        torch.from_numpy(item["pose"]))
    assert float(out_t["opacity"].max()) > 0.5
    for k, tol in (("rgb", 5e-3), ("opacity", 5e-3), ("depth", 1e-2)):
        np.testing.assert_allclose(out_t[k].numpy(),
                                   np.asarray(out_j[k]).reshape(
                                       out_t[k].shape), atol=tol, err_msg=k)


@pytest.mark.parametrize("C,grid,frac", [(1, 32, "shell"), (1, 32, 0.3),
                                         (1, 48, 0.05), (2, 32, 0.5)])
def test_grid_rows_bit_identical(C, grid, frac):
    """occupancy_lines, dilate_lines and the windows against JAX's
    grid_rows: one and two cascades, G a multiple of 32 and not."""
    if frac == "shell":
        occ = _shell_grid()
    else:
        occ = (np.random.default_rng(2).random((C, grid, grid, grid))
               < frac).astype(np.uint8)
    got = tocc.grid_rows(torch.from_numpy(occ))
    for a, b in zip(got, jocc.grid_rows(jnp.asarray(occ), C, grid)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))


def test_round_trip_then_fit(tmp_path):
    """Save after 32 steps, load into a fresh system: every tensor equal
    (params, moments, grid fields), count and step; the demand controller
    restarts from its initial values, as in the JAX package; the loaded
    system fits 32 more steps with finite losses and no skipped step."""
    a = _port_system(num_epochs=4, iters_per_epoch=16)
    a.fit(max_steps=32, log_every=16, quiet=True)
    b = _port_system(num_epochs=4, iters_per_epoch=16)
    pool0, chain0 = b._pool_mult, b.chain_length
    path = os.path.join(tmp_path, "full.npz")
    a.save(path)
    b.load(path)
    for x, y in zip(a.optimizer.params + a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.params + b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    for name in ("density_grid", "count_grid", "occ_grid", "mean_density",
                 "win_rows"):
        assert torch.equal(getattr(a.grid_state, name),
                           getattr(b.grid_state, name)), name
    assert a.optimizer.count == b.optimizer.count == b._host_step == 32
    assert (b._pool_mult, b.chain_length) == (pool0, chain0)
    hist = b.fit(max_steps=32, log_every=16, quiet=True)
    assert [h["step"] for h in hist] == [48, 64]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["skipped_total"] == 0 and b.optimizer.count == 64


def test_load_writes_through_the_parameters(tmp_path):
    """A load copies into the Parameter objects: their version counters
    move, so the encode's table copy (cached on the counter) is rebuilt
    from the loaded table."""
    src = _trained_port_system(4)
    path = os.path.join(tmp_path, "full.npz")
    src.save(path)
    dst = _port_system(4)
    stale = dst.ngp.encode_table().clone()
    ids = [id(p) for p in dst.optimizer.params]
    versions = [p._version for p in dst.optimizer.params]
    dst.load(path)
    assert [id(p) for p in dst.optimizer.params] == ids
    assert all(p._version > v for p, v in zip(dst.optimizer.params,
                                              versions))
    want = src.ngp.hash_table.detach().clamp(-65504, 65504).half()
    assert torch.equal(dst.ngp.encode_table(), want)
    assert not torch.equal(stale, want)


@pytest.mark.parametrize("other", [dict(F=2), dict(grid=64)])
def test_geometry_mismatch_raises(tmp_path, other):
    """A checkpoint of another table geometry or grid size is refused and
    the message names the flags, as the JAX package's."""
    path = os.path.join(tmp_path, "full.npz")
    _port_system(4).save(path)
    with pytest.raises(ValueError, match="--n_levels/--n_features/"
                       "--log2_hashmap_size and --scale"):
        _port_system(**other).load(path)


def test_missing_keys_keep_the_template(tmp_path):
    """A partial archive (the params alone, no step) loads as the JAX
    package's partial update: the params are replaced, the moments, the
    count and the grid kept, the step 0."""
    src = _trained_port_system(4)
    full = os.path.join(tmp_path, "full.npz")
    src.save(full)
    part = os.path.join(tmp_path, "params_only.npz")
    np.savez(part, **{k: v for k, v in _archive(full).items()
                      if k.startswith("params")})
    dst = _port_system(4)
    dst._host_step = 5
    mu0 = [m.clone() for m in dst.optimizer.mu]
    occ0 = dst.grid_state.occ_grid.clone()
    dst.load(part)
    for x, y in zip(dst.optimizer.params, src.optimizer.params):
        assert torch.equal(x, y)
    for x, y in zip(dst.optimizer.mu, mu0):
        assert torch.equal(x, y)
    assert torch.equal(dst.grid_state.occ_grid, occ0)
    assert dst.optimizer.count == 0 and dst._host_step == 0


def test_pose_state_raises(tmp_path):
    """Pose refinement (`pose[...]` keys) is a later slice: refused, not
    dropped."""
    path = os.path.join(tmp_path, "full.npz")
    _port_system(4).save(path)
    arc = _archive(path)
    arc["pose['dR']"] = np.zeros((2, 3), np.float32)
    np.savez(path, **arc)
    with pytest.raises(NotImplementedError, match="optimize_ext"):
        _port_system(4).load(path)
