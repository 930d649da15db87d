"""The JAX repository's demand traces, NaN tools and pose-gradient check in
the port (`ngp_pl_torch.benchmarking.diag_demand`, `diag_demand2`,
`nan_hunt`, `nan_replay`, `nan_probe`, `dbg_pose`), on the CPU at the
test size (grid 32, L=4, log2 T=12, 256 rays of 24x24 views):
- the port's demand vector, step by step over the first two blocks (of
  8 steps),
  against the JAX system's on the same batches, march noise and grid
  (JAX's field through its TPU kernels in interpret mode, as
  tests/test_torch_long_horizon.py runs it), within
  tests/test_torch_parallel.py's limit for the vector (rtol 1e-6);
- both diag scripts' nine fields finite, under the JAX scripts' lines;
- a `nan_hunt` snapshot, through its file into a new system, gives the
  same block again bit for bit, and the probe finds that state finite;
- a NaN planted in the table at block k is found at block k, and the
  probe names the table and the encode as the first non-finite leaf and
  stage on both paths;
- the probe's `tail_check` on the kernels' tail inputs: the rounding
  check passes the plain tail and refuses one 1e-4 off;
- `dbg_pose`'s dR and dT gradients against the JAX script's on its own
  inputs within 2e-3 of their max (tests/test_torch_pose.py's limit), at
  S=64; at the JAX script's S=8 no ray is in the loss and both read 0.
  The JAX side runs under jit, as the port's rounding follows jitted JAX
  (`mlp_apply`); the JAX script takes its gradient eagerly, which rounds
  the second sigma layer's output to bf16, and its dT then reads 3.9e-2
  of its max away from jitted JAX's (dR 5e-4)."""
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_pl_tpu.models.ngp as jngp_mod
from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.datasets.ray_utils import axisangle_to_R as jax_axisangle
from ngp_pl_tpu.datasets.ray_utils import get_rays as jax_get_rays
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.rendering import render_rays_train as jax_render
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.training import losses as jlosses
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.benchmarking import (
    dbg_pose,
    diag_demand,
    diag_demand2,
    field_tail_gates,
    nan_hunt,
    nan_probe,
    nan_replay,
)
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops.field_tail import field_tail_plain
from ngp_pl_torch.training.checkpoint import (
    grid_state_from_numpy,
    load_train_state,
)
from ngp_pl_torch.training.system import NeRFSystem
from ngp_pl_torch.training.train_step import DEMAND_KEYS
from tests.test_torch_long_horizon import (
    LOOP,
    N_RAYS,
    JaxLoopConfig,
    PortLoopConfig,
    _jax_march_noise,
    _patch_port,
)

torch.set_num_threads(2)

JAX_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarking"
DEMAND_RTOL = 1e-6          # tests/test_torch_parallel.py's demand limit
POSE_TOL = 2e-3             # tests/test_torch_pose.py's gradient limit


def _port_system(**kw):
    return NeRFSystem(
        PortLoopConfig(**{**LOOP, **kw}), device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=24,
                                       n_train=2, device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=24, n_test=1,
                                      device="cpu"))


def test_demand_vectors_match_jax_over_the_first_blocks(monkeypatch):
    """From JAX's initial parameters and marked grid, CSR pinned, the
    controller running: each step's nine-field demand vector of the port
    within DEMAND_RTOL of JAX's, and the budget and chain after each
    block equal.  Each block's refreshed grid is JAX's, handed to the
    port: the refresh's own parity is tests/test_torch_train.py's, and a
    bf16 flip of one cell's density there moves every count through it."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    loop = {**LOOP, "grid_update_interval": 8}
    js = JaxSystem(JaxLoopConfig(**loop, num_devices=1),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1))
    js.on_train_start()
    js.ngp.fused_tail = True
    ps = _port_system(grid_update_interval=8)
    params = jax.tree_util.tree_map(np.array, js.state.params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    load_train_state(ps.ngp, ps.optimizer, params, zeros, zeros, 0)
    ps.grid_state = grid_state_from_numpy(
        {k: np.array(v) for k, v in js.grid_state._asdict().items()}, "cpu")
    noise = {}
    _patch_port(ps, noise)
    ps._refresh_grid = lambda step_i: setattr(
        ps, "grid_state", grid_state_from_numpy(
            {k: np.array(v) for k, v in js.grid_state._asdict().items()},
            "cpu"))
    rng = np.random.default_rng(5)
    rays = np.asarray(js.train_dataset.rays, np.float32)
    nb = ps.tcfg.grid_update_interval
    worst = 0.0
    with pltpu.force_tpu_interpret_mode():
        for _ in range(2 * nb):
            step = js._host_step
            img = rng.integers(0, rays.shape[0], N_RAYS).astype(np.int32)
            pix = rng.integers(0, rays.shape[1], N_RAYS).astype(np.int32)
            rgb = rays[img, pix, :3]
            mj = js.step({"img_idxs": img, "pix_idxs": pix, "rgb": rgb})
            noise.update(img=img.astype(np.int64), pix=pix.astype(np.int64),
                         rgb=rgb, march=_jax_march_noise(js.key, step))
            mt = ps.step()
            vj = np.asarray(mj["demand_vec"], np.float64)
            vt = mt["demand_vec"].numpy().astype(np.float64)
            assert vj.shape == vt.shape == (len(DEMAND_KEYS),)
            assert np.isfinite(vt).all()
            np.testing.assert_allclose(vt, vj, rtol=DEMAND_RTOL,
                                       err_msg=f"step {step}")
            worst = max(worst, float(np.max(np.abs(vt - vj)
                                            / np.maximum(np.abs(vj), 1e-30))))
            if (step + 1) % nb == 0:
                assert (ps._pool_mult, ps.chain_length, ps.layout) == (
                    js._pool_mult, js.chain_length, js.layout), step
    print("demand vector, worst relative error", worst)
    # the JAX script unpacks seven of the nine fields, so it stops at its
    # first block (ROADMAP, reference defects)
    src = (JAX_DIR / "diag_demand.py").read_text()
    assert re.search(r"rm, cmax, cq, rm_q, vr_q99, vr_q90, vr_mean = ", src)


def test_diag_scripts_read_nine_finite_fields():
    """Both scripts on the test system: every block's nine fields finite,
    each line the JAX script's line (diag_demand's with the two fields it
    leaves out after it)."""
    lines = []
    recs = diag_demand.run(_port_system(), 2, emit=lines.append)
    assert len(recs) == 2 and diag_demand.all_finite(recs)
    assert all(re.match(r"^blk +\d+ pool x\d+ chain \d+ rm_tot \d+ rm/ray "
                        r"[0-9.]+ rm_q99 \d+ vr_q99 \d+ vr_q90 \d+ vr_mean "
                        r"[0-9.]+ pd [0-9.]+ alive_end \d+ rm_mean [0-9.]+$",
                        ln) for ln in lines), lines
    lines.clear()
    recs = diag_demand2.run(_port_system(), 32, emit=lines.append)
    assert len(recs) == 2 and diag_demand.all_finite(recs)
    assert all(ln.startswith("blk ") and " layout csr " in ln
               and " chain_q " in ln for ln in lines), lines
    src = (JAX_DIR / "diag_demand2.py").read_text()
    for field in ("layout", "rm_mean", "rm_q99", "vr_q99", "vr_mean",
                  "rm_pre", "chain_q"):
        assert f" {field} " in src and any(f" {field} " in ln
                                           for ln in lines), field


def _params(system):
    return [w.detach().clone() for _, _, w in system.ngp._slots()]


def test_snapshot_restores_a_block_bit_equal(tmp_path):
    """One block, a snapshot, the next block; the snapshot through its
    file into a new system and the same block again: loss, parameters,
    moments, grid, the controller and the generator bit-equal."""
    system = _port_system(train_layout="auto")
    system.on_train_start()
    system.step_block()
    snap = nan_hunt.snapshot(system)
    loss = float(system.step_block()["loss"])
    want = (_params(system), [m.clone() for m in system.optimizer.mu],
            system.grid_state.density_grid.clone(),
            system.generator.get_state(), system._pool_mult,
            system._host_step)
    path = str(tmp_path / "snap.npz")
    nan_hunt.save_snapshot(path, snap, steps=32, epochs=LOOP["num_epochs"])
    assert nan_hunt.snapshot_meta(path) == {"steps": 32, "epochs": 7}
    other = _port_system(train_layout="auto")
    nan_hunt.restore(other, nan_hunt.load_snapshot(path, other))
    assert float(other.step_block()["loss"]) == loss
    got = (_params(other), other.optimizer.mu,
           other.grid_state.density_grid, other.generator.get_state(),
           other._pool_mult, other._host_step)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert got[4:] == want[4:]
    # the probe of a finite state: no stage or leaf named, and on the CPU
    # both paths are the plain versions
    rec = nan_probe.probe(other, log=None)
    assert rec["first_bad_leaf"] is None
    assert rec["first_bad_stage"] == {"kernels": None, "plain": None}
    assert set(rec["kernels_vs_plain"].values()) == {0.0}
    assert set(rec["kernels_vs_plain"]) == {
        "h1_max_rel_err", "k7_rgb_max_abs_err", "rgb_paths_max_abs_err"}


def test_planted_nan_is_found_at_its_block_and_named(monkeypatch, tmp_path):
    """A NaN written into level 0's table rows at the start of block 2
    (every sample reads level 0): the hunt stops at block 2, the replay
    from its snapshot file fails at that block's first step, and the probe
    names the table as the first non-finite leaf and the encode as the
    first non-finite stage on both paths."""
    system = _port_system()
    rows = system.ngp.spec.sizes[0]
    refresh = system._refresh_grid

    def planted(step_i):
        refresh(step_i)
        if step_i == 32:
            with torch.no_grad():
                system.ngp.hash_table[:rows] = float("nan")

    monkeypatch.setattr(system, "_refresh_grid", planted)
    system.on_train_start()
    snap, block, losses, bad = nan_hunt.hunt(system, 80, log=lambda s: None)
    assert bad and block == 2 and len(losses) == 3
    assert all(math.isfinite(v) for v in losses[:2])
    path = str(tmp_path / "snap.npz")
    nan_hunt.save_snapshot(path, snap, steps=80, epochs=7)
    lines = []
    out = nan_replay.replay(path, system=system, log=lines.append)
    assert out["first_bad_step"] == 32 and len(out["losses"]) == 1
    rec = out["probe"]
    assert rec["first_bad_leaf"] == "params['hash_table']"
    assert rec["first_bad_stage"] == {"kernels": "h1 (encode+L1)",
                                      "plain": "h1 (encode+L1)"}
    assert rec["march"]["ts"]["nan"] == 0
    assert any("<==" in ln and "hash_table" in ln for ln in lines)


def test_probe_tail_check_holds_the_tail_by_its_roundings():
    """The probe's `tail_check` gets the kernels' path's tail inputs:
    chip_smoke.py's check of K7 there (`tail_rounded_as` at 1e-5) passes
    the plain tail itself with no flip and no error, and refuses a tail
    whose rgb is 1e-4 off."""
    system = _port_system(train_layout="auto")
    system.on_train_start()
    system.step_block()

    def check(tail):
        return lambda h1, sh, *ws: field_tail_gates.tail_rounded_as(
            tail, h1, sh, *ws, 1e-5)[1]

    def off(*args):
        sigma, rgb = field_tail_plain(*args)
        return sigma, rgb + 1e-4

    rec = nan_probe.probe(system, log=None,
                          tail_check=check(field_tail_plain))
    got = rec["tail_check"]
    assert got["out_of_window"] == got["flips"] == 0
    assert got["max_rel_err"] == 0.0
    assert nan_probe.probe(system, log=None)["tail_check"] is None
    got = nan_probe.probe(system, log=None, tail_check=check(off))
    got = got["tail_check"]
    assert got["out_of_window"] > 0 or got["max_rel_err"] > 1e-5


def _jax_pose_grads(n_samples):
    """The JAX script's dR, dT gradients at S = n_samples, and its
    parameters."""
    cfg = JaxNGPConfig(scale=0.5, n_levels=4, log2_hashmap_size=12,
                       grid_size=32)
    rcfg = JaxRenderConfig(max_samples=64, train_pool_mult=8)
    ngp = JaxNGP(cfg)
    params = ngp.init(jax.random.PRNGKey(0))
    poses, dirs, img, pix, rgb_gt = (jnp.asarray(a)
                                     for a in dbg_pose.inputs())
    occ = jnp.ones((cfg.cascades, 32, 32, 32), jnp.uint8)

    def loss_fn(pp):
        p = poses[img]
        R = jax_axisangle(pp["dR"][img]) @ p[:, :, :3]
        t = p[:, :, 3] + pp["dT"][img]
        rays_o, rays_d = jax_get_rays(
            dirs[pix], jnp.concatenate([R, t[:, :, None]], axis=-1))
        out = jax_render(ngp, params, occ, rays_o, rays_d,
                         jnp.zeros((dbg_pose.B,)), jnp.ones((3,)),
                         rcfg=rcfg, n_samples=n_samples, chain_length=64)
        return jlosses.total_loss(jlosses.nerf_loss(
            out, rgb_gt, lambda_opacity=1e-3, lambda_distortion=0))

    pp = {"dR": jnp.zeros((dbg_pose.N_IMAGES, 3)),
          "dT": jnp.zeros((dbg_pose.N_IMAGES, 3))}
    return jax.jit(jax.grad(loss_fn))(pp), params


def test_dbg_pose_gradients_match_jax():
    g_j, params = _jax_pose_grads(64)
    ngp = NGP(dbg_pose.config()[0], device="cpu", need_x_grad=True)
    ngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    rec = dbg_pose.run(ngp, "cpu", n_samples=64)
    assert rec["rays_in_loss"] == dbg_pose.B
    for k in ("dR", "dT"):
        want = np.asarray(g_j[k])
        assert np.abs(want).max() > 0
        err = np.abs(rec[k].numpy() - want).max() / np.abs(want).max()
        assert err <= POSE_TOL, (k, err)
    zero = dbg_pose.run(ngp, "cpu", n_samples=8)
    assert zero["rays_in_loss"] == 0
    assert zero["dR_grad_max"] == zero["dT_grad_max"] == 0.0
