"""Many-step parity of the train loop: the JAX package's `NeRFSystem` and the
port's side by side for 4 blocks of 16 steps, compared after every block.

Both start from one state, carried over as numpy: the port trains alone
through grid warmup (4 blocks from JAX's initial parameters and marked
grid), then both go on from its parameters, Adam state and grid.  From
Adam's count 0 the loop is chaotic at this size: the first update is
lr * sign(g) for every entry, so the few table entries whose gradient sits
at the rounding floor (3 of 65,536 after one step) move 2 * lr apart, and
that grows to a 0.2 RMS difference in 16 steps; the JAX package parts as
far from itself when 3 entries are moved by 2e-2.  With 64 steps of
moments behind them the two stay within 2e-3 RMS.

Each step gets the same batch, its (image, pixel) indices drawn with numpy;
the march's jitter and each grid refresh's cell jitter are the draws
JAX's loop makes from its own key, handed to the port (its `_refresh_grid`
and `_train_step` are patched to take them).  JAX's field runs through its
TPU kernels in interpret mode, as the one-step test runs it.  What acts
late in a long run is all in the loop:
- the per-epoch cosine lr with 16 steps per epoch (epochs 4-7 of 7), at
  its floor lr / lr_final_div in the last block;
- Adam (eps 1e-15) and its count;
- the grid's EMA refresh every 16 steps (the sublattice phases 0-3) with
  its NaN sanitiser and the mean-density threshold;
- the windowed CSR march at a fixed pool (x8) and chain;
- the compositor and the loss.

After each block: the block's losses, every parameter, Adam's mu and nu
(max error of max; the parameters also as an RMS), the grid's density (max
error of max) and the share of occupancy bits that agree.  Sizes: grid
32, L=4, log2 T=12, 256 rays of 2 views at 24x24.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_pl_tpu.models.ngp as jngp_mod
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import TrainConfig
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models import occupancy as tocc
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import (
    grid_state_from_numpy,
    grid_state_numpy,
    load_train_state,
    train_state_numpy,
)
from ngp_pl_torch.training.system import NeRFSystem

torch.set_num_threads(2)

G = 32
N_RAYS = 256
POOL_MULT = 8
CHAIN = 1152
BLOCKS = 4
PRE_BLOCKS = 4
LOOP = dict(dataset_name="synthetic", batch_size=N_RAYS, lr=1e-2,
            num_epochs=7, iters_per_epoch=16, grid_warmup_steps=16,
            train_layout="csr", n_levels=4, log2_hashmap_size=12,
            exp_name="long_horizon", no_save_test=True)

# Tolerances: each is 2-5x the largest reading of the unchanged packages
# over the 4 blocks and below what each mutant of the loop reads from its
# first block on (CHANGES.md, PR 11: the lr epoch off by one, an EMA decay
# of 0.9; Adam's bias correction at `count` divides by zero at the first
# step).  The density reads trunc_exp of a bf16-rounded output, so one
# rounding flip in the densest cell moves it by ~6%: its bound only says
# the grid does not part.
LOSS_TOL = 2e-3           # max |port - JAX| / max |JAX| of a block's losses
PARAM_TOL = 0.05          # the same for every parameter
PARAM_RMS_TOL = 1e-2      # RMS of the difference over RMS of JAX's
MOMENT_TOL = 0.5          # max error of max, Adam's mu and nu
DENSITY_TOL = 0.5         # max error of max, the grid's density
BITS_AGREE = 0.998        # share of occupancy bits equal


@dataclasses.dataclass(frozen=True)
class JaxLoopConfig(JaxTrainConfig):
    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


@dataclasses.dataclass(frozen=True)
class PortLoopConfig(TrainConfig):
    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def _jax_grid_noise(sys_key, M):
    """The cell jitter of the refresh that JAX's system makes next: it
    splits its key (system.py:285) and the refresh draws from the second
    half's split (occupancy.py:199-207), one cascade."""
    _, k_refresh = jax.random.split(sys_key)
    _, k = jax.random.split(k_refresh)
    return np.array(jax.random.uniform(k, (M, 3), minval=-1.0,
                                       maxval=1.0))[None]


def _jax_march_noise(key, step):
    """The march jitter of JAX's step `step` under the system's key
    (train_step.py:118-121: fold_in, then the first of two keys)."""
    k_noise, _ = jax.random.split(jax.random.fold_in(key, step))
    return np.array(jax.random.uniform(k_noise, (N_RAYS,)))


def _systems():
    js = JaxSystem(JaxLoopConfig(**LOOP, num_devices=1),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1))
    ps = NeRFSystem(PortLoopConfig(**LOOP), device="cpu",
                    train_dataset=SyntheticDataset(split="train", img_size=24,
                                                   n_train=2, device="cpu"),
                    test_dataset=SyntheticDataset(split="test", img_size=24,
                                                  n_test=1, device="cpu"))
    js.on_train_start()
    params = jax.tree_util.tree_map(np.array, js.state.params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    load_train_state(ps.ngp, ps.optimizer, params, zeros, zeros, 0)
    grid = {k: np.array(v) for k, v in js.grid_state._asdict().items()}
    ps.grid_state = grid_state_from_numpy(grid, "cpu")
    for s in (js, ps):
        s.freeze_buckets = True
        s._pool_mult, s.chain_length, s.layout = POOL_MULT, CHAIN, "csr"
    # the port trains alone through grid warmup, with its own draws; both
    # go on from its state, where Adam's moments hold a history
    for _ in range(PRE_BLOCKS):
        ps.step_block()
    p, mu, nu, count = train_state_numpy(ps.ngp, ps.optimizer)
    adam, sched = js.state.opt_state
    as_jax = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    js.state = js.state._replace(
        params=as_jax(p), step=jnp.asarray(count, jnp.int32),
        opt_state=(adam._replace(count=jnp.asarray(count, jnp.int32),
                                 mu=as_jax(mu), nu=as_jax(nu)),
                   sched._replace(count=jnp.asarray(count, jnp.int32))))
    js.grid_state = js.grid_state._replace(**{
        k: jnp.asarray(v) for k, v in grid_state_numpy(ps.grid_state).items()})
    js._host_step = ps._host_step
    return js, ps


def _patch_port(ps, noise):
    """The port's system takes its refresh and march jitter from `noise`."""
    tcfg, n = ps.tcfg, ps.tcfg.grid_update_interval

    def refresh(step_i):
        ps.grid_state = tocc.update_density_grid(
            ps.ngp, ps.grid_state, ps.density_threshold,
            warmup=step_i < tcfg.grid_warmup_steps, phase=(step_i // n) % 4,
            erode=False, noise=torch.from_numpy(noise["grid"]))

    def train_step():
        img, pix, target = (torch.from_numpy(noise[k])
                            for k in ("img", "pix", "rgb"))
        rays_o, rays_d = get_rays(ps.directions[pix], ps.poses[img])
        return tts.train_step(
            ps.ngp, ps.optimizer, ps.grid_state.win_rows,
            rays_o.contiguous(), rays_d.contiguous(), target,
            torch.from_numpy(noise["march"]), ps.background(), tcfg=tcfg,
            rcfg=ps.rcfg, n_samples=ps._pool_mult,
            chain_length=ps.step_chain(), layout=ps.layout)

    ps._refresh_grid = refresh
    ps._train_step = train_step


def _of_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree):
    return [tree["hash_table"]] + [w for name in ("sigma_mlp", "rgb_mlp")
                                   for w in tree[name]]


def _rms_of(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / max((b ** 2).mean(),
                                                     1e-300)))


def _compare(js, ps, losses):
    """Readings of one block boundary (port against JAX)."""
    p_t, mu_t, nu_t, count = train_state_numpy(ps.ngp, ps.optimizer)
    adam = js.state.opt_state[0]
    assert count == int(adam.count) == ps._host_step == js._host_step
    occ_j = np.asarray(js.grid_state.occ_grid)
    pairs_p = list(zip(_leaves(p_t), _leaves(js.state.params)))
    pairs_m = list(zip(_leaves(mu_t) + _leaves(nu_t),
                       _leaves(adam.mu) + _leaves(adam.nu)))
    lt, lj = np.array(losses).T
    return {
        "loss": float(np.abs(lt - lj).max() / np.abs(lj).max()),
        "params": max(_of_max(a, b) for a, b in pairs_p),
        "params_rms": max(_rms_of(a, b) for a, b in pairs_p),
        "moments": max(_of_max(a, b) for a, b in pairs_m),
        "moments_rms": max(_rms_of(a, b) for a, b in pairs_m),
        "density": _of_max(ps.grid_state.density_grid.numpy(),
                           js.grid_state.density_grid),
        "bits_agree": float((ps.grid_state.occ_grid.numpy()
                             == occ_j).mean()),
        "occupied": float(occ_j.mean()),
    }


def run_loop(monkeypatch, blocks=BLOCKS):
    """Drive both loops `blocks` blocks; returns the readings per block."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    js, ps = _systems()
    js.ngp.fused_tail = True
    noise = {}
    _patch_port(ps, noise)
    rng = np.random.default_rng(2024)
    rays = np.asarray(js.train_dataset.rays, np.float32)
    n_img, n_pix = rays.shape[0], rays.shape[1]
    readings = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(blocks):
            losses = []
            for _ in range(ps.tcfg.grid_update_interval):
                step = js._host_step
                if step % ps.tcfg.grid_update_interval == 0:
                    warm = step < ps.tcfg.grid_warmup_steps
                    noise["grid"] = _jax_grid_noise(
                        js.key, G ** 3 if warm else G ** 3 // 4)
                img = rng.integers(0, n_img, N_RAYS).astype(np.int32)
                pix = rng.integers(0, n_pix, N_RAYS).astype(np.int32)
                batch = {"img_idxs": img, "pix_idxs": pix,
                         "rgb": rays[img, pix, :3]}
                noise.update(img=img.astype(np.int64),
                             pix=pix.astype(np.int64), rgb=batch["rgb"])
                mj = js.step(batch)
                noise["march"] = _jax_march_noise(js.key, step)
                mt = ps.step()
                assert bool(mj["grads_finite"]) and bool(mt["grads_finite"])
                losses.append((float(mt["loss"]), float(mj["loss"])))
            readings.append(_compare(js, ps, losses))
    return readings, js, ps


def test_four_blocks_of_the_train_loop_match_jax(monkeypatch):
    readings, js, ps = run_loop(monkeypatch)
    print("long-horizon readings per block:", readings)
    lr_floor = LOOP["lr"] / ps.tcfg.lr_final_div
    end = (PRE_BLOCKS + BLOCKS) * 16
    assert ps._host_step == js._host_step == end
    assert ps.optimizer.schedule(end - 1) == pytest.approx(lr_floor, rel=1e-6)
    assert ps.optimizer.schedule(end - 17) > 1.5 * lr_floor
    for i, r in enumerate(readings):
        assert r["loss"] <= LOSS_TOL, (i, r)
        assert r["params"] <= PARAM_TOL, (i, r)
        assert r["params_rms"] <= PARAM_RMS_TOL, (i, r)
        assert r["moments"] <= MOMENT_TOL, (i, r)
        assert r["density"] <= DENSITY_TOL, (i, r)
        assert r["bits_agree"] >= BITS_AGREE, (i, r)
    # the grid pruned and trained: neither empty nor full after warmup
    assert 0.01 < readings[-1]["occupied"] < 0.9
