"""Rank bodies and inputs of the port's data-parallel CPU tests
(tests/test_torch_parallel.py, tests/test_torch_events.py).

The tests spawn gloo ranks with `ngp_pl_torch.parallel.launch`; a spawned
rank imports the function it runs by name, so the bodies live here, in a
module that imports only numpy, torch and the port (a test module would
import JAX and the test harness's 8-device setup into every rank).  Each
rank writes what it saw to <out>/<name>_rank<r>.pt; the same functions run
without a process group give the one-rank reference.

Sizes: grid 32, L=4, F=4, T=2^12, 256 rays of 2 views (the step cases),
the procedural scene at 24x24 (the fits).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ngp_pl_torch import parallel
from ngp_pl_torch.config import NGPConfig, RenderConfig, TrainConfig
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops.ray_march import occupancy_windows
from ngp_pl_torch.training.checkpoint import load_train_state
from ngp_pl_torch.training.system import NeRFSystem
from ngp_pl_torch.training.train_step import (
    Adam,
    cosine_epoch_schedule,
    train_render,
    train_step,
)

G = 32
N_RAYS = 256
N_PIX = 64
MODEL = dict(scale=0.5, n_levels=4, log2_hashmap_size=12, grid_size=G)
STEP_TCFG = dict(lr=1e-2, num_epochs=2, iters_per_epoch=4)
COUNT = 5                          # Adam's count: epoch 1 of the cosine
# (layout, budget, chain) of the step cases: a CSR pool of 128 slots per
# ray holds every sample of these rays with its staging budget to spare; a
# pool of 8 per ray fills; the strided rows are 16 wide.  "csr_xla_tail"
# is "csr" with the field tail as PyTorch ops rounding as jitted XLA's
# (`mlp_apply`), the tail the JAX package runs on the CPU, where it has no
# fused Pallas tail (and the mesh step cannot run one in interpret mode)
CASES = {"csr": ("csr", 128, 1152), "csr_full": ("csr", 8, 1152),
         "strided": ("strided", 16, 1152),
         "csr_xla_tail": ("csr", 128, 1152)}
FIT = dict(dataset_name="synthetic", batch_size=256, num_epochs=4,
           iters_per_epoch=16, grid_warmup_steps=16, train_layout="csr",
           exp_name="ddp", no_save_test=True)


@dataclasses.dataclass(frozen=True)
class SmallTrainConfig(TrainConfig):
    """The CPU tests' model: grid 32, L=4, T=2^12."""

    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


def _grid(seed, p):
    """Scattered occupied cells, a share `p` of the grid."""
    rng = np.random.default_rng(seed)
    return (rng.random((1, G, G, G)) < p).astype(np.uint8)


def step_inputs(noise: np.ndarray, seed: int = 3) -> dict:
    """One step's state and batch, as numpy: the port's seeded model with
    its table scaled up (so that rays terminate), two cameras at z = -2
    looking down +z, 64 pixel directions, (image, pixel) indices, targets
    and two grids (a sparse one and a dense one); Adam's moments from the
    gradient of the sparse CSR case with the march noise `noise` (the JAX
    mesh test hands JAX's own draw), as the one-step tests make them."""
    ngp = NGP(NGPConfig(**MODEL), seed=seed, device="cpu")
    params = ngp.params_numpy()
    params["hash_table"] = params["hash_table"] * 1e3
    params["sigma_mlp"][1][:, 0] *= 4.0
    rng = np.random.default_rng(seed)
    poses = np.zeros((2, 3, 4), np.float32)
    poses[:, :, :3] = np.eye(3)
    poses[:, 2, 3] = -2.0
    poses[1, 0, 3] = 0.05
    dirs = np.concatenate([rng.uniform(-0.2, 0.2, (N_PIX, 2)),
                           np.ones((N_PIX, 1))], axis=1).astype(np.float32)
    inp = dict(params=params, poses=poses, dirs=dirs,
               img=rng.integers(0, 2, N_RAYS).astype(np.int32),
               pix=rng.integers(0, N_PIX, N_RAYS).astype(np.int32),
               rgb=rng.random((N_RAYS, 3)).astype(np.float32),
               occ={"sparse": _grid(seed, 0.002), "dense": _grid(seed, 0.2)})
    zeros = {k: _tree(v, np.zeros_like) for k, v in params.items()}
    inp.update(mu=zeros, nu=zeros)
    g = {"sigma_mlp": [], "rgb_mlp": []}
    for (name, i, _), a in zip(ngp._slots(), one_step(
            inp, noise, "csr", stepped=False)["grads"]):
        if i is None:
            g[name] = a
        else:
            g[name].append(a)
    inp["mu"] = {k: _tree(v, lambda a: (0.5 * a * rng.uniform(
        0.5, 1.5, a.shape)).astype(np.float32)) for k, v in g.items()}
    inp["nu"] = {k: _tree(v, lambda a: (a * a * rng.uniform(
        1.0, 2.0, a.shape) + 1e-8).astype(np.float32)) for k, v in g.items()}
    return inp


def _tree(v, fn):
    return [fn(a) for a in v] if isinstance(v, list) else fn(v)


def one_step(inp: dict, noise: np.ndarray, case: str,
             stepped: bool = True) -> dict:
    """The step of `case` on this rank's shard of the batch (the whole
    batch without a process group): the render's pool or block, the loss
    and the ranks' mean gradient before the update, then `train_step` from
    the same state (the metrics, the parameters after it).  Returns numpy
    and Python values."""
    layout, budget, chain = CASES[case]
    occ = inp["occ"]["dense" if case == "csr_full" else "sparse"]
    tcfg = TrainConfig(**STEP_TCFG, n_levels=4, log2_hashmap_size=12,
                       batch_size=N_RAYS)
    rcfg = RenderConfig()
    win = occupancy_windows(torch.from_numpy(occ))
    img = parallel.shard(torch.from_numpy(inp["img"]).long())
    pix = parallel.shard(torch.from_numpy(inp["pix"]).long())
    ro, rd = get_rays(torch.from_numpy(inp["dirs"])[pix],
                      torch.from_numpy(inp["poses"])[img])
    ro, rd = ro.contiguous(), rd.contiguous()
    target = parallel.shard(torch.from_numpy(inp["rgb"]))
    nz = parallel.shard(torch.from_numpy(noise))
    out = {}
    for step in (False, True)[:1 + stepped]:
        ngp = NGP(NGPConfig(**MODEL), device="cpu")
        ngp.use_fused = case != "csr_xla_tail"
        opt = Adam([w for _, _, w in ngp._slots()],
                   cosine_epoch_schedule(1e-2, 2, 4, 30.0), eps=1e-15)
        load_train_state(ngp, opt, inp["params"], inp["mu"], inp["nu"],
                         COUNT)
        kw = dict(tcfg=tcfg, rcfg=rcfg, n_samples=budget,
                  chain_length=chain, layout=layout)
        if not step:
            res, loss_of = train_render(ngp, win, ro, rd, nz, torch.ones(3),
                                        **kw)
            grads = parallel.grad_mean(torch.autograd.grad(
                loss_of(target), opt.params))
            keys = (("ts", "deltas", "ray_idx", "pool_valid", "offsets",
                     "rm_counts") if layout == "csr"
                    else ("ts", "deltas", "valid", "rm_counts", "loss_mask"))
            out.update({k: res[k].detach().numpy() for k in keys})
            out["grads"] = [g.numpy() for g in grads]
            continue
        m = train_step(ngp, opt, win, ro, rd, target, nz, torch.ones(3),
                       **kw)
        out["metrics"] = {k: v.numpy() for k, v in m.items()}
        out["params"] = [p.detach().numpy().copy() for p in opt.params]
        out["mu_new"] = [t.numpy().copy() for t in opt.mu]
    return out


def small_system(n_test: int = 1, **kw) -> NeRFSystem:
    tcfg = SmallTrainConfig(**{**FIT, **kw})
    return NeRFSystem(
        tcfg, device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=24,
                                       n_train=2, device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=24,
                                      n_test=n_test, device="cpu"))


def fit_blocks(n_blocks: int = 2) -> dict:
    """`n_blocks` 16-step blocks of the small system's fit (grid warmup
    ends after the first), and after each: the controller's layout, budget
    and chain, the block's demand vector and loss, the occupancy grid and
    the parameters."""
    system = small_system()
    system.on_train_start()
    blocks = []
    for _ in range(n_blocks):
        m = system.step_block()
        blocks.append(dict(
            layout=system.layout, pool_mult=system._pool_mult,
            chain=system.chain_length, demand=m["demand_vec"].numpy(),
            loss=m["loss"].numpy(),
            occ=system.grid_state.occ_grid.numpy().copy(),
            density=system.grid_state.density_grid.numpy().copy(),
            params=[p.detach().numpy().copy()
                    for p in system.optimizer.params]))
    return dict(blocks=blocks)


def refreshed_validate() -> dict:
    """The small system's 2-view validate after the cameras' marking and
    one warmup refresh of the grid (no training, so one rank and two see
    the same state)."""
    system = small_system(n_test=2)
    system.on_train_start()
    system._refresh_grid(0)
    return system.validate(save_images=False)


def suite(out: str, inp: dict, noise: np.ndarray) -> None:
    """A rank's share of every case, saved to <out>/suite_rank<r>.pt."""
    torch.set_num_threads(1)
    res = {case: one_step(inp, noise, case) for case in CASES}
    res["fit"] = fit_blocks()
    res["validate"] = refreshed_validate()
    torch.save(res, os.path.join(out, f"suite_rank{parallel.rank()}.pt"))


def log_fit(steps: int = 32) -> None:
    """The small system's fit with its TensorBoard record (log every 16
    steps) in the working directory; rank 0's history to history.pt."""
    torch.set_num_threads(1)
    system = small_system(log_every=16)
    hist = system.fit(max_steps=steps, quiet=True)
    if parallel.rank() == 0:
        torch.save(hist, "history.pt")
