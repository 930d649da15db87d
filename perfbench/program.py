"""The system under test, `ngp_pl_torch`, as the benchmark drives it: its
kernels' build, `NeRFSystem` on the benchmark's views with the
configuration's recipe, `RoundRenderer` as ngp_pl's viewer serves a frame,
and what the benchmark reads from it: the first steps' inputs and states
(for the reference), its step metrics and its kernel wrappers' launch
counters and inputs (for the trace's readers).  This is the only module of
the benchmark that imports the program.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch

KERNEL_SOURCES = ("hash_encode_fwd", "hash_encode_bwd", "field_tail_fwd",
                  "field_tail_bwd")
# the device kernels of the wrappers below, by a part of their names
HAND_KERNELS = ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel",
                "field_tail_fwd_mma", "field_tail_bwd_mma",
                "field_tail_bwd_reduce")


def build() -> dict:
    """Build (or find built, under the checkout's build/kernels/) the
    kernels the field runs; seconds by kernel."""
    from ngp_pl_torch import _build
    return _build.build(KERNEL_SOURCES)


class Views:
    """A posed image set as NeRFSystem reads it: poses (n, 3, 4),
    camera-frame directions, intrinsics, size and the rgb store (n, H*W, 3)
    on the card (None for poses alone)."""

    def __init__(self, poses, directions, K, size, rays=None):
        self.poses = poses
        self.directions = directions
        self.K = K
        self.img_wh = (size, size)
        self.rays = rays
        self.batch_size = 0
        self.ray_sampling_strategy = "all_images"


# configuration keys the program takes as they are, with no flag to change
FIXED = {"base_resolution": 16, "max_resolution_factor": 2048.0,
         "grid_size": 128, "sh_degree": 4, "density_mlp": [None, 64, 16],
         "color_mlp": [32, 64, 64, 3]}


def train_config(config: Dict, world: int, seed: int, **kw):
    """The program's TrainConfig for a configuration file, `world` ranks of
    the recipe's batch each (the program's batch is the global one)."""
    from ngp_pl_torch.config import TrainConfig

    m, r = config["model"], config["recipe"]
    for key, want in FIXED.items():
        got = m[key]
        if isinstance(want, list):
            got = [None] + list(got[1:]) if want[0] is None else list(got)
        if got != want:
            raise ValueError(f"the program runs {key} {want} only, the "
                             f"configuration asks for {m[key]}")
    return TrainConfig(
        n_levels=m["n_levels"], n_features=m["n_features"],
        log2_hashmap_size=m["log2_hashmap_size"], scale=m["scale"],
        batch_size=r["batch_size"] * world, lr=r["lr"],
        num_epochs=r["num_epochs"], iters_per_epoch=r["iters_per_epoch"],
        opacity_loss_w=r["opacity_loss_w"], train_layout=r["train_layout"],
        num_devices=world, seed=seed, exp_name="perfbench",
        no_save_test=True, **kw)


def system(tcfg, train_views: Views, test_views: Views, dev):
    from ngp_pl_torch.training.system import NeRFSystem
    return NeRFSystem(tcfg, train_dataset=train_views,
                      test_dataset=test_views, device=dev)


def load_params(sysm, params: Dict) -> None:
    """The benchmark's weights into the system; in a process group every
    rank then takes rank 0's state."""
    sysm.ngp.load_params(params)
    sysm.replicate()


def leaves(sysm) -> List[torch.Tensor]:
    """The trained leaves in the reference's order (table, density MLP,
    colour MLP)."""
    return [w for _, _, w in sysm.ngp._slots()]


def params(sysm) -> Dict:
    """Copies of the system's weights in the reference's layout."""
    ls = [w.detach().clone() for w in leaves(sysm)]
    return {"hash_table": ls[0], "sigma_mlp": ls[1:3], "rgb_mlp": ls[3:6]}


def fence(metrics) -> float:
    """A host read of a step's loss: every step queued before it is done."""
    return float(metrics["loss"])


@contextlib.contextmanager
def first_steps(sysm, n: int, out: List[Dict]):
    """Records the first `n` steps the system takes inside the context:
    each step's batch indices, march noise, occupancy grid, budget, chain
    and layout as the step received them, its rays' colours and loss, and
    after the first step the optimizer's first moments, the grid's state
    and the positions at which the first grid refresh queried the density
    (`grid_pos`, in the order it queried them), after the n-th the
    leaves."""
    from ngp_pl_torch.training import system as system_mod
    from ngp_pl_torch.training import train_step as step_mod

    real_step = system_mod.train_step
    real_render = step_mod.train_render
    real_refresh = system_mod.update_density_grid
    real_batch = sysm.sample_batch
    batches: List = []
    colours: List = []
    grid_pos: List = []

    def update_density_grid(ngp, *args, **kw):
        if out or grid_pos:
            return real_refresh(ngp, *args, **kw)
        real_density = ngp.density

        def density(x, *a, **k):
            grid_pos.append(x.detach().clone())
            return real_density(x, *a, **k)

        ngp.density = density
        try:
            return real_refresh(ngp, *args, **kw)
        finally:
            del ngp.density

    def train_render(*args, **kw):
        results, loss_of = real_render(*args, **kw)
        colours.append(results["rgb"].detach().clone())
        return results, loss_of

    def sample_batch():
        got = real_batch()
        batches.append(got)
        return got

    def train_step(ngp, opt, win_rows, rays_o, rays_d, target, noise, bg,
                   **kw):
        metrics = real_step(ngp, opt, win_rows, rays_o, rays_d, target,
                            noise, bg, **kw)
        if len(out) < n:
            img, pix, _ = batches[-1]
            rec = {"img": img.clone(), "pix": pix.clone(),
                   "noise": noise.clone(), "bg": bg.clone(),
                   "occ_grid": kw["occ_grid"], "pool_mult": kw["n_samples"],
                   "chain": kw["chain_length"], "layout": kw["layout"],
                   "rgb": colours[-1],
                   "loss": metrics["loss"].detach().clone(),
                   "finite": metrics["grads_finite"].clone()}
            if not out:
                rec["mu"] = [m.clone() for m in opt.mu]
                rec["grid"] = sysm.grid_state
                rec["grid_pos"] = torch.cat(grid_pos) if grid_pos else \
                    torch.empty((0, 3), device=noise.device)
            if len(out) == n - 1:
                rec["leaves"] = [p.detach().clone() for p in opt.params]
            out.append(rec)
        return metrics

    sysm.sample_batch = sample_batch
    system_mod.train_step = train_step
    system_mod.update_density_grid = update_density_grid
    step_mod.train_render = train_render
    try:
        yield out
    finally:
        system_mod.train_step = real_step
        system_mod.update_density_grid = real_refresh
        step_mod.train_render = real_render
        del sysm.sample_batch


@contextlib.contextmanager
def step_metrics(sysm, out: List[Dict]):
    """Every step's device metrics inside the context."""
    real = sysm._train_step

    def step():
        m = real()
        out.append(m)
        return m

    sysm._train_step = step
    try:
        yield out
    finally:
        del sysm._train_step


def counters() -> Dict[str, object]:
    """The hand kernels' wrappers, each with its `launches` counter."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    return {"encode_fwd_f4": he.hash_encode_fwd_cuda,
            "encode_fwd_f2": he.hash_encode_fwd_f2_cuda,
            "encode_bwd_f4": he.hash_encode_bwd_cuda,
            "encode_bwd_f2": he.hash_encode_bwd_f2_cuda,
            "tail_fwd": ft.field_tail_cuda,
            "tail_bwd": ft.field_tail_bwd_cuda}


def launches() -> int:
    return sum(f.launches for f in counters().values())


@contextlib.contextmanager
def kernel_inputs(out: List):
    """Each hand-kernel launch inside the context as (kind, x or sample
    count, table bytes per value, with features), its inputs kept
    referenced (no copy, no launch)."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    real = {name: getattr(mod, name) for mod, name in (
        (he, "hash_encode_fwd_cuda"), (he, "hash_encode_fwd_f2_cuda"),
        (he, "hash_encode_bwd_cuda"), (he, "hash_encode_bwd_f2_cuda"),
        (ft, "field_tail_cuda"), (ft, "field_tail_bwd_cuda"))}

    def fwd(name):
        def call(x, table, w1, spec, feats=None):
            out.append(("encode_fwd", x, table.element_size(),
                        feats is not None))
            return real[name](x, table, w1, spec, feats)
        return call

    def bwd(name):
        def call(x, g, w1, spec):
            out.append(("encode_bwd", x, 4, False))
            return real[name](x, g, w1, spec)
        return call

    def tail(name, kind):
        def call(h1, *args):
            out.append((kind, h1.shape[0], 0, False))
            return real[name](h1, *args)
        return call

    patched = {"hash_encode_fwd_cuda": fwd("hash_encode_fwd_cuda"),
               "hash_encode_fwd_f2_cuda": fwd("hash_encode_fwd_f2_cuda"),
               "hash_encode_bwd_cuda": bwd("hash_encode_bwd_cuda"),
               "hash_encode_bwd_f2_cuda": bwd("hash_encode_bwd_f2_cuda"),
               "field_tail_cuda": tail("field_tail_cuda", "tail_fwd"),
               "field_tail_bwd_cuda": tail("field_tail_bwd_cuda",
                                           "tail_bwd")}
    # the wrappers count their launches on the function their module names,
    # the stand-in while it is in place: its count goes back to the wrapper
    for name, fn in patched.items():
        fn.launches = 0
        setattr(he if name.startswith("hash") else ft, name, fn)
    try:
        yield out
    finally:
        for name, fn in real.items():
            setattr(he if name.startswith("hash") else ft, name, fn)
            fn.launches += patched[name].launches


def renderer(sysm, directions: np.ndarray, t_threshold: float):
    """The round renderer as ngp_pl's viewer and `bench_fps` serve a frame:
    windows where the cameras allow them, the given early-termination
    threshold, chunks of min(131072, the frame's pixels rounded up to a
    power of two)."""
    from ngp_pl_torch.models.rendering import RoundRenderer
    from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok

    n = directions.shape[0]
    chunk = min(131072, 1 << (n - 1).bit_length())
    return RoundRenderer(
        sysm.ngp, dataclasses.replace(sysm.rcfg,
                                      test_t_threshold=t_threshold),
        chunk=chunk, use_window=segment_march_dmax_ok(
            directions, scale=sysm.ngp.cfg.scale))


def init_group(rank: int, world: int, address: str) -> None:
    from ngp_pl_torch import parallel
    parallel.init_distributed(rank, world, address, device="cuda")


def destroy_group() -> None:
    from ngp_pl_torch import parallel
    parallel.destroy()
