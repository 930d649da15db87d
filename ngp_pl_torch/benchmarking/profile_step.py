"""The train step stage by stage, the counterpart of
benchmarking/profile_step.py.

    python -m ngp_pl_torch.benchmarking.profile_step [--layout csr]
        [--batch 8192] [--warm 192] [--device cuda]
        [--n_levels 16 --n_features 2]

bench.py's operating point: the flagship (or the geometry of
`--n_levels`/`--n_features`) on 8 procedural views at 96x96, batch
`--batch` (JAX: PROF_BATCH, 8192), the layout pinned to `--layout`
(strided, the JAX script's stages, or CSR, the layout chip_smoke.py and
bench.py pin), `--warm` (JAX: PROF_WARM, 192) steps to a steady budget.
Then one ray batch and its march noise are drawn from
`np.random.default_rng(0)` as the JAX script draws them, and each stage
runs alone under the JAX script's name:
  full step            `NeRFSystem.step` (a grid refresh every 16th)
  march                `march_rays_train_strided`, or with `--layout csr`
                       `march_rays_train_window` into the pool
  field fwd, fwd+bwd   `NGP.forward_rays` / `NGP.forward` on the march's
                       positions; the table gradient
  encode+l1 fwd, fwd+bwd  `hash_encode_mlp` on the same positions
  composite fwd+bwd    `composite_train_strided` / `composite_train`
  render fwd, fwd+bwd  `render_rays_train` / `render_rays_train_csr`
  grid update          `update_density_grid`, warmup and erode off
  adam update          the port's `Adam` on ones gradients, on copies
Each gets the fenced wall ms of 20 calls after 3 (`ngp_pl_torch.
device.sync` at both ends, the JAX script's `timeit`; the grid update 5)
and, on the card, the device ms of its kernels per call
(`benchmarking/timing.device_ms`, 20 calls under torch.profiler).  The
table goes to stderr; on stdout a JSON line of the setup (layout, budget,
chain, samples, card), then, last, {stage: {"wall_ms", "device_ms"}}
(device_ms null on the CPU, where there is no device clock).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the JAX script's stage names, in its order (benchmarking/profile_step.py)
STAGES = ("full step", "march (strided window)", "field fwd",
          "field fwd+bwd", "encode+l1 fwd", "encode+l1 fwd+bwd",
          "composite fwd+bwd", "render fwd (march+field+composite)",
          "render fwd+bwd", "grid update (every 16 steps)", "adam update")
LAYOUTS = ("strided", "csr")


def profile_system(device: str, batch: int, layout: str, **kw):
    """The JAX script's system: bench.py's (`bench.bench_system`) at batch
    `batch` with the layout pinned; `kw` changes the geometry."""
    from ngp_pl_torch.benchmarking.bench import bench_system

    return bench_system(device, batch, exp_name="prof", train_layout=layout,
                        **kw)


def ray_batch(system, seed: int = 0, rng=None):
    """(rays_o, rays_d, noise) of the JAX script (:77-88): B images and B
    pixels from `default_rng(seed)` (or from `rng`, which goes on to draw
    what the caller draws after them), rays_d = pose[:3, :3] @ dir in
    float32, then B uniforms of march noise."""
    ds = system.train_dataset
    B = system.tcfg.batch_size
    rng = np.random.default_rng(seed) if rng is None else rng
    img_idxs = rng.integers(0, len(ds.poses), B)
    pix_idxs = rng.integers(0, ds.directions.shape[0], B)
    poses = np.asarray(ds.poses)[img_idxs]
    dirs = np.asarray(ds.directions)[pix_idxs]
    rays_d = np.einsum("nij,nj->ni", poses[:, :, :3], dirs)
    rays_o = poses[:, :, 3]
    noise = rng.random(B)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
                 .to(system.dev) for a in (rays_o, rays_d, noise))


def march(system, layout: str, rays_o, rays_d, noise):
    """The step's march of one batch in `layout`, as the system's step
    runs it (`rendering.march_train`)."""
    from ngp_pl_torch.models.rendering import march_train

    gs = system.grid_state
    return march_train(system.cfg, system.rcfg, rays_o, rays_d, noise,
                       gs.win_rows if system.window_march else None,
                       layout=layout, slots=system._pool_mult,
                       chain_length=system.chain_length,
                       occ_grid=gs.occ_grid)


def stage_fns(system, layout: str, rays_o, rays_d, noise):
    """(each stage's call after the full step, by its STAGES name, on this
    batch and the system's state; the batch's march)."""
    from ngp_pl_torch.models.occupancy import update_density_grid
    from ngp_pl_torch.models.rendering import (
        render_rays_train,
        render_rays_train_csr,
    )
    from ngp_pl_torch.ops.hash_encoding import hash_encode_mlp
    from ngp_pl_torch.ops.ray_march import _fma
    from ngp_pl_torch.ops.volume_render import (
        composite_train,
        composite_train_strided,
    )
    from ngp_pl_torch.training.train_step import Adam

    ngp, cfg, rcfg = system.ngp, system.cfg, system.rcfg
    gs, S, chain = system.grid_state, system._pool_mult, system.chain_length
    B = rays_o.shape[0]
    win_rows = gs.win_rows if system.window_march else None
    table = ngp.hash_table
    m = march(system, layout, rays_o, rays_d, noise)
    if layout == "strided":
        xyz = _fma(m.ts[..., None], rays_d[:, None, :], rays_o[:, None, :])

        def field():
            return ngp.forward_rays(xyz, rays_d)

        def composite(s, r):
            return composite_train_strided(s, r, m.deltas, m.ts, m.valid,
                                           T_threshold=rcfg.t_threshold)

        def render():
            return render_rays_train(
                ngp, win_rows, rays_o, rays_d, noise, ones, rcfg=rcfg,
                n_samples=S, chain_length=chain, occ_grid=gs.occ_grid)
    else:
        ridx = torch.clamp(m.ray_idx, 0, B - 1)
        d = rays_d[ridx]
        xyz = _fma(m.ts[:, None], d, rays_o[ridx])

        def field():
            return ngp(xyz, d)

        def composite(s, r):
            return composite_train(s, r, m.deltas, m.ts, m.ray_idx, m.valid,
                                   m.offsets, n_rays=B,
                                   T_threshold=rcfg.t_threshold)

        def render():
            return render_rays_train_csr(
                ngp, win_rows, rays_o, rays_d, noise, ones, rcfg=rcfg,
                pool_mult=S, chain_length=chain, occ_grid=gs.occ_grid)
    ones = torch.ones(3, device=system.dev)
    xn = ((xyz + cfg.scale) / (2 * cfg.scale)).reshape(-1, 3).contiguous()
    with torch.no_grad():
        sigmas, rgbs = field()
    sigmas.requires_grad_(True)
    rgbs.requires_grad_(True)

    def table_grad(loss):
        (g,) = torch.autograd.grad(loss, [table])
        return (g * g).sum()

    def field_fwd():
        with torch.no_grad():
            s, r = field()
            return s.sum() + r.sum()

    def field_grad():
        s, r = field()
        return table_grad(s.sum() + r.sum())

    def enc():
        return hash_encode_mlp(xn, table, ngp.sigma_mlp[0],
                               ngp.encode_table(), ngp.spec).sum()

    def enc_fwd():
        with torch.no_grad():
            return enc()

    def comp_grad():
        out = composite(sigmas, rgbs)
        gs_, gr = torch.autograd.grad(out["rgb"].sum() + out["depth"].sum(),
                                      [sigmas, rgbs])
        return gs_.sum() + gr.sum()

    def render_fwd():
        with torch.no_grad():
            return render()["rgb"].sum()

    def render_grad():
        return table_grad(render()["rgb"].sum())

    gen = torch.Generator(device=system.dev).manual_seed(7)

    def grid_update():
        return update_density_grid(ngp, gs, system.density_threshold,
                                   warmup=False, erode=False,
                                   generator=gen).mean_density

    # Adam on copies, so that the system's parameters stay as they are
    names = [n for n, _, _ in ngp._slots()]
    copies = [w.detach().clone() for _, _, w in ngp._slots()]
    opt = Adam(copies, lambda step: system.tcfg.lr, eps=system.tcfg.adam_eps)
    grads = [torch.ones_like(w) for w in copies]
    at_table = names.index("hash_table")

    def adam():
        opt.step(grads)
        return copies[at_table].sum()

    return dict(zip(STAGES[1:], (
        lambda: march(system, layout, rays_o, rays_d, noise).total,
        field_fwd, field_grad, enc_fwd, lambda: table_grad(enc()),
        comp_grad, render_fwd, render_grad, grid_update, adam))), m


def timeit(fn, dev, runs: int = 20, warmup: int = 3) -> dict:
    """The JAX script's `timeit` (`warmup` calls, then `runs` calls
    between two fences, ms per call), and on the card the device ms of
    each call's kernels (`timing.device_ms`, `runs` calls)."""
    from ngp_pl_torch.device import sync

    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    sync(dev)
    wall = (time.perf_counter() - t0) / runs * 1e3
    device = None
    if torch.device(dev).type == "cuda":
        from ngp_pl_torch.benchmarking.timing import device_ms

        device = device_ms(fn, runs=runs)
    return {"wall_ms": wall, "device_ms": device}


def run(system, layout: str, warm: int = 192, runs: int = 20,
        grid_runs: int = 5, warmup: int = 3, log=sys.stderr) -> dict:
    """Warm `system` `warm` steps, then time every stage; returns
    {"setup": ..., "stages": {name: {"wall_ms", "device_ms"}}}."""
    from ngp_pl_torch.device import card_line

    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}: one of {LAYOUTS}")
    if system.layout != layout:
        raise ValueError(f"the system steps in {system.layout}, the stages "
                         f"are asked for in {layout}")
    B = system.tcfg.batch_size
    system.on_train_start()
    print("warming to steady state...", file=log, flush=True)
    m = None
    for _ in range(warm):
        m = system.step()
    setup = {"layout": layout, "batch": B, "warm": warm,
             "pool_mult": system._pool_mult,
             "chain_length": system.chain_length,
             "n_levels": system.cfg.n_levels,
             "n_features": system.cfg.n_features_per_level,
             "card": card_line(system.dev)}
    if m is not None:
        setup.update(rm_s=float(m["rm_samples"]) / B,
                     vr_s=float(m["vr_samples"]) / B)
    print(f"steady: S {setup['pool_mult']} chain {setup['chain_length']} "
          f"rm_s {setup.get('rm_s', 0.0):.1f} "
          f"vr_s {setup.get('vr_s', 0.0):.1f}", file=log, flush=True)
    # the full step first, then the stages from the state it leaves, as the
    # JAX script reads its parameters after timing the step
    stages = {STAGES[0]: timeit(lambda: system.step()["loss"], system.dev,
                                runs=runs, warmup=warmup)}
    fns, m = stage_fns(system, layout, *ray_batch(system))
    setup.update(slots=int(m.ts.numel()), samples=int(m.total))
    for name, fn in fns.items():
        n = grid_runs if name.startswith("grid update") else runs
        stages[name] = timeit(fn, system.dev, runs=n, warmup=warmup)
    for name in STAGES:
        dev_ms = stages[name]["device_ms"]
        print(f"{name:40s} {stages[name]['wall_ms']:8.2f} ms"
              + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms"),
              file=log, flush=True)
    return {"setup": setup, "stages": stages}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", type=str, default="strided", choices=LAYOUTS)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--warm", type=int, default=192)
    ap.add_argument("--n_levels", type=int, default=8)
    ap.add_argument("--n_features", type=int, default=4, choices=[2, 4])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = profile_system(args.device, args.batch, args.layout,
                            n_levels=args.n_levels,
                            n_features=args.n_features)
    rec = run(system, args.layout, warm=args.warm)
    print(json.dumps(rec["setup"]), flush=True)
    print(json.dumps(rec["stages"]), flush=True)
    return rec


if __name__ == "__main__":
    main()
