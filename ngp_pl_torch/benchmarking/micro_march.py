"""The windowed train march stage by stage at the bench's shapes, the
counterpart of benchmarking/micro_march.py.

    python -m ngp_pl_torch.benchmarking.micro_march [--device cuda]
        [--n 8192 --chain 896 --grid 128 --pool 262144]

The JAX script's inputs, drawn from `np.random.default_rng(0)` in its
order: a G^3 occupancy grid 8% occupied, N directions about +z from
(0.1, -0.05, -1.6), their box hits, N uniforms of march noise, then an
(N, chain) candidate occupancy 25% set.  Its three stages, under its
names (`STAGES`):
  occ window chain (gather + bit extract)  `_occ_window_chain` from
      t0 = t1 + dt_min * noise (one rounding, as the march takes it)
  compact_to_pool                          `_compact_to_pool` of the 25%
      candidates into the pool
  march_rays_train_window (full)           the whole windowed march
Then the port's own `_compact_to_pool`, step by step (`COMPACT_STEPS`;
the JAX script's stage1 and stage2 have no counterpart here): the per-ray
counts and offsets, the N x K running cumsum, the sorted search of P slots
in it, the staging budget, the positions.  Each step runs alone on what
the steps before it gave.

Each stage and step: the fenced wall ms of 20 calls after 3 (the JAX
script's `timeit`) and, on the card, the device ms of its kernels a call
(`timing.device_ms`).  The table goes to stderr; on stdout a JSON line of
the shapes and the card, then, last, {label: {"wall_ms", "device_ms"}}
(device_ms null on the CPU, where there is no device clock).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

STAGES = ("occ window chain (gather + bit extract)", "compact_to_pool",
          "march_rays_train_window (full)")
COMPACT_STEPS = ("compact: per-ray counts and offsets",
                 "compact: N x K running cumsum",
                 "compact: searchsorted over P slots",
                 "compact: staging budget", "compact: positions")
SCALE = 0.5
MAX_SAMPLES = 1024


def inputs(device: str, N: int = 8192, K: int = 896, G: int = 128,
           pool: int = 262144, seed: int = 0) -> dict:
    """The JAX script's inputs (its `main`), on `device`."""
    from ngp_pl_torch.ops.ray_march import _f32, _fma, occupancy_windows

    rng = np.random.default_rng(seed)
    occ_grid = (rng.random((1, G, G, G)) < 0.08).astype(np.uint8)
    d = rng.normal(size=(N, 3)) * np.float32([0.3, 0.3, 0.1]) + [0, 0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays_o = np.tile(np.float32([[0.1, -0.05, -1.6]]), (N, 1))
    inv = 1.0 / d
    lo = (-SCALE - rays_o) * inv
    hi = (SCALE - rays_o) * inv
    t1 = np.maximum(np.minimum(lo, hi).max(1), 0.01)
    t2 = np.maximum(lo, hi).min(1)
    hits = np.stack([t1, t2], -1).astype(np.float32)
    noise = rng.random(N).astype(np.float32)
    occ25 = rng.random((N, K)) < 0.25
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in dict(occ_grid=occ_grid, rays_o=rays_o, rays_d=d,
                          hits=hits, noise=noise, occ25=occ25).items()}
    dt_min = 3 ** 0.5 / MAX_SAMPLES
    t.update(win_rows=occupancy_windows(t["occ_grid"]),
             t0=_fma(t["noise"], _f32(dt_min), t["hits"][:, 0]),
             N=N, K=K, G=G, pool=pool, dt_min=dt_min)
    return t


def stage_fns(inp: dict) -> dict:
    """The three stages by label, each a call of no arguments."""
    from ngp_pl_torch.ops.ray_march import (
        SEGMENT_J,
        _compact_to_pool,
        _occ_window_chain,
        march_rays_train_window,
    )

    def chain():
        return _occ_window_chain(
            inp["rays_o"], inp["rays_d"], inp["t0"], inp["K"] // SEGMENT_J,
            inp["win_rows"], scale=SCALE, grid_size=inp["G"],
            dt_min=inp["dt_min"])

    return dict(zip(STAGES, (
        chain,
        lambda: _compact_to_pool(inp["occ25"], inp["t0"], MAX_SAMPLES,
                                 inp["pool"], inp["dt_min"]),
        lambda: march_rays_train_window(
            inp["rays_o"], inp["rays_d"], inp["hits"], inp["noise"],
            inp["win_rows"], scale=SCALE, grid_size=inp["G"],
            max_samples=MAX_SAMPLES, pool_size=inp["pool"],
            chain_length=inp["K"]))))


def compact_step_fns(occ, t0, pool: int, dt_min: float) -> dict:
    """`_compact_to_pool`'s steps by label, each a call of no arguments
    on the outputs of the steps before it (computed here once), and the
    last step's output."""
    from ngp_pl_torch.ops import ray_march as rm

    K = occ.shape[1]
    occ_c, rm_counts, offsets, total = rm._pool_counts(occ, MAX_SAMPLES,
                                                       pool)
    running = rm._pool_running(occ_c)
    slot, valid, src = rm._pool_sources(running, total, pool)
    src_b = rm._staging_budget(occ_c, running, slot, src, pool)
    fns = dict(zip(COMPACT_STEPS, (
        lambda: rm._pool_counts(occ, MAX_SAMPLES, pool),
        lambda: rm._pool_running(occ_c),
        lambda: rm._pool_sources(running, total, pool),
        lambda: rm._staging_budget(occ_c, running, slot, src, pool),
        lambda: rm._pool_positions(src_b, valid, t0, K, dt_min))))
    return fns, (*fns[COMPACT_STEPS[-1]](), valid, offsets, total,
                 rm_counts)


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every stage and compaction step timed; returns {label: {"wall_ms",
    "device_ms"}} in order."""
    from ngp_pl_torch.benchmarking.profile_step import timeit

    inp = inputs(device, **shape)
    fns = stage_fns(inp)
    steps, _ = compact_step_fns(inp["occ25"], inp["t0"], inp["pool"],
                                inp["dt_min"])
    fns.update(steps)
    out = {}
    for label, fn in fns.items():
        out[label] = timeit(fn, device, runs=runs, warmup=warmup)
        dev_ms = out[label]["device_ms"]
        print(f"{label:52s} {out[label]['wall_ms']:8.3f} ms"
              + (f"  device {dev_ms:8.3f} ms" if dev_ms is not None else ""),
              file=log, flush=True)
    return out


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--chain", type=int, default=896)
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--pool", type=int, default=262144)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(dict(N=args.n, chain=args.chain, G=args.grid,
                          pool=args.pool, card=card_line(args.device))),
          flush=True)
    rec = run(args.device, N=args.n, K=args.chain, G=args.grid,
              pool=args.pool)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
