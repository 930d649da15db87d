"""Bucket schedules of the round renderer, and the one-pass renderer, at
the yardstick's frame: the counterpart of benchmarking/tune_fps.py.

    python -m ngp_pl_torch.benchmarking.tune_fps [--only NAME] [--oneshot]
        [--size 800] [--device cuda]

The first run trains bench_fps's system 1536 steps and saves its slim
checkpoint as build/tune_fps/_tune_fps_slim.npz; later runs load it.  The
frame of test pose 0 at T 1e-2 then goes, after one warm frame, once
between two fences through `RoundRenderer` (chunk 131,072) with each of the
JAX script's four schedules (`CANDIDATES`; `--only NAME` runs one; its
"default(4x,S4)" is the renderer's default ladder, as in the JAX script,
whose name outlived the ladder it named), or with `--oneshot` through
`TestRenderer` at each of the JAX script's (chunk, pool multiplier, chain)
(`ONESHOT`), windowed where `segment_march_dmax_ok` holds.  On stdout the
JAX script's lines, then a JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "tune_fps", "_tune_fps_slim.npz")
CANDIDATES = {
    "default(4x,S4)": None,
    "2x ladder S8": [(65536, 8, 256), (32768, 16, 128), (16384, 16, 128),
                     (8192, 32, 128), (4096, 64, 128), (2048, 64, 128),
                     (1024, 64, 128), (512, 64, 128)],
    "2x ladder S16": [(65536, 16, 256), (32768, 16, 128), (16384, 32, 128),
                      (8192, 32, 128), (4096, 64, 128), (2048, 64, 128),
                      (1024, 64, 128), (512, 64, 128)],
    "flat S32": [(65536, 32, 256), (32768, 32, 128), (16384, 32, 128),
                 (8192, 32, 128), (4096, 32, 128), (1024, 64, 128)],
}
ONESHOT = ((16384, 32, 1152), (32768, 32, 1152), (16384, 48, 1152),
           (32768, 32, 896))
CHUNK = 131072                 # the JAX renderer's default chunk


def system_from(ckpt: str, device: str):
    """bench_fps's system with the slim checkpoint's parameters and grid
    (written by the first run: 1536 steps, then saved)."""
    import torch

    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.ops.ray_march import occupancy_windows
    from ngp_pl_torch.training.checkpoint import load_slim_checkpoint

    system = bench_fps.fps_system(device)
    if not os.path.exists(ckpt):
        bench_fps.train(system, 1536)
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        system.save_slim(ckpt)
        print("trained + saved", file=sys.stderr, flush=True)
        return system
    params, grid = load_slim_checkpoint(ckpt)
    system.ngp.load_params(params)
    occ = torch.from_numpy(grid).to(system.dev)
    system.grid_state = dataclasses.replace(
        system.grid_state, occ_grid=occ, win_rows=occupancy_windows(occ))
    print("loaded checkpoint", file=sys.stderr, flush=True)
    return system


def run(system, size: int = 800, only=None, emit=print) -> dict:
    """Each schedule (or `only`) on the `system`'s frame, one fenced frame
    after a warm one; `emit` takes the JAX script's lines."""
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.device import card_line

    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    occ = system.grid_state.occ_grid
    pixels = size * size
    recs = {}
    for name, buckets in CANDIDATES.items():
        if only and only != name:
            continue
        render = bench_fps.renderer(system.ngp, system.rcfg, dirs, CHUNK,
                                    buckets=buckets)
        dt, out, launches = bench_fps.timed(
            lambda: render.render_pose(occ, dirs_t, pose_t), system.dev, 1)
        spr = out["total_samples"] / pixels
        emit(f"{name:18s} {dt * 1e3:8.0f} ms/frame  {1.0 / dt:6.2f} fps  "
             f"rounds {out['rounds']} samples/ray {spr:.1f}")
        recs[name] = dict(frame_ms=dt * 1e3, fps=1.0 / dt,
                          rounds=out["rounds"], samples_per_ray=spr,
                          launches=launches,
                          finite=bool(out["rgb"].isfinite().all()))
    return {"schedules": recs, "size": size, "card": card_line(system.dev)}


def run_oneshot(system, size: int = 800, configs=ONESHOT,
                emit=print) -> dict:
    """`TestRenderer` at each (chunk, pool multiplier, chain) on the
    `system`'s frame, one fenced frame after a warm one."""
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.device import card_line
    from ngp_pl_torch.models.rendering import TestRenderer
    from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok

    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    rays_o, rays_d = get_rays(dirs_t, pose_t)
    rays_o = rays_o.contiguous()
    occ = system.grid_state.occ_grid
    window = segment_march_dmax_ok(dirs, scale=system.cfg.scale)
    pixels = size * size
    recs = []
    for chunk, pm, chain in configs:
        render = TestRenderer(system.ngp, system.rcfg, chunk=chunk,
                              pool_mult=pm, use_window=window,
                              chain_length=chain,
                              t_threshold=bench_fps.T_THRESHOLD)
        dt, out, launches = bench_fps.timed(
            lambda: render.render_image(occ, rays_o, rays_d), system.dev, 1)
        spr = out["total_samples"] / pixels
        emit(f"one-shot csr chunk {chunk} x{pm} chain {chain}: "
             f"{dt * 1e3:7.0f} ms/frame {1.0 / dt:6.2f} fps "
             f"samples/ray {spr:.1f}")
        recs.append(dict(chunk=chunk, pool_mult=pm, chain=chain,
                         frame_ms=dt * 1e3, fps=1.0 / dt,
                         samples_per_ray=spr, launches=launches,
                         finite=bool(out["rgb"].isfinite().all())))
    return {"oneshot": recs, "window": window, "size": size,
            "card": card_line(system.dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default=None)          # ONLY
    ap.add_argument("--oneshot", action="store_true")          # ONESHOT
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--ckpt", type=str, default=CKPT)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = system_from(args.ckpt, args.device)
    emit = lambda line: print(line, flush=True)   # noqa: E731
    rec = (run_oneshot(system, args.size, emit=emit) if args.oneshot
           else run(system, args.size, args.only, emit=emit))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
