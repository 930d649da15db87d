"""Bucket ladders of the round renderer at the yardstick's frame, the
counterpart of benchmarking/fps_sweep.py.

    python -m ngp_pl_torch.benchmarking.fps_sweep [--size 800]
        [--train_steps 1536] [--frames 5] [--device cuda]

bench_fps's system trains `--train_steps` steps; its camera looks from
test pose 0.  The frame at T 1e-2 then goes through `RoundRenderer` (chunk
131,072, as the JAX script's renderer) with each ladder of `CONFIGS`, the
JAX script's five at C = 131,072: the default, the chains cut to 128 and
96, n_samples starting at 16, and both.  Each is warmed by one frame, then
`--frames` frames are timed between two fences: FPS, ms a frame, rounds,
samples per ray.  On stdout the JAX script's lines, then a JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

from ngp_pl_torch.models.rendering import ladder

C = 131072


def configs(chunk: int = C) -> dict:
    """The JAX script's ladders by name, in its order (None: the
    renderer's default)."""
    return {"default": None,
            "chain128": ladder(chunk, first_chain=128, chain=128),
            "chain96": ladder(chunk, first_chain=128, chain=96),
            "s16": ladder(chunk, s0=16, first_chain=128),
            "s16_chain96": ladder(chunk, s0=16, first_chain=96, chain=96)}


def run(system, size: int = 800, frames: int = 5, chunk: int = C,
        emit=print) -> dict:
    """Every ladder on the trained `system`'s frame; `emit` takes the JAX
    script's lines.  Returns {"configs": {name: record}, "card"}."""
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.device import card_line

    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    occ = system.grid_state.occ_grid
    pixels = size * size
    recs = {}
    for name, buckets in configs(chunk).items():
        render = bench_fps.renderer(system.ngp, system.rcfg, dirs, chunk,
                                    buckets=buckets)
        dt, out, launches = bench_fps.timed(
            lambda: render.render_pose(occ, dirs_t, pose_t), system.dev,
            frames)
        spr = out["total_samples"] / pixels
        emit(f"{name:14s} {1.0 / dt:6.3f} FPS  {dt * 1e3:7.1f} ms "
             f"rounds {out['rounds']:3d} s/ray {spr:5.2f}")
        recs[name] = dict(fps=1.0 / dt, frame_ms=dt * 1e3,
                          rounds=out["rounds"], samples_per_ray=spr,
                          buckets=render.buckets, launches=launches,
                          finite=bool(out["rgb"].isfinite().all()))
    return {"configs": recs, "size": size, "timed_frames": frames,
            "card": card_line(system.dev)}


def main(argv=None) -> dict:
    from ngp_pl_torch.benchmarking import bench_fps

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--train_steps", type=int, default=1536)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = bench_fps.fps_system(args.device)
    bench_fps.train(system, args.train_steps)
    print("trained", file=sys.stderr, flush=True)
    rec = run(system, args.size, args.frames,
              emit=lambda line: print(line, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
