"""Render FPS of a briefly trained field at the yardstick's threshold, the
counterpart of benchmarking/bench_fps.py.

    python -m ngp_pl_torch.benchmarking.bench_fps [--size 800] [--frames 5]
        [--train_steps 1536] [--device cuda]

The flagship model (the `TrainConfig` defaults: L=8, F=4, T=2^19, grid
128^3, scale 0.5, batch 8192) trains `train_steps` steps on bench.py's
scene (8 procedural views at 96x96) in 16-step blocks after the camera
marking.  A size x size camera (f = 1.2 W, principal point at the centre)
then looks from the scene's test pose 0, and the round renderer draws it
at T 1e-2: the threshold of the reference's headline FPS (test.ipynb) and
of its viewer, not validation's 1e-4.  One untimed frame warms, then
`frames` frames are timed between two fences.  The JAX script times its
loop without one, since its last call has returned its arrays; here a
render returns before the card has finished, so the fences
(`ngp_pl_torch.device.sync`) are what make the wall time the frames'.

On stdout: one JSON line with the frame time, the K1/K7 launches of the
timed frames and the card, then, last, the JAX script's line
{"metric": "render_fps", "value", "unit", "vs_baseline" (FPS / 36.2, the
reference's 800x800 Lego FPS on an RTX 2080 Ti), "samples_per_ray",
"rounds", "mean_opacity"}, rounded as there.  Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

BASELINE_FPS = 36.2
T_THRESHOLD = 1e-2             # test.ipynb's and the viewer's threshold
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "samples_per_ray",
               "rounds", "mean_opacity")


def fps_system(device: str = "cuda", batch_size: int = 8192, **kw):
    """bench_fps.py's system: bench.py's (`bench.bench_system`) at batch
    8192; `kw` overrides the train configuration."""
    from ngp_pl_torch.benchmarking.bench import bench_system

    return bench_system(device, batch_size, exp_name="bench_fps", **kw)


def train(system, steps: int) -> float:
    """The camera marking, then `steps // grid_update_interval` blocks;
    returns the last block's loss (a host read, so a fence)."""
    system.on_train_start()
    m = None
    for _ in range(steps // system.tcfg.grid_update_interval):
        m = system.step_block()
    return float(m["loss"]) if m is not None else float("nan")


def camera(system, size: int):
    """(directions (size^2, 3) numpy, pose (3, 4) numpy) of the timed
    frame: f = 1.2 W, test pose 0."""
    import numpy as np

    from ngp_pl_torch.datasets.ray_utils import get_ray_directions

    f = 1.2 * size
    K = np.float32([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]])
    return (get_ray_directions(size, size, K),
            system.test_dataset.poses[0])


def frame_chunk(pixels: int) -> int:
    """bench_fps.py's chunk: min(131072, the next power of two of the
    frame's pixels)."""
    return min(131072, 1 << (pixels - 1).bit_length())


def renderer(ngp, rcfg, dirs, chunk: int, **kw):
    """bench_fps.py's round renderer: windows where `segment_march_dmax_ok`
    holds for `dirs`, and `rcfg` with test_t_threshold 1e-2 (the
    counterpart of JAX's `t_threshold=1e-2`); `kw` goes to
    `RoundRenderer` (buckets, debug_const_field, ...)."""
    from ngp_pl_torch.models.rendering import RoundRenderer
    from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok

    return RoundRenderer(
        ngp, dataclasses.replace(rcfg, test_t_threshold=T_THRESHOLD),
        chunk=chunk, use_window=segment_march_dmax_ok(dirs,
                                                      scale=ngp.cfg.scale),
        **kw)


def frame_inputs(system, size: int):
    """(directions (size^2, 3) numpy, directions and pose on the system's
    device) of the timed frame (`camera`)."""
    import torch

    dirs, pose = camera(system, size)
    return (dirs, torch.from_numpy(dirs).to(system.dev),
            torch.from_numpy(pose).to(system.dev))


def timed(render, dev, frames: int):
    """`render()` once untimed (warm), then `frames` times between two
    fences (`ngp_pl_torch.device.sync`).  Returns (seconds a frame, the
    last frame's output, the K1/K7 launches of the timed frames)."""
    from ngp_pl_torch.device import sync
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    out = render()
    counters = {"K1": he.hash_encode_fwd_cuda, "K7": ft.field_tail_cuda}
    before = {k: c.launches for k, c in counters.items()}
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = render()
    sync(dev)
    return ((time.perf_counter() - t0) / frames, out,
            {k: c.launches - before[k] for k, c in counters.items()})


def run(system, size: int = 800, frames: int = 5) -> dict:
    """Time `frames` frames of the trained `system` after a warm one.
    Returns JAX's record (`RECORD_KEYS`, rounded as bench_fps.py rounds
    them) followed by the unrounded fps and frame ms, the K1/K7 launches
    of the timed frames, the card, and the last frame's output (`out`)."""
    from ngp_pl_torch.device import card_line

    dirs, dirs_t, pose_t = frame_inputs(system, size)
    render = renderer(system.ngp, system.rcfg, dirs,
                      frame_chunk(size * size))
    occ = system.grid_state.occ_grid
    dt, out, launches = timed(lambda: render.render_pose(occ, dirs_t, pose_t),
                              system.dev, frames)
    fps = 1.0 / dt
    pixels = size * size
    return {
        "metric": "render_fps",
        "value": round(fps, 2),
        "unit": f"frames/s @ {size}x{size}",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "samples_per_ray": round(out["total_samples"] / pixels, 2),
        "rounds": out["rounds"],
        "mean_opacity": round(float(out["opacity"].mean()), 4),
        "fps": fps, "frame_ms": dt * 1e3, "frames": frames,
        "samples": out["total_samples"], "t_threshold": T_THRESHOLD,
        "launches": launches, "card": card_line(system.dev), "out": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--train_steps", type=int, default=1536)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = fps_system(args.device)
    loss = train(system, args.train_steps)
    print(f"trained {args.train_steps} steps, loss {loss:.6f}",
          file=sys.stderr, flush=True)
    rec = run(system, args.size, args.frames)
    print(json.dumps({k: rec[k] for k in (
        "fps", "frame_ms", "frames", "samples", "t_threshold", "launches",
        "card")}), flush=True)
    print(json.dumps({k: rec[k] for k in RECORD_KEYS}), flush=True)
    return rec


if __name__ == "__main__":
    main()
