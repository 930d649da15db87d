"""The round renderer's frame split into the field and the rest, the
counterpart of benchmarking/fps_ablate.py.

    python -m ngp_pl_torch.benchmarking.fps_ablate [--size 800]
        [--train_steps 1536] [--frames 4] [--device cuda]

bench_fps's system trains `--train_steps` steps and its camera looks from
test pose 0 (`bench_fps.fps_system`, `train`, `camera`).  Then the same
frame is drawn twice at T 1e-2 through `RoundRenderer`, as bench_fps
draws it: `full`, and `const-field`, where sigma 10 and rgb 0.5 stand in
for the field (`debug_const_field`: the march, the rounds' scheduling and
the compositor, without K1 and K7).  Each is warmed by one frame, then
`--frames` frames are timed between two fences.  The difference of the
two frame times over the full one is the field's share of the frame (the
rounds differ too: a constant field of sigma 10 ends rays elsewhere, so
the share is the JAX script's estimate, not a partition).

On stdout the JAX script's lines (`TAGS`, then "field share ~="), then a
JSON line with both frames' ms, samples per ray, rounds, alive rays and
K1/K7 launches, and the card.
"""
from __future__ import annotations

import argparse
import json
import sys

TAGS = ("full", "const-field")   # the JAX script's frames, in its order


def run(system, size: int = 800, frames: int = 4, emit=print) -> dict:
    """Both frames of the trained `system`; `emit` takes the JAX script's
    lines.  Returns {"frames": {tag: record}, "field_share", "card"}."""
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.device import card_line

    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    occ = system.grid_state.occ_grid
    pixels = size * size
    recs = {}
    for tag in TAGS:
        render = bench_fps.renderer(
            system.ngp, system.rcfg, dirs, bench_fps.frame_chunk(pixels),
            debug_const_field=tag == "const-field")
        dt, out, launches = bench_fps.timed(
            lambda: render.render_pose(occ, dirs_t, pose_t), system.dev,
            frames)
        recs[tag] = dict(frame_ms=dt * 1e3,
                         samples_per_ray=out["total_samples"] / pixels,
                         rounds=out["rounds"], alive_rays=out["alive_rays"],
                         launches=launches,
                         finite=bool(out["rgb"].isfinite().all()))
        emit(f"{tag:14s} {dt * 1e3:8.1f} ms/frame  samples/ray "
             f"{out['total_samples'] / pixels:6.2f} rounds {out['rounds']} "
             f"alive {out['alive_rays']}")
    full, const = (recs[t]["frame_ms"] for t in TAGS)
    share = (full - const) / full
    emit(f"field share ~= {share:.1%} ({full - const:.0f} ms)")
    return {"frames": recs, "field_share": share, "size": size,
            "timed_frames": frames, "card": card_line(system.dev)}


def main(argv=None) -> dict:
    from ngp_pl_torch.benchmarking import bench_fps

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=800)         # FPS_SIZE
    ap.add_argument("--train_steps", type=int, default=1536)  # FPS_TRAIN_STEPS
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = bench_fps.fps_system(args.device)
    bench_fps.train(system, args.train_steps)
    print(f"trained {args.train_steps}", file=sys.stderr, flush=True)
    rec = run(system, args.size, args.frames,
              emit=lambda line: print(line, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
