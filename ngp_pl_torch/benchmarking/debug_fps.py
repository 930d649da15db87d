"""The round renderer's frame round by round, the counterpart of
benchmarking/debug_fps.py.

    python -m ngp_pl_torch.benchmarking.debug_fps [--no_field] [--size 800]
        [--train_steps 1536] [--device cuda]

bench_fps's system trains `--train_steps` steps; its camera looks from
test pose 0.  The frame at T 1e-2 goes through `RoundRenderer` with chunk
65536 and the default 2x ladder, piece by piece: the span pre-pass over
the frame, timed between two fences, then each chunk of the span-culled
rays through the renderer's own round loop, with a fence after every
round.  The JAX script replays its device loop on the host to see the
rounds; here the renderer's loop is a host loop already, so this runs it
and not a copy: the frame's rounds and total samples are those of
`RoundRenderer(chunk=65536)`, and only the fences differ.  `--no_field`
puts sigma 10 and rgb 0.5 in place of the field (`debug_const_field`),
leaving the march and the scheduling.

Per bucket (slots, n_samples): rounds, the fenced seconds of its rounds
(each from the fence after the previous round, the host's loop
included), slot-samples (rounds x slots x n_samples), valid samples,
marched samples (n_eff) and the mean alive count.  On stdout the JAX
script's lines, then a JSON line of the record.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

CHUNK = 65536
TAGS = {False: "full", True: "march-only"}   # the JAX script's, by --no_field


def run(system, size: int = 800, no_field: bool = False, chunk: int = CHUNK,
        emit=print) -> dict:
    """One frame of the trained `system`, round by round; `emit` takes
    the JAX script's lines.  Returns the record (rounds, samples, the
    per-bucket table, seconds, card)."""
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.device import card_line, sync

    dev = system.dev
    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    render = bench_fps.renderer(system.ngp, system.rcfg, dirs, chunk,
                                debug_const_field=no_field)
    occ = system.grid_state.occ_grid
    rays_o, rays_d = get_rays(dirs_t, pose_t)
    rays_o = rays_o.contiguous()
    pixels = size * size

    sync(dev)
    t0 = time.perf_counter()
    t1s, t2s, alive = render.span_pass(occ, rays_o, rays_d)
    idx = alive.nonzero().squeeze(1)
    t_span = time.perf_counter() - t0
    n_alive = idx.numel()
    emit(f"span pass {t_span * 1e3:.1f} ms; alive {n_alive}/{pixels} "
         f"({n_alive / pixels:.1%})")
    emit(f"buckets: {render.buckets}")

    stats = {}
    stamp = [0.0]

    def on_round(bucket, n, valid, n_eff):
        sync(dev)
        dt = time.perf_counter() - stamp[0]
        st = stats.setdefault(bucket[:2], [0, 0.0, 0, 0, 0])
        st[0] += 1
        st[1] += dt
        st[2] += int(valid.sum())
        st[3] += int(n_eff.sum())
        st[4] += n
        stamp[0] = time.perf_counter()

    rounds, total, t_loop = 0, 0, 0.0
    for i in range(0, n_alive, chunk):
        sel = idx[i:i + chunk]
        sync(dev)
        stamp[0] = t0 = time.perf_counter()
        _, _, _, ns, nr = render._render_chunk(
            occ, rays_o[sel], rays_d[sel], t1s[sel], t2s[sel], on_round)
        t_loop += time.perf_counter() - t0
        total += int(ns)
        rounds += nr

    tag = TAGS[no_field]
    emit(f"[{tag}] rounds {rounds} loop {t_loop:.2f}s (+span {t_span:.2f}s; "
         f"a fence after every round)")
    table = []
    for (slots, n_s), (cnt, t, nv, ne, na) in sorted(stats.items()):
        emit(f"  bucket ({slots:6d} x {n_s:2d}): {cnt:4d} rounds "
             f"{t:7.2f}s  slot-samples {cnt * slots * n_s / 1e6:7.1f}M "
             f"valid {nv / 1e6:7.1f}M marched {ne / 1e6:7.1f}M "
             f"avg-alive {na // max(cnt, 1):6d}")
        table.append(dict(slots=slots, n_samples=n_s, rounds=cnt, seconds=t,
                          slot_samples=cnt * slots * n_s, valid=nv,
                          marched=ne, mean_alive=na / max(cnt, 1)))
    return {"tag": tag, "rounds": rounds, "total_samples": total,
            "alive_rays": n_alive, "span_s": t_span, "loop_s": t_loop,
            "chunk": chunk, "buckets": table, "card": card_line(dev)}


def main(argv=None) -> dict:
    from ngp_pl_torch.benchmarking import bench_fps

    ap = argparse.ArgumentParser()
    ap.add_argument("--no_field", action="store_true")        # FPS_NO_FIELD
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--train_steps", type=int, default=1536)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = bench_fps.fps_system(args.device)
    bench_fps.train(system, args.train_steps)
    print("trained", file=sys.stderr, flush=True)
    rec = run(system, args.size, args.no_field,
              emit=lambda line: print(line, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
