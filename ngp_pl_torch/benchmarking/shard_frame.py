"""A rank of one frame split over ranks at bench_fps's operating point, and
of the eval entry point's rank path (chip_smoke.py's `shard_frame` phase).

`rank_run` runs in each rank of a process group (`parallel.launch`), on
`device` (this rank's card, or the CPU): it
loads a slim checkpoint (rank 0's parameters and grid broadcast), renders
bench_fps's frame (f = 1.2 W, test pose 0, T 1e-2, bench_fps's chunk)
through `RoundRenderer(group=WORLD)` once to warm and `frames` times
fenced (`bench_fps.timed`), then runs `ngp_pl_torch.eval.run` on
`eval_argv`, the function each rank of `eval --num_devices N` runs.  It
counts K1's and K7's launches from 0 at its start, and writes
<out>/shard_rank<r>.pt: the last frame's outputs, rounds and samples, the
fenced frame ms, the collectives a frame, the launches, and the eval's
scores and (on rank 0) printed lines.
"""
from __future__ import annotations

import contextlib
import io
import os

import torch
import torch.distributed as dist


def load_model(cfg, slim: str, dev, group):
    """(NGP, occupancy grid) of a slim checkpoint on `dev`, rank 0's
    broadcast to every rank of `group`."""
    from ngp_pl_torch import parallel
    from ngp_pl_torch.models.ngp import NGP
    from ngp_pl_torch.training.checkpoint import load_slim_checkpoint

    params, occ = load_slim_checkpoint(slim)
    ngp = NGP(cfg, device=dev)
    ngp.load_params(params)
    occ = torch.from_numpy(occ).to(dev)
    parallel.broadcast_([w for _, _, w in ngp._slots()] + [occ],
                        group=group)
    return ngp, occ


def rank_run(out: str, slim: str, cfg, rcfg, dirs, pose, frames: int,
             eval_argv, device: str = "cuda") -> None:
    from ngp_pl_torch import eval as ev
    from ngp_pl_torch.benchmarking import bench_fps
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    counters = {"K1": he.hash_encode_fwd_cuda, "K7": ft.field_tail_cuda}
    for c in counters.values():
        c.launches = 0
    group = dist.group.WORLD
    rank = dist.get_rank(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(device).type == "cuda" else torch.device("cpu"))
    ngp, occ = load_model(cfg, slim, dev, group)
    render = bench_fps.renderer(ngp, rcfg, dirs,
                                bench_fps.frame_chunk(dirs.shape[0]),
                                group=group)
    dirs_t = torch.from_numpy(dirs).to(dev)
    pose_t = torch.from_numpy(pose).to(dev)
    dt, frame, timed = bench_fps.timed(
        lambda: render.render_pose(occ, dirs_t, pose_t), dev, frames)
    frame_launches = {k: c.launches for k, c in counters.items()}
    collectives = render.collectives / (frames + 1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ev.run(ev.parse_args(eval_argv))
    torch.save(dict(
        rank=rank, world=dist.get_world_size(group), frame_ms=dt * 1e3,
        **{k: frame[k].cpu() for k in ("rgb", "depth", "opacity")},
        **{k: frame[k] for k in ("rounds", "total_samples", "alive_rays")},
        collectives_per_frame=collectives, launches_frame=frame_launches,
        launches_timed_frames=timed,
        launches={k: c.launches for k, c in counters.items()},
        eval=dict(psnr=res.psnr, ssim=res.ssim, fps=res.fps,
                  fps_loop=res.fps_loop,
                  fps_loop_samples_per_ray=res.fps_loop_samples_per_ray,
                  lines=buf.getvalue().splitlines())),
        os.path.join(out, f"shard_rank{rank}.pt"))
