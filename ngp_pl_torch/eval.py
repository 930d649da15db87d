"""Render and score the test views and, with --mesh_path, extract the
density field's isosurface (counterpart of eval.py; reference test.ipynb).

Without --weight_path it builds the seeded model and its occupancy grid the
way a fresh training system does: cells no train camera sees are marked
invisible, then one warmup density refresh over every cell.  With
--weight_path it loads a slim checkpoint in the JAX package's key format.
Each test view is rendered through the round renderer and scored with
PSNR/SSIM against the scene's ground truth; FPS is frames over the fenced
wall time of the scored renders, after one untimed warm-up frame.  Then,
as the root eval.py's timing loop (:45-62; test.ipynb), test pose 0 is
rendered once more to warm and --fps_frames (5) times, each frame fenced;
its FPS is `EvalResult.fps_loop` and the JAX script's line "render: X FPS
at WxH (S samples/ray)".  With
--mesh_path the density is queried on a --mesh_resolution^3 lattice over
the scene box (`NGP.density`, so K1, or K3 at F=2, on the card) and the
surface at sigma = --mesh_threshold is written as OBJ (a path ending in
.obj) or PLY by `utils/mesh.py`'s marching tetrahedra.  A
disk scene (`--dataset_name nerf|nsvf|colmap|nerfpp|rtmv --root_dir DIR`)
is read by the port's loaders, its test split scored and the train split
(`--split`) marking the grid when no weights are given.

    python -m ngp_pl_torch.eval --dataset_name synthetic --downsample 6.25
    python -m ngp_pl_torch.eval --dataset_name nerf --root_dir DIR \
        --weight_path ckpts/nerf/exp/epoch=30_slim.npz
    python -m ngp_pl_torch.eval --weight_path \
        ckpts/synthetic/exp/epoch=30_slim.npz --mesh_path mesh.ply \
        --mesh_resolution 256

With `--num_devices N` (0, the default, is every visible GPU, as the JAX
eval.py's mesh over every device; with `--device cpu`, gloo ranks and 0
is one) every view and every frame of the FPS loop is rendered by N ranks
at once, one process per GPU (`RoundRenderer(group=...)`, the JAX
renderer's `mesh=`): rank 0's parameters and grid are broadcast, each
rank renders its share of each chunk's rays, and every rank gets the
whole frame.  Rank 0 scores, prints and writes the mesh; a frame's fenced
time ends when every rank has it (the frame's last all-gather).  One rank
runs in this process with no process group.  `--multihost` joins a group
started by an outside launcher (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`).

    python -m ngp_pl_torch.eval --weight_path SLIM --num_devices 4
    python -m ngp_pl_torch.eval --device cpu --num_devices 2 \
        --downsample 0.125 --n_levels 4 --log2_hashmap_size 12
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ngp_pl_torch import parallel
from ngp_pl_torch.config import (
    MAX_SAMPLES,
    TrainConfig,
    add_eval_args,
    config_from_args,
)
from ngp_pl_torch.datasets import dataset_dict
from ngp_pl_torch.device import resolve_device, sync
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.occupancy import (
    init_grid_state,
    mark_invisible_cells,
    update_density_grid,
)
from ngp_pl_torch.models.rendering import RoundRenderer
from ngp_pl_torch.ops.ray_march import window_march_mc_ok
from ngp_pl_torch.training.checkpoint import load_slim_checkpoint
from ngp_pl_torch.training.metrics import psnr, ssim
from ngp_pl_torch.utils.mesh import (
    density_grid_query,
    marching_tetrahedra,
    save_mesh_obj,
    save_mesh_ply,
    to_world,
)

# occupancy threshold 0.01 * MAX_SAMPLES / sqrt(3) (reference train.py:160)
DENSITY_THRESHOLD = 0.01 * MAX_SAMPLES / math.sqrt(3.0)


# frames of the timing loop on test pose 0 (the root eval.py's default)
FPS_FRAMES = 5


@dataclass
class EvalResult:
    psnr: float
    ssim: float
    fps: float
    samples_per_ray: float
    rounds_per_frame: float
    images: List[torch.Tensor]      # (H, W, 3) per view
    opacities: List[torch.Tensor]   # (H, W) per view
    ngp: NGP
    occ_grid: torch.Tensor
    mesh: Optional[Dict] = None     # `write_mesh`'s record, --mesh_path
    fps_loop: Optional[float] = None     # the --fps_frames loop's FPS
    fps_loop_samples_per_ray: Optional[float] = None


@torch.no_grad()
def evaluate(tcfg: TrainConfig, device="cuda",
             max_images: Optional[int] = None,
             fps_frames: int = FPS_FRAMES, group=None) -> EvalResult:
    """Every rank of `group` (a process group, None for one process) runs
    this with the same arguments and gets the same result."""
    dev = resolve_device(device)
    if group is not None and dev.type == "cuda":       # this rank's card
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg, rcfg = tcfg.ngp_config(), tcfg.render_config()
    ds_cls = dataset_dict[tcfg.dataset_name]
    kw = dict(root_dir=tcfg.root_dir, downsample=tcfg.downsample, device=dev)
    test_ds = ds_cls(split="test", **kw)

    ngp = NGP(cfg, seed=tcfg.seed, device=dev)
    if tcfg.weight_path:
        params, occ = load_slim_checkpoint(tcfg.weight_path)
        ngp.load_params(params)
        occ_grid = torch.from_numpy(occ).to(dev)
    else:
        train_ds = ds_cls(split=tcfg.split, **kw)
        state = mark_invisible_cells(
            init_grid_state(cfg, dev), train_ds.K, train_ds.poses, cfg=cfg,
            img_w=train_ds.img_wh[0], img_h=train_ds.img_wh[1])
        state = update_density_grid(
            ngp, state, DENSITY_THRESHOLD,
            generator=torch.Generator().manual_seed(tcfg.seed))
        occ_grid = state.occ_grid
    if group is not None:
        parallel.broadcast_([w for _, _, w in ngp._slots()] + [occ_grid],
                            group=group)

    # the windows of the JAX system's test renderer (system.py:78-89); one
    # cascade with uniform steps reads the grid, whose bits they equal
    renderer = RoundRenderer(ngp, rcfg, use_window=window_march_mc_ok(
        test_ds.directions, cfg.exp_step_factor, cfg.cascades), group=group)
    dirs = torch.from_numpy(test_ds.directions).to(dev)
    w, h = test_ds.img_wh
    n = len(test_ds.poses) if max_images is None else min(
        max_images, len(test_ds.poses))
    renderer.render_pose(occ_grid, dirs,
                         torch.from_numpy(test_ds.poses[0]).to(dev))
    psnrs, ssims, images, opacities = [], [], [], []
    seconds, samples, rounds = 0.0, 0, 0
    for idx in range(n):
        item = test_ds.test_item(idx)
        pose = torch.from_numpy(item["pose"]).to(dev)
        sync(dev)
        t0 = time.perf_counter()
        out = renderer.render_pose(occ_grid, dirs, pose)
        sync(dev)
        seconds += time.perf_counter() - t0
        samples += out["total_samples"]
        rounds += out["rounds"]
        pred = out["rgb"].reshape(h, w, 3)
        if "rgb" in item:            # a pose-only split renders unscored
            gt = item["rgb"].reshape(h, w, 3)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred, gt)))
        images.append(pred)
        opacities.append(out["opacity"].reshape(h, w))
    scored = len(psnrs) or math.nan
    res = EvalResult(
        psnr=sum(psnrs) / scored, ssim=sum(ssims) / scored, fps=n / seconds,
        samples_per_ray=samples / (n * w * h), rounds_per_frame=rounds / n,
        images=images, opacities=opacities, ngp=ngp, occ_grid=occ_grid)
    if fps_frames > 0:
        # the root eval.py:45-62: test pose 0, one warm frame, then
        # `fps_frames` frames, each ending in a fence
        pose = torch.from_numpy(test_ds.poses[0]).to(dev)
        renderer.render_pose(occ_grid, dirs, pose)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(fps_frames):
            out = renderer.render_pose(occ_grid, dirs, pose)
            sync(dev)
        res.fps_loop = fps_frames / (time.perf_counter() - t0)
        res.fps_loop_samples_per_ray = out["total_samples"] / (w * h)
    return res


@torch.no_grad()
def write_mesh(ngp: NGP, path: str, resolution: int, level: float) -> Dict:
    """The isosurface of `ngp`'s density at `level` on a resolution^3
    lattice over [-scale, scale]^3, written to `path` (OBJ if it ends in
    .obj, else PLY).  Returns the density grid, the world-space verts and
    faces (on the model's device) and the fenced seconds of the density
    query and of the march."""
    dev = ngp.hash_table.device
    scale = ngp.cfg.scale
    sync(dev)
    t0 = time.perf_counter()
    values = density_grid_query(ngp.density, resolution, scale, device=dev)
    sync(dev)
    t1 = time.perf_counter()
    verts, faces = marching_tetrahedra(values, level)
    verts = to_world(verts, resolution, scale)
    sync(dev)
    t2 = time.perf_counter()
    save = save_mesh_obj if path.endswith(".obj") else save_mesh_ply
    save(path, verts, faces)
    return dict(values=values, verts=verts, faces=faces, query_s=t1 - t0,
                march_s=t2 - t1)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    add_eval_args(parser)
    parser.add_argument("--max_images", type=int, default=None,
                        help="score only the first N test views")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fps_frames", type=int, default=FPS_FRAMES,
                        help="frames of the FPS timing loop on test pose 0 "
                        "(test.ipynb); 0 skips it")
    parser.add_argument("--mesh_path", type=str, default=None,
                        help="write an OBJ/PLY isosurface mesh here")
    parser.add_argument("--mesh_resolution", type=int, default=256)
    parser.add_argument("--mesh_threshold", type=float, default=20.0,
                        help="sigma iso level (test.ipynb uses ~20)")
    parser.add_argument("--num_devices", type=int,
                        default=TrainConfig().num_devices,
                        help="ranks that render each frame together, one "
                        "process per GPU; 0 = every visible GPU (with "
                        "--device cpu: gloo ranks, 0 = one)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group from RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR and MASTER_PORT (as "
                        "torch.distributed.run sets them)")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns this process's `EvalResult`; None in the process that
    spawned the ranks of `--num_devices` N > 1."""
    args = parse_args(argv)
    if args.multihost:
        parallel.init_from_env(args.device)
        try:
            res = run(args)
            parallel.barrier()
            return res
        finally:
            parallel.destroy()
    world = parallel.resolve_world(args.num_devices, args.device)
    if world == 1:
        return run(args)
    if args.device != "cpu":
        from ngp_pl_torch import _build

        _build.build()              # once, before the ranks load them
    # by its module's name: the spawned ranks cannot import `__main__.run`
    from ngp_pl_torch import eval as entry

    parallel.launch(entry.run, world, (args,), device=args.device)
    return None


def run(args) -> EvalResult:
    """Evaluate in this process: a rank of the default process group, or
    alone; the lead (rank 0, or the one process) prints."""
    import torch.distributed as dist

    tcfg = config_from_args(args)
    group = dist.group.WORLD if parallel.active() else None
    res = evaluate(tcfg, device=args.device, max_images=args.max_images,
                   fps_frames=args.fps_frames, group=group)
    if parallel.rank() != 0:
        return res
    h, w = res.images[0].shape[:2]
    print(f"test: psnr={res.psnr:.4f} ssim={res.ssim:.4f}")
    print(f"views: {res.fps:.2f} FPS at {w}x{h} "
          f"({res.samples_per_ray:.1f} samples/ray, "
          f"{res.rounds_per_frame:.1f} rounds/frame)")
    if res.fps_loop is not None:
        print(f"render: {res.fps_loop:.2f} FPS at {w}x{h} "
              f"({res.fps_loop_samples_per_ray:.1f} samples/ray)")
    if args.mesh_path:
        res.mesh = write_mesh(res.ngp, args.mesh_path, args.mesh_resolution,
                              args.mesh_threshold)
        m = res.mesh
        print(f"mesh: {len(m['verts'])} verts {len(m['faces'])} faces "
              f"-> {args.mesh_path} (density query {m['query_s']:.2f} s, "
              f"march {m['march_s']:.2f} s)")
    return res


if __name__ == "__main__":
    main()
