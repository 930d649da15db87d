"""Train the field and score the test views (counterpart of train.py;
reference train.py __main__) on a scene on disk (`--dataset_name
nerf|nsvf|colmap|nerfpp|rtmv --root_dir DIR`, read by the port's loaders)
or on the procedural synthetic scene (the default), in the sample layout
of `--train_layout` (auto, the default, as the JAX package's: CSR through
grid warmup, then strided or CSR by the demand; or pinned to csr, strided
or rounds), with `--distortion_loss_w` for the distortion loss.  Runs on the card unless `--device cpu` is given.

    python -m ngp_pl_torch.train --dataset_name nerf \\
        --root_dir data/Synthetic_NeRF/Lego --exp_name Lego
    python -m ngp_pl_torch.train --dataset_name synthetic --num_epochs 1 \\
        --iters_per_epoch 512
    python -m ngp_pl_torch.train --train_layout rounds \\
        --distortion_loss_w 1e-2 --num_epochs 1 --iters_per_epoch 512
    python -m ngp_pl_torch.train --device cpu --n_levels 4 \\
        --log2_hashmap_size 12 --batch_size 256 --downsample 0.1875 \\
        --num_epochs 1 --iters_per_epoch 32
    python -m ngp_pl_torch.train --ckpt_path \\
        ckpts/synthetic/exp/epoch=30.npz --val_only
    python -m ngp_pl_torch.train --use_exposure --optimize_ext \\
        --num_epochs 1 --iters_per_epoch 512

`--use_exposure` trains the HDR head (log-radiance and per-channel
tonemappers; a 4-channel ray store gives each ray its exposure) and
`--optimize_ext` per-image pose corrections of the train views, each alone
or together, in every layout.

The train rays stay on the card when they fit 4 GiB
(`TrainConfig.device_dataset_max_bytes`); a larger store stays on the host
and each batch is drawn there and copied.

`--num_devices N` trains data-parallel over N GPUs of this host, one
process per GPU (NCCL; 0, the default, takes every visible GPU, and a count
above them raises); with `--device cpu` it runs N gloo ranks on the CPU.
The batch is global: each rank takes 1/N of its rays, and the gradients are
averaged before every update.  `--multihost` joins a group started by an
outside launcher instead, from RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT (`python -m torch.distributed.run --nproc_per_node 4 -m
ngp_pl_torch.train --multihost ...`).  Rank 0 alone prints, saves, writes
the TensorBoard record and the GIFs and traces; each rank scores and dumps
its share of the test views (views r, r + N, ...).

    python -m ngp_pl_torch.train --num_devices 4 --num_epochs 1 \\
        --iters_per_epoch 512
    python -m ngp_pl_torch.train --device cpu --num_devices 2 --n_levels 4 \\
        --log2_hashmap_size 12 --batch_size 256 --downsample 0.1875 \\
        --num_epochs 1 --iters_per_epoch 32

Every logged step's train/loss, train/psnr, train/rm_s and train/vr_s go
to a TensorBoard event file in logs/<dataset>/<exp_name>, as the JAX
package writes them (`utils/events.py`; no tensorboard package needed).

`--profile_dir DIR` traces the fit's steps 64-96 with torch.profiler into
DIR/trace_steps64-96.json (Chrome trace format, for viewing).

`--ckpt_path` resumes from a full checkpoint of either package (params,
Adam state, grid state and step) and trains the steps left of
num_epochs x iters_per_epoch; `--val_only` skips training.  After training
it writes a full and a slim checkpoint in the JAX key format to
ckpts/<dataset>/<exp_name>/epoch=<num_epochs>.npz and
epoch=<num_epochs>_slim.npz (`--weight_path` loads the slim kind).  It
then scores the test views and, unless `--no_save_test`, writes them to
results/<dataset>/<exp_name>/NNN.png and their depth to NNN_d.png; on an
NSVF Synthetic scene (`--dataset_name nsvf`, "Synthetic" in --root_dir)
those are then assembled into rgb.gif and depth.gif there, as the JAX
package's GIF fallback for its mp4s (reference train.py:284-293;
`utils/video.py`).
"""
from __future__ import annotations

import argparse
import os
import time

from ngp_pl_torch import parallel
from ngp_pl_torch.config import add_train_args, config_from_args
from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.training.system import NeRFSystem
from ngp_pl_torch.utils.video import write_video


def assemble_videos(val_dir: str) -> list:
    """rgb and depth videos of the validation dumps in `val_dir`, in file
    order (train.py:64-83); returns the paths written."""
    names = sorted(f for f in os.listdir(val_dir) if f.endswith(".png"))
    rgb = [read_png(os.path.join(val_dir, f)) for f in names
           if not f.endswith("_d.png")]
    dep = [read_png(os.path.join(val_dir, f)) for f in names
           if f.endswith("_d.png")]
    return [write_video(os.path.join(val_dir, f"{kind}.mp4"), frames, fps=30)
            for kind, frames in (("rgb", rgb), ("depth", dep)) if frames]


def main(argv=None):
    """Returns (system, scores) of this process's run; (None, None) in the
    process that spawned the ranks of `--num_devices` N > 1."""
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--max_images", type=int, default=None,
                        help="score only the first N test views")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 64-96 "
                        "here (Chrome trace format)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group from RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR and MASTER_PORT (as "
                        "torch.distributed.run sets them)")
    args = parser.parse_args(argv)
    if args.multihost:
        parallel.init_from_env(args.device)
        try:
            out = run(args)
            parallel.barrier()
            return out
        finally:
            parallel.destroy()
    world = parallel.resolve_world(args.num_devices, args.device)
    if world == 1:
        return run(args)
    if args.device != "cpu":
        from ngp_pl_torch import _build

        _build.build()              # once, before the ranks load them
    # by its module's name: the spawned ranks cannot import `__main__.run`
    from ngp_pl_torch import train as entry

    parallel.launch(entry.run, world, (args,), device=args.device)
    return None, None


def run(args):
    """Train and score in this process (a rank of a group, or alone)."""
    tcfg = config_from_args(args)
    system = NeRFSystem(tcfg, device=args.device)
    lead = system.rank == 0
    if tcfg.ckpt_path:
        system.load(tcfg.ckpt_path)
    if not tcfg.val_only:
        t0 = time.time()
        system.fit(max_steps=tcfg.max_steps - system._host_step,
                   profile_dir=args.profile_dir)
        if lead:
            print(f"training took {time.time() - t0:.1f}s")
            ckpt_dir = os.path.join("ckpts", tcfg.dataset_name,
                                    tcfg.exp_name)
            os.makedirs(ckpt_dir, exist_ok=True)
            system.save(os.path.join(ckpt_dir,
                                     f"epoch={tcfg.num_epochs}.npz"))
            system.save_slim(
                os.path.join(ckpt_dir, f"epoch={tcfg.num_epochs}_slim.npz"))
    scores = system.validate(max_images=args.max_images)
    parallel.barrier()                # every rank's dumps are written
    if not lead:
        return system, scores
    print("test: " + " ".join(f"{k}={v:.4f}" for k, v in scores.items()))
    if (not tcfg.no_save_test and tcfg.dataset_name == "nsvf"
            and "Synthetic" in (tcfg.root_dir or "")):
        for path in assemble_videos(
                os.path.join("results", tcfg.dataset_name, tcfg.exp_name)):
            print(f"wrote {path}")
    return system, scores


if __name__ == "__main__":
    main()
