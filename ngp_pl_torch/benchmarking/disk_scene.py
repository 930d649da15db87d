"""A Blender-format scene on disk, written from the procedural scene's
ground truth, for the disk loaders' runs (no real scene ships with the
repository).

`write_blender_scene` writes NeRF-Synthetic's layout: `transforms_train.json`
and `transforms_test.json` with `camera_angle_x` and Blender's [right up
back] poses, and one RGBA PNG per view under `train/` and `test/`.  The
cameras are the procedural scene's (radius 1.5, looking at the origin;
`SyntheticDataset`'s poses for `seed`), the focal length its 1.2 x side,
which the Blender loader recovers from `camera_angle_x` for a side of
800 x downsample.  Each view is rendered on `device` by `render_gt` on a
black background, which gives the premultiplied colour and the opacity;
the PNG stores the straight colour and the opacity as alpha, both rounded
to 8 bits, so the loader's blend onto white gives the white-background
ground truth within 1/255.

    python -m ngp_pl_torch.benchmarking.disk_scene DIR --n_train 100 \\
        --n_test 8 --side 800
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

# the procedural scene's focal length over the image side
FOCAL_PER_SIDE = 1.2


def camera_angle_x() -> float:
    """The Blender field whose focal, 0.5 * 800 / tan(angle / 2), is 1.2 x
    800."""
    return 2.0 * math.atan(0.5 / FOCAL_PER_SIDE)


def _render_views(poses, directions, device):
    """(premultiplied rgb, opacity) of each view in turn, on `device`."""
    from ngp_pl_torch.datasets.synthetic import render_gt

    dirs = torch.from_numpy(directions).to(device)
    for pose in poses:
        p = torch.from_numpy(pose).to(device)
        rd = dirs @ p[:, :3].T
        ro = p[:, 3].expand(rd.shape)
        rgb, _, opacity = render_gt(ro.contiguous(), rd.contiguous(), bg=0.0)
        yield rgb, opacity


def _rgba8(rgb: torch.Tensor, opacity: torch.Tensor, side: int) -> np.ndarray:
    straight = torch.where(opacity[:, None] > 0,
                           rgb / opacity.clamp_min(1e-12)[:, None], 0.0)
    rgba = torch.cat([straight.clamp(0, 1), opacity[:, None].clamp(0, 1)], 1)
    return torch.round(rgba * 255).to(torch.uint8).reshape(
        side, side, 4).cpu().numpy()


def write_blender_scene(root: str, n_train: int = 100, n_test: int = 8,
                        side: int = 800, device="cuda", seed: int = 0) -> dict:
    """Write the scene under `root`.  Returns the train views'
    white-background ground truth (n_train, side * side, 3) on `device`,
    the rdf poses of both splits (radius 1.5) and the seconds spent."""
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.utils.images import write_png

    t0 = time.perf_counter()
    angle = camera_angle_x()
    out = {}
    for split, n in (("train", n_train), ("test", n_test)):
        ds = SyntheticDataset(split=split, img_size=side, n_train=n,
                              n_test=n, seed=seed, device=device)
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, gt = [], []
        for i, (rgb, opacity) in enumerate(
                _render_views(ds.poses, ds.directions, ds.device)):
            name = f"./{split}/r_{i}"
            write_png(os.path.join(root, f"{name}.png"),
                      _rgba8(rgb, opacity, side))
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3] = ds.poses[i]
            c2w[:3, 1:3] *= -1                     # rdf -> Blender's rub
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
            if split == "train":
                gt.append(rgb + (1.0 - opacity)[:, None])
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)
        out[f"{split}_poses"] = ds.poses
        if gt:
            out["train_gt"] = torch.stack(gt)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("root")
    parser.add_argument("--n_train", type=int, default=100)
    parser.add_argument("--n_test", type=int, default=8)
    parser.add_argument("--side", type=int, default=800)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    rec = write_blender_scene(args.root, args.n_train, args.n_test,
                              args.side, args.device)
    print(json.dumps({"root": args.root, "seconds": rec["seconds"]}))


if __name__ == "__main__":
    main()
