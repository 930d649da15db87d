"""Fixture scenes on disk for the port's loader tests: one writer per format
and variant, in the layouts the JAX loaders read (the writers of
tests/test_loaders.py, imported, plus the variants it does not cover).
Images are small PNGs (JPEGs for HDR-NeRF's real captures) of random bytes
from numpy seeds; poses are random rotations (`_some_pose`)."""
from __future__ import annotations

import json
import os
import struct

import numpy as np

from tests.test_loaders import _some_pose, _write_colmap_binary, _write_png


def _rand_img(rng, h, w, c):
    return rng.integers(0, 256, (h, w, c))


def blender(tmp_path, jrender: str = "", h=16, w=16, channels=4):
    """transforms_{train,val,test}.json with RGBA frames; under
    `Jrender_Dataset/<jrender>` when `jrender` names a scene."""
    root = (tmp_path / "Jrender_Dataset" / jrender if jrender
            else tmp_path / "lego")
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for k, (split, n) in enumerate((("train", 3), ("val", 1), ("test", 2))):
        frames = []
        for i in range(n):
            name = f"{split}/r_{i}"
            (root / split).mkdir(exist_ok=True)
            _write_png(root / f"{name}.png", _rand_img(rng, h, w, channels))
            pose4 = np.eye(4, dtype=np.float32)
            pose4[:3] = _some_pose(i + 10 * k)
            frames.append({"file_path": name,
                           "transform_matrix": pose4.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    return str(root)


# NSVF families: (path under tmp_path, intrinsics.txt, image (h, w))
NSVF_FAMILIES = {
    "Synthetic": ("Synthetic_NeRF/Lego", "1111.0 400.0 400.0 0\n0 0 0\n",
                  (8, 8)),
    "BlendedMVS": ("BlendedMVS/Jade",
                   "600 0 384 0\n0 600 288 0\n0 0 1 0\n0 0 0 1\n", (6, 8)),
    "Tanks": ("TanksAndTemple/Barn",
              "1100 0 960 0\n0 1100 540 0\n0 0 1 0\n0 0 0 1\n", (6, 10)),
    "Ignatius": ("TanksAndTemple/Ignatius", "1160.0 960.0 540.0 0\n",
                 (6, 10)),
}


def nsvf(tmp_path, family="Synthetic"):
    sub, intr, (h, w) = NSVF_FAMILIES[family]
    root = tmp_path / sub
    (root / "rgb").mkdir(parents=True)
    (root / "pose").mkdir()
    np.savetxt(root / "bbox.txt", np.array([[-1, -0.5, -1, 1, 1.5, 0.8,
                                             0.1]]))
    with open(root / "intrinsics.txt", "w") as f:
        f.write(intr)
    rng = np.random.default_rng(1)
    for prefix, n in (("0", 3), ("1", 2), ("2", 2)):
        for i in range(n):
            img = _rand_img(rng, h, w, 3)
            if family == "BlendedMVS" and i == 0:
                img[:2] = 10                 # black rows: the Jade lift
            _write_png(root / "rgb" / f"{prefix}_{i:03d}.png", img)
            pose4 = np.eye(4, dtype=np.float32)
            pose4[:3] = _some_pose(10 + 3 * int(prefix) + i)
            np.savetxt(root / "pose" / f"{prefix}_{i:03d}.txt", pose4)
    traj = np.stack([np.eye(4)] * 3)
    traj[:, :3] = np.stack([_some_pose(60 + i) for i in range(3)])
    np.savetxt(root / "test_traj.txt", traj.reshape(-1, 4))
    if family == "Ignatius":
        (root / "test_pose").mkdir()
        for i in range(2):
            np.savetxt(root / "test_pose" / f"{i:03d}.txt", traj[i])
    return str(root)


def nerfpp(tmp_path):
    root = tmp_path / "tat_intermediate_M60"
    rng = np.random.default_rng(2)
    for split, n in (("train", 3), ("val", 1), ("test", 2)):
        for sub in ("rgb", "pose", "intrinsics"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            _write_png(root / split / "rgb" / f"{i:05d}.png",
                       _rand_img(rng, 6, 9, 3))
            pose4 = np.eye(4, dtype=np.float32)
            pose4[:3] = _some_pose(20 + i)
            np.savetxt(root / split / "pose" / f"{i:05d}.txt",
                       pose4.reshape(1, 16))
            K4 = np.eye(4)
            K4[0, 0] = K4[1, 1] = 50.0
            K4[0, 2], K4[1, 2] = 4.5, 3.0
            np.savetxt(root / split / "intrinsics" / f"{i:05d}.txt",
                       K4.reshape(1, 16))
    (root / "camera_path" / "pose").mkdir(parents=True)
    for i in range(4):
        pose4 = np.eye(4)
        pose4[:3, 3] = [0.1 * i, 0.0, -0.5]
        np.savetxt(root / "camera_path" / "pose" / f"{i:05d}.txt",
                   pose4.reshape(1, 16))
    return str(root)


def rtmv(tmp_path, env="bricks"):
    root = tmp_path / env / "scene0"
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(7):
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3] = _some_pose(30 + i).astype(np.float64)
        meta = {"camera_data": {
            "scene_center_3d_box": [0.5, 0, 0],
            "scene_min_3d_box": [-1.5, -2, -2],
            "scene_max_3d_box": [2.5, 2, 2],
            "width": 10, "height": 8,
            "intrinsics": {"fx": 50.0, "fy": 51.0, "cx": 5.0, "cy": 4.0},
            "cam2world": c2w.T.tolist(),
        }}
        with open(root / f"{i:05d}.json", "w") as f:
            json.dump(meta, f)
        _write_png(root / "images" / f"{i:05d}.png", _rand_img(rng, 8, 10, 3))
    return str(root)


def _colmap_poses(n, seed):
    poses_w2c = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3] = _some_pose(seed + i).astype(np.float64)
        c2w[:3, 3] *= 3.0
        poses_w2c.append(np.linalg.inv(c2w)[:3])
    return poses_w2c


def _write_pinhole_cameras(root, w, h):
    """A PINHOLE camera (fx, fy, cx, cy) in place of the writer's
    SIMPLE_PINHOLE."""
    with open(os.path.join(root, "sparse/0/cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<dddd", 90.0, 95.0, w / 2 + 0.3, h / 2 - 0.2))


def colmap(tmp_path, variant="plain"):
    """plain (SIMPLE_PINHOLE), pinhole (PINHOLE camera) or 360_v2 (an
    images_4 folder of quarter-size images beside full-size ones)."""
    root = str(tmp_path / ("360_v2/garden" if variant == "360_v2"
                           else "scene"))
    rng = np.random.default_rng(4)
    n, w, h = 10, 24, 16
    names = [f"im_{i:04d}.png" for i in range(n)]
    # names in shuffled order in the model: the loader sorts them
    order = rng.permutation(n)
    folders = {"images": (h, w)}
    if variant == "360_v2":
        folders["images_4"] = (h // 4, w // 4)
    for folder, (fh, fw) in folders.items():
        os.makedirs(os.path.join(root, folder))
        for name in names:
            _write_png(os.path.join(root, folder, name),
                       _rand_img(rng, fh, fw, 3))
    pts3d = rng.normal(size=(50, 3))
    poses = _colmap_poses(n, 40)
    _write_colmap_binary(root, [poses[i] for i in order],
                         [names[i] for i in order], pts3d, w=w, h=h)
    if variant == "pinhole":
        _write_pinhole_cameras(root, w, h)
    return root


def hdr_nerf(tmp_path, kind="syndata"):
    """HDR-NeRF: `syndata` (scene bathroom; train/*_{0,2,4}.png and
    test/*_{1,3}.png, 18 views) or real (scene box; input_images/*.jpg at
    exposures 0-4, 6 views)."""
    from PIL import Image

    rng = np.random.default_rng(5)
    if kind == "syndata":
        root = tmp_path / "HDR-NeRF" / "syndata" / "bathroom"
        n = 18
        for split, digits in (("train", "024"), ("test", "13")):
            (root / split).mkdir(parents=True)
            for v in range(n):
                for d in digits:
                    _write_png(root / split / f"{v:03d}_{d}.png",
                               _rand_img(rng, 6, 8, 3))
    else:
        root = tmp_path / "HDR-NeRF" / "real" / "box"
        n = 6
        (root / "input_images").mkdir(parents=True)
        for v in range(n):
            for d in "01234":
                Image.fromarray(_rand_img(rng, 6, 8, 3).astype(np.uint8)
                                ).save(root / "input_images" / f"{v:03d}_{d}.jpg",
                                       quality=90)
    names = [f"{v:03d}.png" for v in range(n)]
    _write_colmap_binary(str(root), _colmap_poses(n, 70), names,
                         rng.normal(size=(40, 3)), w=8, h=6)
    return str(root)
