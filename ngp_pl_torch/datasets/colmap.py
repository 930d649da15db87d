"""COLMAP-reconstruction loader incl. HDR-NeRF exposure handling (counterpart
of ngp_pl_tpu/datasets/colmap.py; behavioral
spec: reference datasets/colmap.py — sparse/0 binary model, pose centering
against the point cloud, min-camera-distance scale, every-8th test split,
HDR-NeRF split/exposure conventions).

Structured as a declarative SceneManifest (see datasets/manifest.py): pose
normalization happens once up front (centering needs the whole pose set plus
the point cloud, so it cannot be a per-frame WorldMap), and the split logic
reduces to index/glob selection tables feeding Frame rows.
"""
from __future__ import annotations

import os

import numpy as np

from ngp_pl_torch.datasets.base import BaseDataset
from ngp_pl_torch.datasets.colmap_utils import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from ngp_pl_torch.datasets.manifest import (
    Frame,
    SceneManifest,
    install,
    pinhole_K,
    sorted_glob,
)
from ngp_pl_torch.datasets.ray_utils import center_poses, create_spheric_poses

# per-scene HDR-NeRF exposure tables: shutter value by file-name digit
# (reference colmap.py:135-151)
_HDR_EXPOSURES = {
    **{s: {e: 1 / 8 * 4 ** e for e in range(5)}
       for s in ("bathroom", "bear", "chair", "desk")},
    **{s: {e: 1 / 16 * 4 ** e for e in range(5)}
       for s in ("diningroom", "dog")},
    "sofa": {0: 0.25, 1: 1, 2: 2, 3: 4, 4: 16},
    "sponza": {0: 0.5, 1: 2, 2: 4, 3: 8, 4: 32},
    "box": {0: 2 / 3, 1: 1 / 3, 2: 1 / 6, 3: 0.1, 4: 0.05},
    "computer": {0: 1 / 3, 1: 1 / 8, 2: 1 / 15, 3: 1 / 30, 4: 1 / 60},
    "flower": {0: 1 / 3, 1: 1 / 6, 2: 0.1, 3: 0.05, 4: 1 / 45},
    "luckycat": {0: 2, 1: 1, 2: 0.5, 3: 0.25, 4: 0.125},
}

# focal/center parameter slots per COLMAP camera model
_CAM_MODELS = {
    "SIMPLE_RADIAL": (0, 0, 1, 2), "SIMPLE_PINHOLE": (0, 0, 1, 2),
    "PINHOLE": (0, 1, 2, 3), "OPENCV": (0, 1, 2, 3),
}


def _intrinsics(root: str, downsample: float):
    cams = read_cameras_binary(os.path.join(root, "sparse/0/cameras.bin"))
    cam = cams[min(cams)]
    if cam.model not in _CAM_MODELS:
        raise ValueError(
            f"Please parse the intrinsics for camera model {cam.model}!")
    ifx, ify, icx, icy = _CAM_MODELS[cam.model]
    p = cam.params
    K = pinhole_K(p[ifx] * downsample, p[ify] * downsample,
                  p[icx] * downsample, p[icy] * downsample)
    return K, (int(cam.width * downsample), int(cam.height * downsample))


def _normalized_poses(root: str):
    """All c2w poses (name-sorted) centered against the point cloud and
    scaled so the nearest camera sits at distance 1 (colmap.py:60-76)."""
    imdata = read_images_binary(os.path.join(root, "sparse/0/images.bin"))
    names = [imdata[k].name for k in imdata]
    w2c = np.stack([
        np.concatenate([
            np.concatenate([imdata[k].qvec2rotmat(),
                            imdata[k].tvec.reshape(3, 1)], 1),
            [[0, 0, 0, 1.0]]], 0)
        for k in imdata])
    poses = np.linalg.inv(w2c)[np.argsort(names), :3]

    pts_raw = read_points3d_binary(os.path.join(root, "sparse/0/points3D.bin"))
    pts3d = np.array([pts_raw[k].xyz for k in pts_raw])

    poses, pts3d = center_poses(poses, pts3d)
    scale = np.linalg.norm(poses[..., 3], axis=-1).min()
    poses[..., 3] /= scale
    return poses.astype(np.float32), pts3d / scale, sorted(names)


def _every_8th(n: int, split: str):
    """Index selection: every 8th view is test (colmap.py:118-124)."""
    if split == "train":
        return [i for i in range(n) if i % 8 != 0]
    if split == "test":
        return [i for i in range(n) if i % 8 == 0]
    return list(range(n))


def _hdr_selection(root: str, split: str, poses: np.ndarray):
    """HDR-NeRF image paths + matching (repeated) poses + unit exposure
    (reference colmap.py:84-156: each viewpoint is captured at several
    shutter values, so poses repeat per exposure bracket)."""
    if "syndata" in root:               # synthetic captures
        unit = 0.73
        if split == "train":
            imgs = sorted_glob(root, "train/*[024].png")
            poses = np.repeat(poses[-18:], 3, 0)
        elif split == "test":
            imgs = sorted_glob(root, "test/*[13].png")
            poses = np.repeat(poses[:17], 2, 0)
        else:
            raise ValueError(f"split {split} is invalid for HDR-NeRF!")
    else:                               # real captures
        unit = 0.5
        base = os.path.join(root, "input_images")
        if split == "train":
            imgs = sum((sorted_glob(base, f"*{d}.jpg")[::2]
                        for d in "024"), [])
            poses = np.tile(poses[::2], (3, 1, 1))
        elif split == "test":
            imgs = sum((sorted_glob(base, f"*{d}.jpg")[1::2]
                        for d in "13"), [])
            poses = np.tile(poses[1::2], (2, 1, 1))
        else:
            raise ValueError(f"split {split} is invalid for HDR-NeRF!")
    e_table = _HDR_EXPOSURES[os.path.basename(os.path.normpath(root))]
    exposures = [e_table[int(p.split(".")[0][-1])] for p in imgs]
    return imgs, poses, exposures, unit


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, device="cuda",
                 **kwargs):
        super().__init__(root_dir, split, downsample, device)
        K, img_wh = _intrinsics(root_dir, downsample)

        frames = []
        if kwargs.get("read_meta", True):
            poses, self.pts3d, names = _normalized_poses(root_dir)
            if split == "test_traj":
                # spheric render path around the scene (colmap.py:79-82)
                traj = create_spheric_poses(1.2, poses[:, 1, 3].mean())
                frames = [Frame(pose=p.astype(np.float32)) for p in traj]
            elif "HDR-NeRF" in root_dir:
                imgs, poses, exposures, unit = _hdr_selection(
                    root_dir, split, poses)
                self.unit_exposure_rgb = unit
                frames = [Frame(pose=p, image=img, exposure=e)
                          for p, img, e in zip(poses, imgs, exposures)]
            else:
                # mipnerf360 ships pre-downsampled image directories
                folder = (f"images_{int(1 / downsample)}"
                          if "360_v2" in root_dir and downsample < 1
                          else "images")
                keep = _every_8th(len(names), split)
                frames = [Frame(pose=poses[i],
                                image=os.path.join(root_dir, folder, names[i]))
                          for i in keep]

        install(self, SceneManifest(
            K=K, img_wh=img_wh, frames=frames,
            blend_alpha=False,          # real captures: no alpha blending
        ))
