"""RTMV format (counterpart of ngp_pl_tpu/datasets/rtmv.py; behavioral spec:
reference datasets/rtmv.py — per-frame JSON
camera_data blocks, images/ directory, frame-index train/test split
0-100 / 105-150, scene-box normalization for the `bricks` environment).

Structured as a declarative SceneManifest (see datasets/manifest.py).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ngp_pl_torch.datasets.base import BaseDataset
from ngp_pl_torch.datasets.manifest import (
    Frame,
    SceneManifest,
    WorldMap,
    install,
    pinhole_K,
    sorted_glob,
)

# [start, end) frame indices per split (reference rtmv.py:48-51)
_SPLIT_RANGE = {"train": (0, 100), "trainval": (0, 105), "test": (105, 150)}


def _camera_data(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["camera_data"]


class RTMVDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, device="cuda",
                 **kwargs):
        super().__init__(root_dir, split, downsample, device)
        meta = _camera_data(os.path.join(root_dir, "00000.json"))
        intr = meta["intrinsics"]
        w = int(meta["width"] * downsample)
        h = int(meta["height"] * downsample)
        K = pinhole_K(intr["fx"] * downsample, intr["fy"] * downsample,
                      intr["cx"] * downsample, intr["cy"] * downsample)

        # scene box -> unit box, only used by the `bricks` environment
        # (other RTMV environments ship pre-normalized cameras)
        world = WorldMap()
        if "bricks" in root_dir:
            lo = np.array(meta["scene_min_3d_box"])
            hi = np.array(meta["scene_max_3d_box"])
            world = WorldMap(
                shift=np.asarray(meta["scene_center_3d_box"], np.float32),
                scale=float((hi - lo).max() / 2 * 1.05))

        frames = []
        if kwargs.get("read_meta", True):
            start, end = _SPLIT_RANGE.get(split, (0, 150))
            imgs = sorted_glob(root_dir, "images/*")[start:end]
            cams = sorted_glob(root_dir, "*.json")[start:end]
            for img, cam in zip(imgs, cams):
                # cam2world is stored column-major; transposed it is a c2w
                # with [right up back] columns
                raw = np.array(_camera_data(cam)["cam2world"], np.float32)
                frames.append(Frame(pose=raw.T[:3], image=img))

        install(self, SceneManifest(K=K, img_wh=(w, h), frames=frames,
                                    convention="rub", world=world))
