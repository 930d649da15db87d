"""Blender / NeRF-synthetic format (counterpart of
ngp_pl_tpu/datasets/nerf.py; behavioral spec: reference
datasets/nerf.py — transforms_*.json, 800^2 frames, camera_angle_x focal,
orbit radius 1.5; Jrender per-scene radius/shift table, nerf.py:55-79).

Structured as a declarative SceneManifest (see datasets/manifest.py): this
module only knows the JSON schema and the per-scene tables.
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
)

# Jrender scenes orbit at non-unit radii / off-center (reference nerf.py:57-68)
_JRENDER_RADIUS = {"Easyship": 1.2, "Scar": 1.8, "Coffee": 2.5, "Car": 0.8}
_JRENDER_SHIFT = {"Coffee": (0.0, -0.4465, 0.0), "Car": (-0.7, 0.0, 0.0)}


def _load_json(root: str, split: str) -> dict:
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        return json.load(f)


def _split_frames(root: str, split: str) -> list:
    if split == "trainval":
        return (_load_json(root, "train")["frames"]
                + _load_json(root, "val")["frames"])
    return _load_json(root, split)["frames"]


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, device="cuda",
                 **kwargs):
        super().__init__(root_dir, split, downsample, device)
        meta = _load_json(root_dir, "train")
        side = int(800 * downsample)
        focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) * downsample

        scene = os.path.basename(os.path.normpath(root_dir))
        jrender = "Jrender_Dataset" in root_dir
        world = WorldMap(
            radius=_JRENDER_RADIUS.get(scene, 1.5) if jrender else 1.5,
            shift=np.float32(_JRENDER_SHIFT.get(scene, (0, 0, 0)))
            if jrender else np.zeros(3, np.float32))

        frames = []
        if kwargs.get("read_meta", True):
            for fr in _split_frames(root_dir, split):
                img = os.path.join(root_dir, f"{fr['file_path']}.png")
                frames.append(Frame(
                    pose=np.array(fr["transform_matrix"], np.float32)[:3],
                    image=img if os.path.exists(img) else None))

        install(self, SceneManifest(
            K=pinhole_K(focal, focal, side / 2, side / 2),
            img_wh=(side, side),
            frames=frames,
            # Jrender poses carry [left up front] columns, Blender's
            # [right up back]
            convention="luf" if jrender else "rub",
            world=world,
        ))
