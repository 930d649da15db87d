"""NeRF++ layout (counterpart of ngp_pl_tpu/datasets/nerfpp.py, which reads
the image size with PIL where the port reads the file header; behavioral
spec: reference datasets/nerfpp.py —
{train,val,test}/{rgb,pose,intrinsics} file triples, camera_path render
trajectory, poses already normalized by the dataset author).

Structured as a declarative SceneManifest (see datasets/manifest.py).
"""
from __future__ import annotations

import os

import numpy as np

from ngp_pl_torch.datasets.base import BaseDataset
from ngp_pl_torch.datasets.color_utils import image_size
from ngp_pl_torch.datasets.manifest import (
    Frame,
    SceneManifest,
    install,
    pose_txt,
    sorted_glob,
)


def _intrinsics(root: str, downsample: float):
    K = np.loadtxt(sorted_glob(root, "train/intrinsics/*.txt")[0],
                   dtype=np.float32).reshape(4, 4)[:3, :3]
    K[:2] *= downsample
    w, h = image_size(sorted_glob(root, "train/rgb/*")[0])
    return K, (int(w * downsample), int(h * downsample))


def _frames(root: str, split: str):
    if split == "test_traj":
        return [Frame(pose=pose_txt(p))
                for p in sorted_glob(root, "camera_path/pose/*.txt")]
    parts = ("train", "val") if split == "trainval" else (split,)
    frames = []
    for s in parts:
        imgs = sorted_glob(root, s, "rgb/*")
        poses = sorted_glob(root, s, "pose/*.txt")
        frames += [Frame(pose=pose_txt(p), image=img)
                   for img, p in zip(imgs, poses)]
    return frames


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, device="cuda",
                 **kwargs):
        super().__init__(root_dir, split, downsample, device)
        K, img_wh = _intrinsics(root_dir, downsample)
        frames = _frames(root_dir, split) if kwargs.get("read_meta", True) \
            else []
        install(self, SceneManifest(K=K, img_wh=img_wh, frames=frames))
