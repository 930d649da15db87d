"""The disk loaders' ray store and batch sampling (counterpart of
ngp_pl_tpu/datasets/base.py; reference datasets/base.py).

A loader reads every image of its split into one host array, `rays`
(n_img, H*W, 3 or 4) float32; the fourth channel, where present, is the
HDR-NeRF exposure.  A train split has 1000 virtual iterations per epoch
(reference base.py:17-20).  `sample_batch(rng)` draws one batch with the
port's host library (`ngp_pl_torch.native`) from a seed taken from `rng`,
as the JAX package's does, so the same numpy Generator gives the same
batches in both packages; with `NGP_PL_TORCH_NO_NATIVE` set it takes the
numpy branch.  The training system keeps the store on the card when it
fits its budget and samples there instead (`NeRFSystem`).  `test_item`
returns the view's colours on the dataset's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ngp_pl_torch.device import resolve_device


def sample_rays(rays: np.ndarray, batch_size: int, strategy: str,
                rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One batch of (image, pixel) draws from a host store
    (ngp_pl_tpu/datasets/base.py:48-78): the host library with the seed
    `rng.integers(0, 2**62)`, or, with `NGP_PL_TORCH_NO_NATIVE`, numpy
    draws from `rng` after that seed (drawn there too, and unused)."""
    from ngp_pl_torch import native

    n_img, n_pix = rays.shape[:2]
    has_exposure = rays.ndim == 3 and rays.shape[-1] == 4
    seed = int(rng.integers(0, 2 ** 62))
    if not native.native_disabled():
        out = native.sample_batch(rays, batch_size, strategy, seed)
        if has_exposure and "exposure" not in out:
            out["exposure"] = rays[out["img_idxs"], out["pix_idxs"], 3:]
        return out
    if strategy == "all_images":
        img_idxs = rng.integers(0, n_img, batch_size)
    elif strategy == "same_image":
        img_idxs = np.full(batch_size, rng.integers(0, n_img))
    else:
        raise ValueError(strategy)
    pix_idxs = rng.integers(0, n_pix, batch_size)
    sel = rays[img_idxs, pix_idxs]
    batch = {"img_idxs": img_idxs.astype(np.int32),
             "pix_idxs": pix_idxs.astype(np.int32), "rgb": sel[:, :3]}
    if has_exposure:
        batch["exposure"] = sel[:, 3:]
    return batch


class BaseDataset:
    """Poses, intrinsics, directions and the ray store of one split; every
    loader takes (root_dir, split, downsample, device, **kwargs)."""

    def __init__(self, root_dir: str, split: str = "train",
                 downsample: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        if not root_dir:
            raise ValueError(f"{type(self).__name__} reads a scene from "
                             f"disk: give its directory (--root_dir)")
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        # set by the loader
        self.rays: np.ndarray = np.zeros((0, 0, 3), np.float32)
        self.poses: np.ndarray = np.zeros((0, 3, 4), np.float32)
        self.directions: np.ndarray = np.zeros((0, 3), np.float32)
        self.K: np.ndarray = np.eye(3, dtype=np.float32)
        self.img_wh = (0, 0)
        # set by the training system (reference train.py:106-108)
        self.batch_size = 8192
        self.ray_sampling_strategy = "all_images"

    def __len__(self):
        if self.split.startswith("train"):
            return 1000
        return len(self.poses)

    @property
    def has_exposure(self) -> bool:
        return self.rays.ndim == 3 and self.rays.shape[-1] == 4

    def sample_batch(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One training batch on the host (reference base.py:24-35)."""
        return sample_rays(self.rays, self.batch_size,
                           self.ray_sampling_strategy, rng)

    def test_item(self, idx: int) -> Dict:
        """One test view (reference base.py:37-42): its pose and, where the
        split has images, its rgb (H*W, 3) on the dataset's device and its
        exposure."""
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            rays = self.rays[idx]
            sample["rgb"] = torch.from_numpy(
                np.ascontiguousarray(rays[:, :3])).to(self.device)
            if self.has_exposure:
                sample["exposure"] = rays[0, 3]
        return sample

    def __getitem__(self, idx: int):
        if self.split.startswith("train"):
            return self.sample_batch(np.random.default_rng())
        return self.test_item(idx)
