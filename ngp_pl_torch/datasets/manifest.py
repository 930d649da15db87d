"""Declarative scene manifests: the shared spine of every format loader
(counterpart of ngp_pl_tpu/datasets/manifest.py, the same code).

The reference implements each dataset as an imperative read loop with inline
pose fix-ups (reference datasets/{nerf,nsvf,colmap,nerfpp,rtmv}.py).  This
rebuild factors the data layer differently: a format loader only *describes*
the scene — camera intrinsics, a list of frames (raw pose + image path +
optional exposure), the pose axis convention, and the world normalization —
and one shared pipeline (`install`) turns that description into the arrays
training consumes.  Format knowledge becomes data:

- `convention`: what the format's pose columns mean, as a 3-letter tag over
  {r,l, u,d, f,b} (x/y/z of camera space).  The trainer's internal frame is
  "rdf" ([right, down, front]); remapping is a per-column sign flip derived
  from the tag, not hand-written `c2w[:, 1:3] *= -1` lines.
- `WorldMap`: how raw camera positions map into the unit scene box — either
  shift+scale (NSVF bbox.txt, RTMV scene box) or radius normalization of the
  camera orbit (Blender).  One dataclass, applied in one place.
- per-frame `Frame(pose, image, exposure)` rows; pose-only rows describe
  render-trajectory splits (test_traj / camera_path).

The port's loaders are held to the JAX package's on fixture scenes of
every format by tests/test_torch_loaders.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ngp_pl_torch.datasets.color_utils import read_image
from ngp_pl_torch.datasets.ray_utils import get_ray_directions

# camera-space axis letters -> (axis index, sign) of the internal rdf frame
_AXIS = {
    "r": (0, +1.0), "l": (0, -1.0),
    "d": (1, +1.0), "u": (1, -1.0),
    "f": (2, +1.0), "b": (2, -1.0),
}


def convention_matrix(tag: str) -> np.ndarray:
    """(3, 3) right-multiplier taking a `tag`-convention rotation to rdf.

    Column j of the raw pose is the camera's tag[j] axis in world space; the
    remapped pose must carry [right, down, front] columns, so column j moves
    to slot _AXIS[tag[j]] with the matching sign."""
    m = np.zeros((3, 3), np.float32)
    for j, letter in enumerate(tag):
        i, s = _AXIS[letter]
        m[j, i] = s
    return m


@dataclass(frozen=True)
class WorldMap:
    """Rigid+scale map from the format's world frame into the scene box.

    Two normalization families cover every reference format:
    - shift/scale: x -> (x - shift) / (2 * scale)  (NSVF bbox with 1.05
      enlargement, RTMV scene box; reference nsvf.py:20-23, rtmv.py:27-29)
    - radius: camera centers rescaled to |t| = radius, then shifted
      (Blender orbits; reference nerf.py:70-79)
    """

    shift: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 0.0          # > 0 enables shift/scale normalization
    radius: float = 0.0         # > 0 enables orbit-radius normalization

    def apply(self, t: np.ndarray) -> np.ndarray:
        if self.radius > 0:
            t = t * (self.radius / np.linalg.norm(t))
            return t + np.asarray(self.shift, np.float32)
        if self.scale > 0:
            return (t - np.asarray(self.shift, np.float32)) / (2 * self.scale)
        return t


@dataclass
class Frame:
    pose: np.ndarray                  # (3, 4) raw c2w in the format's frame
    image: Optional[str] = None       # path; None for pose-only trajectories
    exposure: Optional[float] = None  # HDR-NeRF shutter value


@dataclass
class SceneManifest:
    K: np.ndarray                     # (3, 3) intrinsics (pre-scaled)
    img_wh: tuple                     # (w, h)
    frames: List[Frame] = field(default_factory=list)
    convention: str = "rdf"
    world: WorldMap = field(default_factory=WorldMap)
    blend_alpha: bool = True          # alpha -> white blend vs premultiply
    lift_black_to_white: bool = False  # NSVF Jade/Fountain bg fix


def remap_pose(pose: np.ndarray, tag: str, world: WorldMap) -> np.ndarray:
    """Raw (3, 4) pose -> rdf columns + normalized translation."""
    out = np.empty((3, 4), np.float32)
    out[:, :3] = pose[:, :3].astype(np.float32) @ convention_matrix(tag)
    out[:, 3] = world.apply(pose[:, 3].astype(np.float32))
    return out


def install(dataset, m: SceneManifest, load_images: bool = True) -> None:
    """Materialize a manifest onto a BaseDataset: poses, rays, directions."""
    w, h = m.img_wh
    dataset.K = np.asarray(m.K, np.float32)
    dataset.img_wh = (w, h)
    dataset.directions = get_ray_directions(h, w, dataset.K)
    if not m.frames:
        return
    dataset.poses = np.stack(
        [remap_pose(f.pose, m.convention, m.world) for f in m.frames])

    has_imgs = load_images and any(f.image for f in m.frames)
    if not has_imgs:
        return
    rays = []
    # frames without an image keep their pose row but contribute no rays
    # (matches the reference loaders' skip-on-missing behavior)
    for f in m.frames:
        if f.image is None:
            continue
        img = read_image(f.image, m.img_wh, blend_a=m.blend_alpha)
        if m.lift_black_to_white:
            img[np.all(img <= 0.1, axis=-1)] = 1.0
        if f.exposure is not None:
            img = np.concatenate(
                [img, np.full_like(img[:, :1], f.exposure)], axis=1)
        rays.append(img)
    dataset.rays = np.stack(rays).astype(np.float32)


def pinhole_K(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def sorted_glob(*parts: str) -> List[str]:
    import glob

    return sorted(glob.glob(os.path.join(*parts)))


def pose_txt(path: str) -> np.ndarray:
    """(3, 4) pose from a whitespace 4x4 (or 3x4) text file."""
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 4)[:3]
