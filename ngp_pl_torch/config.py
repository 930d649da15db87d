"""Configuration of the PyTorch port (counterpart of ngp_pl_tpu/config.py).

A standalone copy of what the render slice needs: the reference renderer's
constants, the model and render hyperparameters, and the evaluation subset of
the training config with its argparse surface.  The port imports nothing of
the JAX package, so the values are repeated here and the parity tests hold
them equal.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

# Constants shared with the reference renderer (reference
# models/rendering.py:7-8, models/csrc/raymarching.cu:4).
MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01
SQRT3 = math.sqrt(3.0)


@dataclass(frozen=True)
class NGPConfig:
    """Static model hyperparameters (reference models/networks.py:13-92)."""

    scale: float = 0.5
    # hash encoding (reference networks.py:32-56)
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution_factor: float = 2048.0
    # density / rgb MLPs (reference networks.py:48-77)
    sigma_hidden: int = 64
    sigma_layers: int = 1
    geo_features: int = 16
    rgb_hidden: int = 64
    rgb_layers: int = 2
    sh_degree: int = 4
    rgb_act: str = "Sigmoid"        # 'Sigmoid' | 'None' (HDR mode)
    # occupancy grid (reference networks.py:25-29)
    grid_size: int = 128

    @property
    def cascades(self) -> int:
        # reference networks.py:26
        return max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)

    @property
    def per_level_scale(self) -> float:
        # b = exp(ln(N_max/N_min)/(L-1)), reference networks.py:33
        return math.exp(
            math.log(self.max_resolution_factor * self.scale / self.base_resolution)
            / (self.n_levels - 1)
        )

    @property
    def exp_step_factor(self) -> float:
        # reference train.py:95-96: 1/256 iff scale > 0.5
        return 1.0 / 256.0 if self.scale > 0.5 else 0.0


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering-path parameters of the test-view renderer."""

    max_samples: int = MAX_SAMPLES           # samples per ray cap
    test_t_threshold: float = 1e-4           # early-termination transmittance


@dataclass(frozen=True)
class TrainConfig:
    """The evaluation subset of the reference opt.py flags.

    Defaults are the flagship model: scale 0.5 (one cascade, uniform steps)
    and the L=8, F=4, T=2^19 brick table.  The port's field covers F=4 and
    the Sigmoid head only, so F and the HDR switch are not flags yet."""

    dataset_name: str = "synthetic"
    downsample: float = 1.0
    scale: float = 0.5
    n_levels: int = 8
    log2_hashmap_size: int = 19
    weight_path: Optional[str] = None
    seed: int = 1337

    def ngp_config(self) -> NGPConfig:
        return NGPConfig(
            scale=self.scale,
            n_levels=self.n_levels,
            n_features_per_level=4,
            log2_hashmap_size=self.log2_hashmap_size,
        )

    def render_config(self) -> RenderConfig:
        return RenderConfig()

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def add_eval_args(parser) -> None:
    """argparse surface of the evaluation entry point (reference opt.py)."""
    d = TrainConfig()
    parser.add_argument("--dataset_name", type=str, default=d.dataset_name,
                        choices=["synthetic"])
    parser.add_argument("--downsample", type=float, default=d.downsample)
    parser.add_argument("--scale", type=float, default=d.scale)
    parser.add_argument("--n_levels", type=int, default=d.n_levels)
    parser.add_argument("--log2_hashmap_size", type=int,
                        default=d.log2_hashmap_size)
    parser.add_argument("--weight_path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=d.seed)


def config_from_args(args) -> TrainConfig:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in known and v is not None}
    return TrainConfig(**kw)

