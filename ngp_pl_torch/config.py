"""Configuration of the PyTorch port (counterpart of ngp_pl_tpu/config.py).

A standalone copy of what the port covers: the reference renderer's
constants, the model and render hyperparameters, and the training config
with the argparse surface of its entry points (eval and train).  The port
imports nothing of the JAX package, so the values are repeated here and the
parity tests hold them equal.
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
    """Static rendering-path parameters (ngp_pl_tpu/config.py:81-98)."""

    max_samples: int = MAX_SAMPLES           # samples per ray cap
    t_threshold: float = 1e-4                # train-time early termination
    # flat sample-pool size as a multiple of the ray batch, train path
    train_pool_mult: int = 32
    test_t_threshold: float = 1e-4           # early-termination transmittance


@dataclass(frozen=True)
class TrainConfig:
    """The reference opt.py flags the port covers, with the JAX package's
    defaults (ngp_pl_tpu/config.py:101-176).

    Defaults are the flagship model: scale 0.5 (one cascade, uniform steps)
    and the L=8, F=4, T=2^19 brick table; `--n_levels 16 --n_features 2`
    is the reference's own L16F2 geometry.  `use_exposure` switches the
    head to HDR (log-radiance and per-channel tonemappers, `rgb_act`
    "None"); `optimize_ext` trains per-image pose corrections at `pose_lr`.
    The train layout defaults to "auto", as the JAX package's: CSR through
    grid warmup, then strided or CSR by the demand's shape."""

    # dataset (opt.py:6-16); the port's default scene is the procedural one
    root_dir: str = ""
    dataset_name: str = "synthetic"  # nerf|nsvf|colmap|nerfpp|rtmv|synthetic
    split: str = "train"             # train|trainval|trainvaltest
    downsample: float = 1.0
    scale: float = 0.5
    use_exposure: bool = False                 # HDR head (opt.py:18-22)
    n_levels: int = 8
    n_features: int = 4                        # per level, F in {2, 4}
    log2_hashmap_size: int = 19
    # loss (opt.py:24-29, losses.py:42-45)
    opacity_loss_w: float = 1e-3
    distortion_loss_w: float = 0.0             # mip-NeRF 360 distortion
    # training (opt.py:31-52)
    batch_size: int = 8192
    ray_sampling_strategy: str = "all_images"  # all_images|same_image
    num_epochs: int = 30
    iters_per_epoch: int = 1000
    lr: float = 1e-2
    optimize_ext: bool = False  # per-image pose refinement (dR, dT)
    random_bg: bool = False     # exp-stepping scenes: a random train bg
    # optimizer constants (reference train.py:131-137)
    adam_eps: float = 1e-15
    lr_final_div: float = 30.0                 # cosine anneal floor = lr/30
    pose_lr: float = 1e-6                      # reference train.py:128
    # density-grid cadence (reference train.py:58-59, 160-163)
    grid_update_interval: int = 16
    grid_warmup_steps: int = 256
    train_layout: str = "auto"                 # auto|strided|csr|rounds
    # data-parallel ranks, one process per GPU (reference opt.py --num_gpus):
    # 0 = every visible GPU, as the JAX package's `jax.device_count()`.
    # The JAX package's `mesh_data_axis` names its mesh axis; one process
    # per GPU has no mesh, so the port has no such field.
    num_devices: int = 0
    log_every: int = 100
    # validation (opt.py:54-60)
    eval_lpips: bool = False    # raises without LPIPS weights (LPIPSHook)
    val_only: bool = False
    no_save_test: bool = False
    exp_name: str = "exp"
    ckpt_path: Optional[str] = None            # full checkpoint to resume
    weight_path: Optional[str] = None          # slim checkpoint
    seed: int = 1337
    # the ray store stays on the card, and batches are drawn there, when it
    # fits this budget; otherwise batches are drawn on the host and copied
    device_dataset: bool = True
    device_dataset_max_bytes: int = 4 << 30

    @property
    def max_steps(self) -> int:
        return self.num_epochs * self.iters_per_epoch

    def ngp_config(self) -> NGPConfig:
        return NGPConfig(
            scale=self.scale,
            rgb_act="None" if self.use_exposure else "Sigmoid",
            n_levels=self.n_levels,
            n_features_per_level=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
        )

    def render_config(self) -> RenderConfig:
        return RenderConfig()

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def add_eval_args(parser) -> None:
    """argparse surface of the evaluation entry point (reference opt.py)."""
    d = TrainConfig()
    # the JAX package requires --root_dir; here it may be left out for the
    # synthetic scene, and a disk loader given none raises
    parser.add_argument("--root_dir", type=str, default=d.root_dir)
    parser.add_argument("--dataset_name", type=str, default=d.dataset_name,
                        choices=["nerf", "nsvf", "colmap", "nerfpp", "rtmv",
                                 "synthetic"])
    parser.add_argument("--split", type=str, default=d.split,
                        choices=["train", "trainval", "trainvaltest"],
                        help="the train split (eval: the views that mark "
                        "the grid when no --weight_path is given)")
    parser.add_argument("--downsample", type=float, default=d.downsample)
    parser.add_argument("--scale", type=float, default=d.scale)
    parser.add_argument("--use_exposure", action="store_true")
    parser.add_argument("--n_levels", type=int, default=d.n_levels,
                        help="hash-encoding levels L (reference: 16)")
    parser.add_argument("--n_features", type=int, default=d.n_features,
                        choices=[2, 4],
                        help="features per level F (reference: 2)")
    parser.add_argument("--log2_hashmap_size", type=int,
                        default=d.log2_hashmap_size)
    parser.add_argument("--weight_path", type=str, default=None)
    parser.add_argument("--seed", type=int, default=d.seed)


def add_train_args(parser) -> None:
    """argparse surface of the training entry point: the subset of the JAX
    package's train.py flags (ngp_pl_tpu/config.py:185-228) that the port
    covers, with the same names and defaults."""
    add_eval_args(parser)
    d = TrainConfig()
    parser.add_argument("--batch_size", type=int, default=d.batch_size)
    parser.add_argument("--ray_sampling_strategy", type=str,
                        default=d.ray_sampling_strategy,
                        choices=["all_images", "same_image"])
    parser.add_argument("--num_epochs", type=int, default=d.num_epochs)
    parser.add_argument("--iters_per_epoch", type=int,
                        default=d.iters_per_epoch)
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--optimize_ext", action="store_true")
    parser.add_argument("--distortion_loss_w", type=float,
                        default=d.distortion_loss_w)
    parser.add_argument("--random_bg", action="store_true")
    parser.add_argument("--eval_lpips", action="store_true")
    parser.add_argument("--val_only", action="store_true")
    parser.add_argument("--no_save_test", action="store_true")
    parser.add_argument("--exp_name", type=str, default=d.exp_name)
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--train_layout", type=str, default=d.train_layout,
                        choices=["auto", "rounds", "csr", "strided"])
    parser.add_argument("--num_devices", type=int, default=d.num_devices,
                        help="data-parallel ranks, one process per GPU; 0 = "
                        "every visible GPU (with --device cpu: gloo ranks, "
                        "0 = one)")


def config_from_args(args) -> TrainConfig:
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in known and v is not None}
    return TrainConfig(**kw)

