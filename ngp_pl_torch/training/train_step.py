"""One training step and its parts (counterpart of
ngp_pl_tpu/training/train_step.py; reference train.py:159-185).

A step: batch (image, pixel) indices drawn on the device from the resident
ray store -> rays (through the refined poses with `--optimize_ext`) ->
train render in the step's layout (CSR, strided or rounds) -> rgb MSE +
opacity entropy (+ distortion, + the HDR head's unit-exposure anchor) ->
gradients -> Adam with the per-epoch cosine lr and the non-finite skip,
and with `--optimize_ext` a second Adam for the poses beside it
(`optax.multi_transform`, train_step.py:53-66).
PyTorch runs it eagerly; nothing in a step reads a value back to the host,
so a block of steps queues on the card without a sync.  In a process group
each rank steps on its shard of the batch with the ranks' mean gradient
(one all-reduce, as GSPMD's psum in the JAX mesh step,
train_step.py:95-99, 293-297), and its metrics are the global batch's
(`step_metrics`).

Noise, background and batch indices are arguments of `train_step` and
`sample_batch` takes an explicit `torch.Generator`, so the tests can feed
the JAX package's values.  The Adam update is written out in optax's form
(`optax.adam`: bias-corrected moments, m_hat / (sqrt(v_hat) + eps), the lr
evaluated at the step count before it advances): the JAX package's
optimizer is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ngp_pl_torch import parallel
from ngp_pl_torch.config import RenderConfig, TrainConfig
from ngp_pl_torch.datasets.ray_utils import (
    axisangle_to_R,
    get_rays,
    matmul3,
)
from ngp_pl_torch.models.ngp import mlp_apply
from ngp_pl_torch.models.rendering import (
    render_rays_train,
    render_rays_train_csr,
    render_rays_train_rounds,
)
from ngp_pl_torch.ops.ray_march import q99, qtile
from ngp_pl_torch.training.losses import nerf_loss, total_loss

# demand vector packing order (train_step.py:249-259)
DEMAND_KEYS = ("rm_samples", "chain_demand", "chain_demand_q", "rm_counts_q",
               "vr_counts_q", "vr_counts_q90", "vr_counts_mean",
               "rounds_alive_end", "rm_counts_mean")


def cosine_epoch_schedule(lr: float, num_epochs: int, iters_per_epoch: int,
                          final_div: float) -> Callable[[int], float]:
    """Per-epoch staircase cosine lr -> lr/final_div (train_step.py:40-51),
    in float32 as the JAX package evaluates it."""
    eta_min = lr / final_div
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = min(step // iters_per_epoch, num_epochs)
        cos = np.cos(f32(math.pi) * f32(epoch) / f32(num_epochs))
        return float(f32(eta_min) + f32(0.5 * (lr - eta_min)) * (f32(1.0) + cos))

    return schedule


class Adam:
    """optax.adam(schedule, b1=0.9, b2=0.999, eps) over a list of
    parameters, with the JAX trainer's non-finite skip (train_step.py:
    204-230): when any gradient holds a NaN or inf the moments and the
    parameters are kept, but the step count still advances, so the bias
    correction and the lr schedule of the next step use count + 1.

    The count is a host integer (it advances on every step, skipped or
    not); the skip itself is decided on the device, without a sync.
    Parameters are updated in place on the Parameter objects under no_grad,
    which bumps their version counters (the f16 table copy is keyed on it).
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-15):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update; returns the device bool `grads_finite`.  A
        given `finite` (the flag over several optimizers' gradients, as
        `optax.multi_transform` under the JAX trainer's skip) replaces this
        optimizer's own."""
        if finite is None:
            finite = grads_finite(grads)
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m_new = (1.0 - self.b1) * g + self.b1 * m
            v_new = (1.0 - self.b2) * (g * g) + self.b2 * v
            upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps) * (-lr)
            m.copy_(torch.where(finite, m_new, m))
            v.copy_(torch.where(finite, v_new, v))
            p.add_(torch.where(finite, upd, 0.0))
        return finite


def grads_finite(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Device bool: every gradient entry is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def apply_pose_refinement(poses: torch.Tensor, pose_params: Dict,
                          img_idxs: torch.Tensor) -> torch.Tensor:
    """poses (B, 3, 4) base c2w of each ray's image; adds the learned
    rotation dR (axis-angle) and translation dT of that image
    (train_step.py:86-91)."""
    dR = axisangle_to_R(pose_params["dR"][img_idxs])          # (B, 3, 3)
    R = matmul3(dR, poses[:, :, :3])
    t = poses[:, :, 3] + pose_params["dT"][img_idxs]
    return torch.cat([R, t[:, :, None]], dim=-1)


class PoseRefinement:
    """Per-image pose corrections `dR`, `dT` (N_img, 3), zero at the start
    (train_step.py:72-77), and their optimizer, `optax.adam(pose_lr)`:
    constant lr, eps 1e-8."""

    def __init__(self, n_images: int, pose_lr: float, device):
        self.dR = torch.zeros((n_images, 3), device=device,
                              requires_grad=True)
        self.dT = torch.zeros((n_images, 3), device=device,
                              requires_grad=True)
        self.opt = Adam([self.dR, self.dT], lambda step: pose_lr, eps=1e-8)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {"dR": self.dR, "dT": self.dT}

    def rays(self, directions: torch.Tensor, poses: torch.Tensor,
             img_idxs: torch.Tensor):
        """World rays of camera-frame directions (B, 3) through the refined
        poses of their images (`poses` (N_img, 3, 4), the base poses):
        differentiable in dR and dT."""
        return get_rays(directions, apply_pose_refinement(
            poses[img_idxs], self.params, img_idxs))


def unit_exposure_loss(ngp, unit_exposure_rgb: float) -> torch.Tensor:
    """The HDR head's anchor (train_step.py:161-170): the tonemappers at
    log-radiance 0 (unit exposure) should give `unit_exposure_rgb`; (1, 3)
    per channel, 0.5 * squared error."""
    zero = torch.zeros((1, 1), device=ngp.hash_table.device)
    unit_rgb = torch.cat([mlp_apply(ws, zero, torch.sigmoid)
                          for ws in ngp.tonemapper], dim=-1)
    return 0.5 * (unit_rgb - unit_exposure_rgb) ** 2


def sample_batch(rays_store: torch.Tensor, batch_size: int, strategy: str,
                 generator: torch.Generator):
    """(img_idxs, pix_idxs, payload) of one batch drawn on the store's
    device (train_step.py:278-302): the payload is the store's rows, rgb in
    its first three channels and, in a 4-channel store, the exposure in
    the fourth."""
    n_img, n_pix = rays_store.shape[0], rays_store.shape[1]
    dev = rays_store.device
    if strategy == "same_image":
        img = torch.randint(0, n_img, (1,), generator=generator,
                            device=dev).expand(batch_size)
    else:                                                # all_images
        img = torch.randint(0, n_img, (batch_size,), generator=generator,
                            device=dev)
    pix = torch.randint(0, n_pix, (batch_size,), generator=generator,
                        device=dev)
    return img, pix, rays_store[img, pix]


def train_render(ngp, win_rows, rays_o, rays_d, noise, bg, *,
                 tcfg: TrainConfig, rcfg: RenderConfig, n_samples: int,
                 chain_length: int, layout: str = "csr", occ_grid=None,
                 exposure: Optional[torch.Tensor] = None,
                 unit_exposure_rgb: float = 0.5):
    """The render of a train step in `layout` and its loss (`loss_fn`,
    train_step.py:131-170): "csr" (`n_samples` is the pool's multiple of
    the batch), "strided" (S, the width of each ray's row) or "rounds" (S
    per round, 16 and a 512-step chain by default).  Returns the render's
    outputs and a function of the targets that gives the loss.  The march
    reads `win_rows` where the caller's window rule gives them, else
    `occ_grid`.  The HDR head (`--use_exposure`) takes the rays' exposure
    (N, 1), if any, and adds the unit-exposure anchor to the loss."""
    hdr = tcfg.use_exposure
    exposure = exposure if hdr else None
    if layout == "csr":
        results = render_rays_train_csr(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            pool_mult=n_samples or None, chain_length=chain_length,
            occ_grid=occ_grid, exposure=exposure)
    elif layout == "rounds":
        results = render_rays_train_rounds(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            n_samples=n_samples or 16, chain_length=chain_length or 512,
            lambda_distortion=tcfg.distortion_loss_w, occ_grid=occ_grid,
            exposure=exposure)
    elif layout == "strided":
        results = render_rays_train(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            n_samples=n_samples or None, chain_length=chain_length,
            occ_grid=occ_grid, exposure=exposure)
    else:
        raise ValueError(f"unknown train layout {layout!r}")

    def loss_of(target):
        loss_d = nerf_loss(
            results, target, lambda_opacity=tcfg.opacity_loss_w,
            lambda_distortion=tcfg.distortion_loss_w)
        if hdr:
            loss_d["unit_exposure"] = unit_exposure_loss(ngp,
                                                         unit_exposure_rgb)
        return total_loss(loss_d)

    return results, loss_of


def train_step(ngp, opt: Adam, win_rows, rays_o, rays_d, target, noise, bg,
               *, tcfg: TrainConfig, rcfg: RenderConfig, n_samples: int,
               chain_length: int, layout: str = "csr", occ_grid=None,
               exposure: Optional[torch.Tensor] = None,
               unit_exposure_rgb: float = 0.5,
               pose: Optional[PoseRefinement] = None
               ) -> Dict[str, torch.Tensor]:
    """One train step (`loss_fn` + `_step_core`, train_step.py:106-265)
    from given rays, targets, march noise (B,) and background (3,), in
    `layout` with its budget `n_samples` (see `train_render`).  With
    `pose` the rays come from `pose.rays` (autograd records them): its
    dR and dT take a step of their own Adam beside the net's, one
    non-finite flag over both groups skips both, and both counts advance.
    Returns device metrics, among them the packed demand vector."""
    results, loss_of = train_render(
        ngp, win_rows, rays_o, rays_d, noise, bg, tcfg=tcfg, rcfg=rcfg,
        n_samples=n_samples, chain_length=chain_length, layout=layout,
        occ_grid=occ_grid, exposure=exposure,
        unit_exposure_rgb=unit_exposure_rgb)
    loss = loss_of(target)
    # in a process group every rank steps on the ranks' mean gradient,
    # which is the gradient of the global batch's loss (a mean over all
    # rays, masked ones included), so the skip is one decision
    if pose is None:
        grads = parallel.grad_mean(torch.autograd.grad(loss, opt.params))
        finite = opt.step(grads)
    else:
        n = len(opt.params)
        grads = parallel.grad_mean(
            torch.autograd.grad(loss, opt.params + pose.opt.params))
        finite = grads_finite(grads)
        opt.step(grads[:n], finite)
        pose.opt.step(grads[n:], finite)
    return step_metrics(loss.detach(), results, target, finite)


def step_metrics(loss, results, target, finite) -> Dict[str, torch.Tensor]:
    """`train_step`'s device metrics, among them the packed demand vector.
    In a process group they are the global batch's, as the JAX mesh step's
    are the one-device step's: loss, squared error and dropped share
    averaged over the ranks' equal shards, sample and slot counts summed,
    maxima as maxima (`rm_samples_rank_max`: the most samples one rank's
    pool kept), and the demand's quantiles and means over the gathered
    per-ray counts, so that every rank's controller takes the one-rank
    decision; two all-gathers on the current stream.  Without a group
    every reduction is the identity."""
    rgb = results["rgb"].detach()
    zero = torch.zeros((), device=rgb.device)
    need = results.get("chain_need")
    r = parallel.reduce_scalars(
        sums={"rm_samples": results["rm_samples"],
              "vr_samples": results["vr_samples"],
              "rounds_alive_end": results.get("rounds_alive_end", zero),
              "total_slots": results.get("total_slots", zero)},
        means={"loss": loss,
               "mse": torch.mean((rgb - target) ** 2),
               # share of the batch outside the loss (strided, rounds)
               "dropped_share": 1.0 - results["loss_mask"].to(
                   torch.float32).mean()
               if "loss_mask" in results else zero},
        maxes={"rm_counts_max": results["rm_counts"].max(),
               "chain_demand": results["chain_demand"],
               "chain_demand_q": results["chain_demand_q"],
               "rm_samples_rank_max": results["rm_samples"]})
    rm_counts, vr_counts, *need = parallel.gather_counts(
        [results["rm_counts"], results["vr_counts"]]
        + ([need] if need is not None else []))
    if need and parallel.active():  # else the march's own, or a constant
        r["chain_demand_q"] = q99(need[0])
    aux = {
        "rm_samples": r["rm_samples"],
        "chain_demand": r["chain_demand"],
        "chain_demand_q": r["chain_demand_q"],
        "rm_counts_q": q99(rm_counts),
        "vr_counts_q": q99(vr_counts),
        "vr_counts_q90": qtile(vr_counts, 0.90),
        "vr_counts_mean": vr_counts.to(torch.float32).mean(),
        "rounds_alive_end": r["rounds_alive_end"],
        "rm_counts_mean": rm_counts.to(torch.float32).mean(),
    }
    return {
        "loss": r["loss"],
        "psnr": -10.0 * torch.log10(r["mse"]),
        "grads_finite": finite,
        "n_skipped": (~finite).to(torch.int32),
        **{k: r[k] for k in ("rm_samples", "vr_samples", "rm_counts_max",
                             "chain_demand", "chain_demand_q",
                             "dropped_share", "rounds_alive_end",
                             "total_slots", "rm_samples_rank_max")},
        "demand_vec": torch.stack([aux[k].to(torch.float32)
                                   for k in DEMAND_KEYS]),
    }


def block_metrics(ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Metrics of a block of steps (train_step.py:351-365): the last step's,
    except the demand vector (element-wise max over the block, NaN and inf
    counted as 0), rm_samples (max), grads_finite (all) and n_skipped
    (sum)."""
    out = dict(ms[-1])
    out["demand_vec"] = torch.nan_to_num(
        torch.stack([m["demand_vec"] for m in ms]), nan=0.0, posinf=0.0,
        neginf=0.0).amax(dim=0)
    out["rm_samples"] = torch.stack([m["rm_samples"] for m in ms]).max()
    finite = torch.stack([m["grads_finite"] for m in ms])
    out["grads_finite"] = finite.all()
    out["n_skipped"] = (~finite).sum().to(torch.int32)
    return out
