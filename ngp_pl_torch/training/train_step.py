"""One training step and its parts (counterpart of
ngp_pl_tpu/training/train_step.py; reference train.py:159-185).

A step: batch (image, pixel) indices drawn on the device from the resident
ray store -> rays -> train render in the step's layout (CSR, strided or
rounds) -> rgb MSE + opacity entropy (+ distortion) -> gradients -> Adam
with the per-epoch cosine lr and the non-finite skip.
PyTorch runs it eagerly; nothing in a step reads a value back to the host,
so a block of steps queues on the card without a sync.

Noise, background and batch indices are arguments of `train_step` and
`sample_batch` takes an explicit `torch.Generator`, so the tests can feed
the JAX package's values.  The Adam update is written out in optax's form
(`optax.adam`: bias-corrected moments, m_hat / (sqrt(v_hat) + eps), the lr
evaluated at the step count before it advances): the JAX package's
optimizer is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ngp_pl_torch.config import RenderConfig, TrainConfig
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
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update; returns the device bool `grads_finite`."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
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


def sample_batch(rays_store: torch.Tensor, batch_size: int, strategy: str,
                 generator: torch.Generator):
    """(img_idxs, pix_idxs, rgb) of one batch drawn on the store's device
    (train_step.py:278-300)."""
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
                 chain_length: int, layout: str = "csr"):
    """The render of a train step in `layout` and its loss (`loss_fn`,
    train_step.py:131-163): "csr" (`n_samples` is the pool's multiple of
    the batch), "strided" (S, the width of each ray's row) or "rounds" (S
    per round, 16 and a 512-step chain by default).  Returns the render's
    outputs and a function of the targets that gives the loss."""
    if layout == "csr":
        results = render_rays_train_csr(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            pool_mult=n_samples or None, chain_length=chain_length)
    elif layout == "rounds":
        results = render_rays_train_rounds(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            n_samples=n_samples or 16, chain_length=chain_length or 512,
            lambda_distortion=tcfg.distortion_loss_w)
    elif layout == "strided":
        results = render_rays_train(
            ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
            n_samples=n_samples or None, chain_length=chain_length)
    else:
        raise ValueError(f"unknown train layout {layout!r}")

    def loss_of(target):
        return total_loss(nerf_loss(
            results, target, lambda_opacity=tcfg.opacity_loss_w,
            lambda_distortion=tcfg.distortion_loss_w))

    return results, loss_of


def train_step(ngp, opt: Adam, win_rows, rays_o, rays_d, target, noise, bg,
               *, tcfg: TrainConfig, rcfg: RenderConfig, n_samples: int,
               chain_length: int, layout: str = "csr"
               ) -> Dict[str, torch.Tensor]:
    """One train step (`loss_fn` + `_step_core`, train_step.py:106-265)
    from given rays, targets, march noise (B,) and background (3,), in
    `layout` with its budget `n_samples` (see `train_render`).  Returns
    device metrics, among them the packed demand vector."""
    results, loss_of = train_render(
        ngp, win_rows, rays_o, rays_d, noise, bg, tcfg=tcfg, rcfg=rcfg,
        n_samples=n_samples, chain_length=chain_length, layout=layout)
    loss = loss_of(target)
    grads = torch.autograd.grad(loss, opt.params)
    finite = opt.step(grads)
    rgb = results["rgb"].detach()
    rm_counts, vr_counts = results["rm_counts"], results["vr_counts"]
    aux = {
        "rm_samples": results["rm_samples"],
        "chain_demand": results["chain_demand"],
        "chain_demand_q": results["chain_demand_q"],
        "rm_counts_q": q99(rm_counts),
        "vr_counts_q": q99(vr_counts),
        "vr_counts_q90": qtile(vr_counts, 0.90),
        "vr_counts_mean": vr_counts.to(torch.float32).mean(),
        "rounds_alive_end": results.get(
            "rounds_alive_end", torch.zeros((), device=rgb.device)),
        "rm_counts_mean": rm_counts.to(torch.float32).mean(),
    }
    return {
        "loss": loss.detach(),
        "psnr": -10.0 * torch.log10(torch.mean((rgb - target) ** 2)),
        "grads_finite": finite,
        "n_skipped": (~finite).to(torch.int32),
        "rm_samples": results["rm_samples"],
        "vr_samples": results["vr_samples"],
        "rm_counts_max": rm_counts.max(),
        "chain_demand": results["chain_demand"],
        "chain_demand_q": results["chain_demand_q"],
        # share of the batch outside the loss (strided, rounds)
        "dropped_share": 1.0 - results["loss_mask"].to(torch.float32).mean()
        if "loss_mask" in results else torch.zeros((), device=rgb.device),
        "rounds_alive_end": aux["rounds_alive_end"],
        "total_slots": results.get("total_slots",
                                   torch.zeros((), device=rgb.device)),
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
