"""Training losses (counterpart of ngp_pl_tpu/training/losses.py:14-56,
reference losses.py:41-60): the rgb MSE, the opacity entropy and the
distortion loss, each a per-ray component; the total is the sum of their
means.  Where the render reports a `loss_mask` (strided, rounds), rays
outside it contribute nothing."""
from __future__ import annotations

from typing import Dict

import torch

from ngp_pl_torch.ops.distortion import distortion_loss, distortion_loss_strided


def nerf_loss(results: Dict[str, torch.Tensor], target_rgb: torch.Tensor, *,
              lambda_opacity: float = 1e-3,
              lambda_distortion: float = 0.0) -> Dict[str, torch.Tensor]:
    o = results["opacity"] + 1e-10
    # push opacity towards 0 or 1 to kill floaters (losses.py:51-53)
    d = {"rgb": (results["rgb"] - target_rgb) ** 2,
         "opacity": lambda_opacity * (-o * torch.log(o))}
    mask = results.get("loss_mask")
    if mask is not None:
        # rays truncated by the layout carry a biased partial render
        m = mask.to(torch.float32)
        d["rgb"] = d["rgb"] * m[:, None]
        d["opacity"] = d["opacity"] * m
    if lambda_distortion > 0:
        if "distortion" in results:          # rounds: accumulated per round
            dist = results["distortion"]
        elif "valid" in results:             # strided (N, S)
            dist = distortion_loss_strided(results["ws"], results["deltas"],
                                           results["ts"], results["valid"])
        else:                                # CSR pool: never masked
            dist = distortion_loss(results["ws"], results["deltas"],
                                   results["ts"], results["ray_idx"],
                                   results["pool_valid"], results["offsets"],
                                   n_rays=target_rgb.shape[0])
        d["distortion"] = lambda_distortion * dist
        if mask is not None:
            d["distortion"] = d["distortion"] * mask.to(torch.float32)
    return d


def total_loss(loss_d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the components' means (reference train.py:173)."""
    return sum(v.mean() for v in loss_d.values())
