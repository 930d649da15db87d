"""Training losses (counterpart of ngp_pl_tpu/training/losses.py:14-56,
reference losses.py:41-60): the rgb MSE and the opacity entropy.  The
`loss_mask` and distortion branches belong to the strided and rounds
layouts, a later slice."""
from __future__ import annotations

from typing import Dict

import torch


def nerf_loss(results: Dict[str, torch.Tensor], target_rgb: torch.Tensor, *,
              lambda_opacity: float = 1e-3) -> Dict[str, torch.Tensor]:
    o = results["opacity"] + 1e-10
    # push opacity towards 0 or 1 to kill floaters (losses.py:51-53)
    return {"rgb": (results["rgb"] - target_rgb) ** 2,
            "opacity": lambda_opacity * (-o * torch.log(o))}


def total_loss(loss_d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the components' means (reference train.py:173)."""
    return sum(v.mean() for v in loss_d.values())
