"""PSNR and SSIM (counterpart of ngp_pl_tpu/training/metrics.py:17-60).

SSIM is the Gaussian-window (11, sigma 1.5) form with 'valid' borders, as
torchmetrics' defaults.  Its filter is a depthwise convolution: on the card
it runs in float32 only because `device.resolve_device` turns cuDNN's TF32
off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(image_pred, image_gt):
    return torch.mean((image_pred - image_gt) ** 2)


def psnr(image_pred, image_gt):
    return -10.0 * torch.log10(mse(image_pred, image_gt))


def _gaussian_kernel(size=11, sigma=1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img0, img1, max_val=1.0):
    """img: (H, W, C) in [0, max_val]. Returns the scalar mean SSIM."""
    k = torch.from_numpy(_gaussian_kernel()).to(img0.device)[None, None]
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], k)[:, 0]   # (C, H', W')

    mu0 = filt(img0)
    mu1 = filt(img1)
    # clamp variances at 0: E[x^2] - E[x]^2 can dip below 0 in f32
    s00 = torch.clamp_min(filt(img0 * img0) - mu0 * mu0, 0.0)
    s11 = torch.clamp_min(filt(img1 * img1) - mu1 * mu1, 0.0)
    s01 = filt(img0 * img1) - mu0 * mu1
    s01 = torch.sign(s01) * torch.minimum(torch.abs(s01),
                                          torch.sqrt(s00 * s11))
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)
