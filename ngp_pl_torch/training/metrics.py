"""PSNR, SSIM and the LPIPS hook (counterpart of
ngp_pl_tpu/training/metrics.py).

SSIM is the Gaussian-window (11, sigma 1.5) form with 'valid' borders, as
torchmetrics' defaults.  Its filter is a depthwise convolution: on the card
it runs in float32 only because `device.resolve_device` turns cuDNN's TF32
off.  LPIPS is `training/lpips.py`, behind `LPIPSHook`, which finds its
weights.
"""
from __future__ import annotations

import os
import tempfile

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


# the npz of LPIPS weights (the JAX package reads NGP_PL_TPU_LPIPS_NPZ;
# one file in the shared naming scheme serves both)
LPIPS_ENV = "NGP_PL_TORCH_LPIPS_NPZ"


class LPIPSHook:
    """Lazy LPIPS(vgg) evaluator on `device` (metrics.py:63-111).  Weights
    are looked for once, in order: the npz named by NGP_PL_TORCH_LPIPS_NPZ;
    then ngp_pl_torch_lpips_vgg.npz in the temporary directory, converted
    there from the `lpips` package's pretrained network if that package is
    installed.  Without either the hook is unavailable."""

    def __init__(self, device="cpu"):
        self.device = device
        self.params = None
        self._tried = False

    @property
    def available(self) -> bool:
        if not self._tried:
            self._tried = True
            from ngp_pl_torch.training import lpips

            path = os.environ.get(LPIPS_ENV)
            if not (path and os.path.exists(path)):
                path = os.path.join(tempfile.gettempdir(),
                                    "ngp_pl_torch_lpips_vgg.npz")
                if not os.path.exists(path):
                    lpips.export_from_torch_lpips(path)
            if os.path.exists(path):
                self.params = lpips.load_weights_npz(path, self.device)
        return self.params is not None

    def __call__(self, pred, gt):
        """LPIPS of two (H, W, 3) images in [0, 1], or None without
        weights."""
        if not self.available:
            return None
        from ngp_pl_torch.training import lpips

        return float(lpips.lpips(self.params, pred.to(torch.float32),
                                 gt.to(torch.float32)))
