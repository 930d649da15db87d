"""LPIPS (vgg variant) in PyTorch (counterpart of
ngp_pl_tpu/training/lpips_jax.py; reference train.py:27-31, 62-68).

VGG16 conv features tapped at relu{1_2,2_2,3_3,4_3,5_3}, unit-normalised
over channels, squared differences weighted by the 1x1 "lin" weights,
averaged over space and summed over the taps (Zhang et al. 2018).  The
weights live in one npz in the JAX package's naming scheme and layout
(`conv{i}_w` HWIO, `conv{i}_b`, `lin{t}_w`), so one file serves both
packages; `_features` turns HWIO into torch's OIHW and the images from
NHWC into NCHW.  "SAME" 3x3 convolutions are padding 1, the 2x2 max-pool
floors odd sizes as XLA's VALID window does.  No pretrained weights ship
with the repository: `init_random_weights` makes He-initialised ones from
a seed, with which LPIPS(x, x) == 0 and the metric grows with
perturbation, but which measure nothing perceptual.  On the card the convolutions run in
float32 because `device.resolve_device` turns cuDNN's TF32 off.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: out channels per conv, 'M' = 2x2 max-pool
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
# taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (conv indices)
_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
# LPIPS input normalisation (shift/scale applied to the [-1, 1] input)
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def init_random_weights(seed: int = 0,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """He-initialised weights in the LPIPS naming scheme from a torch
    Generator seeded with `seed` (testing only, not a perceptual metric):
    conv weights normal * sqrt(2 / (9 c_in)) in HWIO, zero biases, lin
    weights uniform in [0, 0.1), as `lpips_jax.init_random_weights` draws
    them from its own key."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    c_in, ci = 3, 0
    for spec in _VGG16:
        if spec == "M":
            continue
        params[f"conv{ci}_w"] = torch.randn(
            (3, 3, c_in, spec), generator=gen) * (2.0 / (c_in * 9)) ** 0.5
        params[f"conv{ci}_b"] = torch.zeros(spec)
        c_in, ci = spec, ci + 1
    for ti, ch in enumerate(_TAP_CHANNELS):
        params[f"lin{ti}_w"] = torch.rand(ch, generator=gen) * 0.1
    return {k: v.to(device) for k, v in params.items()}


def load_weights_npz(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(data[k], np.float32)).to(device)
                for k in data.files}


def save_weights_npz(path: str, params: Dict[str, torch.Tensor]) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def export_from_torch_lpips(out_path: str) -> bool:
    """Convert the `lpips` package's pretrained LPIPS(net='vgg') into the
    npz scheme.  Returns False when the package is not installed."""
    try:
        import lpips as lpips_pkg
    except ImportError:
        return False
    net = lpips_pkg.LPIPS(net="vgg")
    params: Dict[str, np.ndarray] = {}
    convs = [m for s in (net.net.slice1, net.net.slice2, net.net.slice3,
                         net.net.slice4, net.net.slice5) for m in s]
    ci = 0
    for m in convs:
        if isinstance(m, torch.nn.Conv2d):
            # torch OIHW -> HWIO
            params[f"conv{ci}_w"] = (
                m.weight.detach().numpy().transpose(2, 3, 1, 0))
            params[f"conv{ci}_b"] = m.bias.detach().numpy()
            ci += 1
    for ti, lin in enumerate(net.lins):
        params[f"lin{ti}_w"] = (
            lin.model[-1].weight.detach().numpy().reshape(-1))
    np.savez(out_path, **params)
    return True


def _features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W) in [-1, 1] -> the tapped feature maps (N, C, H', W')."""
    dev = x.device
    shift = torch.from_numpy(_SHIFT).to(dev)[None, :, None, None]
    scale = torch.from_numpy(_SCALE).to(dev)[None, :, None, None]
    h = (x - shift) / scale
    taps = []
    ci = 0
    for spec in _VGG16:
        if spec == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        w = params[f"conv{ci}_w"].permute(3, 2, 0, 1)        # HWIO -> OIHW
        h = F.conv2d(h, w, padding=1)
        h = torch.relu(h + params[f"conv{ci}_b"][None, :, None, None])
        if ci in _TAPS:
            taps.append(h)
        ci += 1
    return taps


@torch.no_grad()
def lpips(params, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """img: (H, W, 3) or (N, H, W, 3) in [0, 1].  Returns LPIPS per image."""
    squeeze = img0.dim() == 3
    if squeeze:
        img0, img1 = img0[None], img1[None]
    x0 = (img0 * 2.0 - 1.0).permute(0, 3, 1, 2)
    x1 = (img1 * 2.0 - 1.0).permute(0, 3, 1, 2)
    total = 0.0
    for ti, (f0, f1) in enumerate(zip(_features(params, x0),
                                      _features(params, x1))):
        n0 = f0 / torch.sqrt(torch.sum(f0 ** 2, 1, keepdim=True) + 1e-10)
        n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, 1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2                                  # (N, C, H', W')
        w = params[f"lin{ti}_w"][None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, 1), dim=(1, 2))
    return total[0] if squeeze else total


if __name__ == "__main__":
    # Offline weight export, where `pip install lpips` works:
    #     python -m ngp_pl_torch.training.lpips export lpips_vgg.npz
    # then set NGP_PL_TORCH_LPIPS_NPZ=lpips_vgg.npz.
    if len(sys.argv) == 3 and sys.argv[1] == "export":
        if export_from_torch_lpips(sys.argv[2]):
            print(f"LPIPS-vgg weights -> {sys.argv[2]}")
        else:
            print("export failed: the `lpips` package is not installed")
            sys.exit(1)
    else:
        print(__doc__)
        print("usage: python -m ngp_pl_torch.training.lpips export "
              "<out.npz>")
        sys.exit(2)
