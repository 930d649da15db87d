"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes `device="cpu"`: a
missing CUDA device raises instead of carrying on on the CPU.  Choosing the
card also turns TF32 off for matmuls and cuDNN convolutions (SSIM's filter
is a convolution, which cuDNN would otherwise run in TF32), so float32 means
float32 on both devices.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_current(dev: torch.device) -> None:
    """Raise unless `dev` is the current CUDA device.  The hand kernels
    launch through ctypes into the calling thread's current CUDA context,
    whatever device their tensors are on, and cache their occupancy and
    shared-memory attributes once per process; one process per GPU, with
    its card set before anything else, keeps both right."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {dev}, but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}: the kernels launch on the "
            f"current device (torch.cuda.set_device)")


def sync(dev) -> None:
    """The fence of the port's host clocks: wait until the card has run
    everything queued on `dev` (a device or its name); nothing on the CPU,
    whose work is done when its call returns."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line(dev) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (first card), or "cpu"
    for a CPU run, so that every reading names where it was taken."""
    import subprocess

    if torch.device(dev).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
