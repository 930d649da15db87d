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
