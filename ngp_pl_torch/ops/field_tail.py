"""Fused field tail (K7): sigma-net layer 2 + TruncExp + rgb MLP + sigmoid.

Counterpart of ngp_pl_tpu/ops/field_pallas.py, forward only.  Layouts are
sample-major (h1 (P, 64), sh (P, 16), sigma (P,), rgb (P, 3)).

`field_tail` is K7's wrapper: on CUDA tensors it launches the kernel of
csrc/field_tail_fwd.cu, on CPU tensors it runs `field_tail_plain`, which
keeps the TPU kernel's numerics: bf16-rounded operands and f32 accumulation
at every product, the +/-30 clamp before exp, sigmoid on the rgb outputs.
"""
from __future__ import annotations

import ctypes

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.ops.hash_encoding import _bf

H_HID = 64      # hidden width (sigma + rgb MLPs, networks.py:48-77)
H_GEO = 16      # geometry features
H_SH = 16       # SH degree-4 outputs


def field_tail_supported(cfg) -> bool:
    """The fused tail covers the reference geometry (networks.py:48-77)."""
    return (cfg.rgb_act == "Sigmoid" and cfg.sigma_hidden == H_HID
            and cfg.sigma_layers == 1 and cfg.geo_features == H_GEO
            and cfg.rgb_hidden == H_HID and cfg.rgb_layers == 2
            and cfg.sh_degree == 4)


def field_tail_plain(h1, sh, w2, wr1, wr2, wr3):
    """Plain PyTorch version of K7 (see csrc/field_tail_fwd.cu)."""
    h = _bf(torch.relu(h1)) @ _bf(w2)
    z1 = _bf(sh) @ _bf(wr1[:H_SH]) + _bf(h) @ _bf(wr1[H_SH:])
    z2 = _bf(torch.relu(z1)) @ _bf(wr2)
    z3 = _bf(torch.relu(z2)) @ _bf(wr3)
    sigma = torch.exp(torch.clamp(h[:, 0], -30.0, 30.0))
    return sigma, torch.sigmoid(z3[:, :3])


def _check_cuda_args(h1, sh, w2, wr1, wr2, wr3):
    P = h1.shape[0]
    for name, t, shape in (("h1", h1, (P, H_HID)), ("sh", sh, (P, H_SH)),
                           ("w2", w2, (H_HID, H_GEO)),
                           ("wr1", wr1, (H_SH + H_GEO, H_HID)),
                           ("wr2", wr2, (H_HID, H_HID)), ("wr3", wr3, (H_HID, 3))):
        if t.device.type != "cuda" or t.device != h1.device:
            raise ValueError(f"{name} must be on {h1.device}, got {t.device}")
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def field_tail_cuda(h1, sh, w2, wr1, wr2, wr3):
    """Launch K7 on the card -> (sigma (P,), rgb (P, 3)) f32."""
    _check_cuda_args(h1, sh, w2, wr1, wr2, wr3)
    P = h1.shape[0]
    sigma = torch.empty((P,), dtype=torch.float32, device=h1.device)
    rgb = torch.empty((P, 3), dtype=torch.float32, device=h1.device)
    if P == 0:
        return sigma, rgb
    fn = _build.library("field_tail_fwd").field_tail_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(h1.data_ptr(), sh.data_ptr(), w2.data_ptr(), wr1.data_ptr(),
             wr2.data_ptr(), wr3.data_ptr(), sigma.data_ptr(), rgb.data_ptr(),
             P, torch.cuda.current_stream(h1.device).cuda_stream)
    _build.check(err, "field_tail_fwd")
    field_tail_cuda.launches += 1
    return sigma, rgb


field_tail_cuda.launches = 0


def field_tail(h1, sh, w2, wr1, wr2, wr3):
    """K7 dispatch: the kernel for CUDA tensors, the plain version only for
    CPU tensors.  h1 (P, 64), sh (P, 16), w2 (64, 16), wr1 (32, 64),
    wr2 (64, 64), wr3 (64, 3) -> sigma (P,), rgb (P, 3)."""
    if h1.device.type == "cpu":
        return field_tail_plain(h1, sh, w2, wr1, wr2, wr3)
    return field_tail_cuda(h1.contiguous(), sh.contiguous(), w2.contiguous(),
                           wr1.contiguous(), wr2.contiguous(),
                           wr3.contiguous())
