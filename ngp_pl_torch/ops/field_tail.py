"""Fused field tail: sigma-net layer 2 + TruncExp + rgb MLP + sigmoid,
forward (K7) and backward (K8).

Counterpart of ngp_pl_tpu/ops/field_pallas.py.  Layouts are sample-major
(h1 (P, 64), sh (P, 16), sigma (P,), rgb (P, 3)).

`field_tail` is K7's wrapper: on CUDA tensors it launches the kernel of
csrc/field_tail_fwd.cu, on CPU tensors it runs `field_tail_plain`, which
keeps the TPU kernel's numerics: bf16-rounded operands and f32 accumulation
at every product, the +/-30 clamp before exp, sigmoid on the rgb outputs.
`field_tail_bwd` is K8's wrapper (csrc/field_tail_bwd.cu, plain version
`field_tail_bwd_plain`), and `field_tail_fn` the differentiable op
(`FieldTail`, the custom VJP of `field_tail` in field_pallas.py:152-230):
K7 forward, K8 backward, no gradient to sh.
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


# weight-gradient layout of the K8 kernel's flat output
_WGRAD_SHAPES = ((H_HID, H_GEO), (H_SH + H_GEO, H_HID), (H_HID, H_HID),
                 (H_HID, 3))


def field_tail_bwd_plain(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3):
    """Plain PyTorch version of K8 (see csrc/field_tail_bwd.cu), the math of
    `_bwd_kernel` (field_pallas.py:93-134).  Returns (dh1 (P, 64),
    dW2 (64, 16), dWr1 (32, 64), dWr2 (64, 64), dWr3 (64, 3))."""
    x = torch.relu(h1)
    h = _bf(x) @ _bf(w2)
    z1 = _bf(sh) @ _bf(wr1[:H_SH]) + _bf(h) @ _bf(wr1[H_SH:])
    r1 = torch.relu(z1)
    z2 = _bf(r1) @ _bf(wr2)
    r2 = torch.relu(z2)
    rgb = torch.sigmoid(_bf(r2) @ _bf(wr3))
    d_z3 = g_rgb * rgb * (1.0 - rgb)
    d_z2 = torch.where(z2 > 0, _bf(d_z3) @ _bf(wr3).T, 0.0)
    d_z1 = torch.where(z1 > 0, _bf(d_z2) @ _bf(wr2).T, 0.0)
    d_h = _bf(d_z1) @ _bf(wr1[H_SH:]).T
    d_h[:, 0] += g_sigma * torch.exp(torch.clamp(h[:, 0], -15.0, 15.0))
    dh1 = torch.where(h1 > 0, _bf(d_h) @ _bf(w2).T, 0.0)
    dwr1 = torch.cat([_bf(sh).T @ _bf(d_z1), _bf(h).T @ _bf(d_z1)], dim=0)
    return (dh1, _bf(x).T @ _bf(d_h), dwr1, _bf(r1).T @ _bf(d_z2),
            _bf(r2).T @ _bf(d_z3))


def field_tail_bwd_cuda(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3):
    """Launch K8 on the card (same outputs as the plain version)."""
    _check_cuda_args(h1, sh, w2, wr1, wr2, wr3)
    P = h1.shape[0]
    for name, t, shape in (("g_sigma", g_sigma, (P,)), ("g_rgb", g_rgb, (P, 3))):
        if (t.device != h1.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float32 {shape} on "
                             f"{h1.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    dh1 = torch.empty((P, H_HID), dtype=torch.float32, device=h1.device)
    wgrad = torch.zeros(sum(a * b for a, b in _WGRAD_SHAPES),
                        dtype=torch.float32, device=h1.device)
    if P > 0:
        sms = torch.cuda.get_device_properties(h1.device).multi_processor_count
        n_blocks = min(-(-P // 128), 2 * sms)
        partial = torch.empty((n_blocks, wgrad.numel()), dtype=torch.float32,
                              device=h1.device)
        fn = _build.library("field_tail_bwd").field_tail_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        err = fn(h1.data_ptr(), sh.data_ptr(), g_sigma.data_ptr(),
                 g_rgb.data_ptr(), w2.data_ptr(), wr1.data_ptr(),
                 wr2.data_ptr(), wr3.data_ptr(), dh1.data_ptr(),
                 wgrad.data_ptr(), partial.data_ptr(), P, n_blocks,
                 torch.cuda.current_stream(h1.device).cuda_stream)
        _build.check(err, "field_tail_bwd")
        field_tail_bwd_cuda.launches += 1
    grads, off = [], 0
    for a, b in _WGRAD_SHAPES:
        grads.append(wgrad[off:off + a * b].view(a, b))
        off += a * b
    return (dh1, *grads)


field_tail_bwd_cuda.launches = 0


def field_tail_bwd(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3):
    """K8 dispatch: the kernel for CUDA tensors, the plain version only for
    CPU tensors."""
    if h1.device.type == "cpu":
        return field_tail_bwd_plain(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3)
    return field_tail_bwd_cuda(*(t.contiguous() for t in (
        h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3)))


class FieldTail(torch.autograd.Function):
    """(sigma, rgb) = field tail of h1 and sh: K7 forward, K8 backward."""

    @staticmethod
    def forward(ctx, h1, sh, w2, wr1, wr2, wr3):
        ctx.save_for_backward(h1, sh, w2, wr1, wr2, wr3)
        return field_tail(h1, sh, w2, wr1, wr2, wr3)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        h1, sh, *ws = ctx.saved_tensors
        dh1, *dws = field_tail_bwd(h1, sh, g_sigma, g_rgb,
                                   *(w.detach() for w in ws))
        return (dh1, None, *dws)


def field_tail_fn(h1, sh, w2, wr1, wr2, wr3):
    """Differentiable K7: h1 (P, 64), sh (P, 16) and the four weights ->
    sigma (P,), rgb (P, 3)."""
    return FieldTail.apply(h1, sh, w2, wr1, wr2, wr3)
