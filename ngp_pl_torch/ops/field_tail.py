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

Both kernels run the layers on the tensor cores and read the weights as
bf16 B fragments of mma.m16n8k16 in lane order (csrc/field_tail_mma.cuh).
`pack_weights` builds them, once per weight update (keyed on the weights'
storage and version counters); `k7_blocks` and `k8_blocks` size the
kernels' persistent grids.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ngp_pl_torch import _build
from ngp_pl_torch.device import check_current
from ngp_pl_torch.ops.hash_encoding import _bf

H_HID = 64      # hidden width (sigma + rgb MLPs, networks.py:48-77)
H_GEO = 16      # geometry features
H_SH = 16       # SH degree-4 outputs

K7_GROUP = 16   # samples per warp step of K7
K8_TILE = 128   # samples per block step of K8
WARPS = 8       # warps per block, both kernels


def field_tail_supported(cfg) -> bool:
    """The fused tail covers the reference geometry (networks.py:48-77)."""
    return (cfg.rgb_act == "Sigmoid" and cfg.sigma_hidden == H_HID
            and cfg.sigma_layers == 1 and cfg.geo_features == H_GEO
            and cfg.rgb_hidden == H_HID and cfg.rgb_layers == 2
            and cfg.sh_degree == 4)


def _mm(acc):
    """a @ b of bf16-rounded operands, summed in `acc`, returned as f32."""
    return lambda a, b: (_bf(a).to(acc) @ _bf(b).to(acc)).float()


def field_tail_plain(h1, sh, w2, wr1, wr2, wr3, acc=torch.float32):
    """Plain PyTorch version of K7 (see csrc/field_tail_fwd.cu).  Every
    product takes bf16-rounded operands; `acc` is the type of the sums
    (float32 as on the TPU; float64 gives the same function with sums that
    no summation order can change, chip_smoke.py's second yardstick)."""
    mm = _mm(acc)
    h = mm(torch.relu(h1), w2)
    z1 = mm(sh, wr1[:H_SH]) + mm(h, wr1[H_SH:])
    z2 = mm(torch.relu(z1), wr2)
    z3 = mm(torch.relu(z2), wr3)
    sigma = torch.exp(torch.clamp(h[:, 0], -30.0, 30.0))
    return sigma, torch.sigmoid(z3[:, :3])


# --- the kernels' weight fragments ----------------------------------------

# Each layer's weight as the (K, N) operand B of `a @ B`, in the order of
# the fragment sets of csrc/field_tail_mma.cuh: the forward's W2, Wr1, Wr2
# and Wr3 (padded to 8 columns), then the backward's Wr3^T (padded to 16
# rows), Wr2^T, Wr1[16:]^T and W2^T.
FRAGS_FWD = 60      # fragments K7 reads, the first of the 116


def fragments(m):
    """B fragments of a (K, N) operand (K % 16 == 0, N % 8 == 0), numpy:
    (N / 8, K / 16, 32, 4), element [nt, kc, lane] = m[k, 8 nt + lane // 4]
    at k = 16 kc + 2 (lane % 4) + (0, 1, 8, 9), the b0, b1 registers of
    mma.m16n8k16 with the lower k in the low half."""
    K, N = m.shape
    lane = np.arange(32)
    k = (16 * np.arange(K // 16)[None, :, None, None]
         + 2 * (lane % 4)[None, None, :, None]
         + np.array([0, 1, 8, 9])[None, None, None, :])
    n = 8 * np.arange(N // 8)[:, None, None, None] + (lane // 4)[
        None, None, :, None]
    return m[k, n]


def _frag_index() -> np.ndarray:
    """Index of every packed bf16 into [w2 | wr1 | wr2 | wr3 | 0] flat."""
    sizes = (H_HID * H_GEO, (H_SH + H_GEO) * H_HID, H_HID * H_HID, H_HID * 3)
    offs = np.cumsum((0,) + sizes)
    zero = int(offs[-1])
    ids = [np.arange(a, a + s).reshape(shape) for a, s, shape in zip(
        offs[:-1], sizes, ((H_HID, H_GEO), (H_SH + H_GEO, H_HID),
                           (H_HID, H_HID), (H_HID, 3)))]
    w2, wr1, wr2, wr3 = ids
    wr3p = np.full((H_HID, 8), zero)
    wr3p[:, :3] = wr3
    wr3t = np.full((16, H_HID), zero)
    wr3t[:3] = wr3.T
    mats = (w2, wr1, wr2, wr3p, wr3t, wr2.T, wr1[H_SH:].T, w2.T)
    return np.concatenate([fragments(m).reshape(-1, 32, 4) for m in mats])


_FRAG_INDEX = {}
_PACKED = {}


def pack_weights(w2, wr1, wr2, wr3):
    """The 116 bf16 B fragments both kernels read, (116, 32, 4) on the
    weights' device.  Rebuilt only when a weight changed: an in-place
    update bumps its version counter, a new tensor has other storage (the
    cache holds the weights it was built from, so their storage stays
    theirs)."""
    dev = w2.device
    ws = (w2, wr1, wr2, wr3)
    key = tuple((w.data_ptr(), w._version, tuple(w.shape)) for w in ws)
    hit = _PACKED.get(dev)
    if hit is not None and hit[1] == key:
        return hit[2]
    if dev not in _FRAG_INDEX:
        _FRAG_INDEX[dev] = torch.from_numpy(_frag_index()).to(dev)
    with torch.no_grad():
        flat = torch.cat([w.detach().reshape(-1).float() for w in ws]
                         + [w2.new_zeros(1, dtype=torch.float32)])
        packed = flat.to(torch.bfloat16)[_FRAG_INDEX[dev]]
    _PACKED[dev] = (tuple(w.detach() for w in ws), key, packed)
    return packed


def k7_blocks(P: int, sms: int) -> int:
    """K7's persistent grid: two blocks of 8 warps per SM, no more than the
    groups of 16 samples need; 0 for P = 0 (no launch)."""
    groups = -(-P // K7_GROUP)
    return min(2 * sms, -(-groups // WARPS))


def k8_blocks(P: int, sms: int) -> int:
    """K8's persistent grid (and rows of its partial buffer): one block per
    SM, no more than the tiles of 128 samples; 0 for P = 0 (no launch)."""
    return min(sms, -(-P // K8_TILE))


# --- K7 --------------------------------------------------------------------

def _check_cuda(name, t, device, shape):
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not (
            t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_cuda_args(h1, sh, w2, wr1, wr2, wr3):
    P = h1.shape[0]
    for name, t, shape in (("h1", h1, (P, H_HID)), ("sh", sh, (P, H_SH)),
                           ("w2", w2, (H_HID, H_GEO)),
                           ("wr1", wr1, (H_SH + H_GEO, H_HID)),
                           ("wr2", wr2, (H_HID, H_HID)), ("wr3", wr3, (H_HID, 3))):
        _check_cuda(name, t, h1.device, shape)
    check_current(h1.device)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int):
    """The C entry `name` of its library: n_ptrs pointers, two ints (the
    sample count and the grid) and the stream; returns an int."""
    fn = getattr(_build.library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return fn


def field_tail_cuda(h1, sh, w2, wr1, wr2, wr3):
    """Launch K7 on the card -> (sigma (P,), rgb (P, 3)) f32."""
    _check_cuda_args(h1, sh, w2, wr1, wr2, wr3)
    P = h1.shape[0]
    sigma = torch.empty((P,), dtype=torch.float32, device=h1.device)
    rgb = torch.empty((P, 3), dtype=torch.float32, device=h1.device)
    if P == 0:
        return sigma, rgb
    wpack = pack_weights(w2, wr1, wr2, wr3)
    err = _entry("field_tail_fwd", 5)(
        h1.data_ptr(), sh.data_ptr(), wpack.data_ptr(), sigma.data_ptr(),
        rgb.data_ptr(), P, k7_blocks(P, _sms(h1.device)), _stream(h1.device))
    _build.check(err, "field_tail_fwd")
    field_tail_cuda.launches += 1
    return sigma, rgb


field_tail_cuda.launches = 0


def _dense(t):
    """Contiguous and 16-byte aligned, as the kernels read 16-byte chunks
    (a contiguous view may start inside its storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def field_tail(h1, sh, w2, wr1, wr2, wr3):
    """K7 dispatch: the kernel for CUDA tensors, the plain version only for
    CPU tensors.  h1 (P, 64), sh (P, 16), w2 (64, 16), wr1 (32, 64),
    wr2 (64, 64), wr3 (64, 3) -> sigma (P,), rgb (P, 3)."""
    if h1.device.type == "cpu":
        return field_tail_plain(h1, sh, w2, wr1, wr2, wr3)
    return field_tail_cuda(*(_dense(t) for t in (h1, sh, w2, wr1, wr2, wr3)))


# --- K8 --------------------------------------------------------------------

# weight-gradient layout of the K8 kernel's flat output
_WGRAD_SHAPES = ((H_HID, H_GEO), (H_SH + H_GEO, H_HID), (H_HID, H_HID),
                 (H_HID, 3))


def field_tail_bwd_plain(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3,
                         acc=torch.float32):
    """Plain PyTorch version of K8 (see csrc/field_tail_bwd.cu), the math of
    `_bwd_kernel` (field_pallas.py:93-134).  Returns (dh1 (P, 64),
    dW2 (64, 16), dWr1 (32, 64), dWr2 (64, 64), dWr3 (64, 3)).  Every
    product takes bf16-rounded operands; `acc` is the type of the sums, as
    in `field_tail_plain`."""
    mm = _mm(acc)
    x = torch.relu(h1)
    h = mm(x, w2)
    z1 = mm(sh, wr1[:H_SH]) + mm(h, wr1[H_SH:])
    r1 = torch.relu(z1)
    z2 = mm(r1, wr2)
    r2 = torch.relu(z2)
    rgb = torch.sigmoid(mm(r2, wr3))
    d_z3 = g_rgb * rgb * (1.0 - rgb)
    d_z2 = torch.where(z2 > 0, mm(d_z3, wr3.T), 0.0)
    d_z1 = torch.where(z1 > 0, mm(d_z2, wr2.T), 0.0)
    d_h = mm(d_z1, wr1[H_SH:].T)
    d_h[:, 0] += g_sigma * torch.exp(torch.clamp(h[:, 0], -15.0, 15.0))
    dh1 = torch.where(h1 > 0, mm(d_h, w2.T), 0.0)
    dwr1 = torch.cat([mm(sh.T, d_z1), mm(h.T, d_z1)], dim=0)
    return dh1, mm(x.T, d_h), dwr1, mm(r1.T, d_z2), mm(r2.T, d_z3)


def field_tail_bwd_cuda(h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3):
    """Launch K8 on the card (same outputs as the plain version)."""
    _check_cuda_args(h1, sh, w2, wr1, wr2, wr3)
    P = h1.shape[0]
    _check_cuda("g_sigma", g_sigma, h1.device, (P,))
    _check_cuda("g_rgb", g_rgb, h1.device, (P, 3))
    dh1 = torch.empty((P, H_HID), dtype=torch.float32, device=h1.device)
    n_grads = sum(a * b for a, b in _WGRAD_SHAPES)
    if P == 0:
        wgrad = torch.zeros(n_grads, dtype=torch.float32, device=h1.device)
    else:
        # the kernel's second pass writes every weight gradient
        wgrad = torch.empty(n_grads, dtype=torch.float32, device=h1.device)
        n_blocks = k8_blocks(P, _sms(h1.device))
        partial = torch.empty((n_blocks, n_grads), dtype=torch.float32,
                              device=h1.device)
        wpack = pack_weights(w2, wr1, wr2, wr3)
        err = _entry("field_tail_bwd", 8)(
            h1.data_ptr(), sh.data_ptr(), g_sigma.data_ptr(),
            g_rgb.data_ptr(), wpack.data_ptr(), dh1.data_ptr(),
            wgrad.data_ptr(), partial.data_ptr(), P, n_blocks,
            _stream(h1.device))
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
    return field_tail_bwd_cuda(*(_dense(t) for t in (
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
