"""Stripped variants of the packed-f16 encode forward (K9), the counterpart
of the Pallas ablation kernels of benchmarking/micro_pallas_fwd.py.

The TPU bench A/Bs which term of the encode forward costs: the f16 decode,
the trilinear weight, the feature (`ft2`) output, the 128 -> 64 contraction,
or a pure stream of the rows.  Each variant takes rows that are already
gathered, in the TPU's layout: per level l and sample n, 64 u32 words, word
j holding the f16 bits of lane j in its low half and of lane j + 64 in its
high half (`pack_table_f16` of the JAX package).  On the card the variants
are six instances of one kernel (csrc/encode_ablations.cu); beside K1, which
gathers its own corners, they split K1's time into gather and math.

Per level, with u = rows[l, n, :], lo = u & 0xFFFF, hi = u >> 16, and the
lane weights `_wrow` of meta_T[l] (f32, no bf16 rounding):

  full       wr = bf16(dec(lo) * wrow_lo), bf16(dec(hi) * wrow_hi);
             ft2[l, f, n] = sum of the valid lanes = f (mod 4) of wr;
             h1[n] += wr_lo @ bf16(w1big[l, :64]) + wr_hi @ bf16(w1big[l, 64:])
  no_decode  as full with bitcast_f32(u) for both halves
  no_wrow    wr = bf16(dec(lo)), bf16(dec(hi)): no weight and no valid mask
  no_ft      as full, ft2 = 0
  stream     h1[n] += bitcast_f32(u); ft2 = 0
  full_il    as full, rows laid out (N / bn, L, bn, 64)

Products of two bf16 values are exact in f32, so the kernel and the plain
version differ only in the order of their f32 sums.  The rows, meta_T and
w1big of the bench are random: the decoder meets f16 exponent 31, where it
returns 2^16 * (1 + m/1024) * sign and not inf or NaN.

`encode_ablation` dispatches: the plain version for CPU tensors, the kernel
(`CUDA[variant]`, which counts its launches) for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ngp_pl_torch import _build
from ngp_pl_torch.ops.hash_encoding import _bf, _check_tensors

VARIANTS = ("full", "no_decode", "no_wrow", "no_ft", "stream", "full_il")
W, WH, H, F = 128, 64, 64, 4   # lanes per row, u32 words per row, h1, features
N_PTS = 27                     # corner points of a brick row
META_W = 4                     # meta_T rows: px, py, pz, pad
TILE = 128                     # samples per CUDA block: N and bn are multiples


def f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding f16 bits in its low 16 -> f32 values, the
    branchless decoder of the TPU kernel (ngp_pl_tpu/ops/
    hash_encoding_pallas.py:86-102): subnormals are exact, and exponent 31
    gives 2^16 * (1 + m/1024) * sign, not inf or NaN."""
    h = h.to(torch.int64) & 0xFFFF
    s = h >> 15
    e = (h >> 10) & 0x1F
    m = h & 0x3FF
    bits = (s << 31) | ((e + 112) << 23) | (m << 13)
    normal = (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)
    sign = 1.0 - 2.0 * s.to(torch.float32)
    sub = m.to(torch.float32) * 2.0 ** -24 * sign
    return torch.where(e == 0, sub, normal)


def lane_table(F: int = F, W: int = W) -> np.ndarray:
    """(8, W) f32 per-lane constants [cx, cy, cz, valid, 0, 0, 0, 0] of the
    brick-row corner layout (unpaired rows): lane `lane` carries feature
    lane % F of point min(lane // F, 26)."""
    lane = np.arange(W)
    pidx = np.minimum(lane // F, N_PTS - 1)
    zero = np.zeros(W, np.float32)
    return np.stack([(pidx // 9).astype(np.float32),
                     ((pidx // 3) % 3).astype(np.float32),
                     (pidx % 3).astype(np.float32),
                     (lane < N_PTS * F).astype(np.float32),
                     zero, zero, zero, zero])


def feat_selector(F: int = F, W: int = W) -> np.ndarray:
    """(W, F) 0/1 matrix summing the valid lanes of each feature."""
    sel = np.zeros((W, F), np.float32)
    for lane in range(N_PTS * F):
        sel[lane, lane % F] = 1.0
    return sel


def _wrow(meta: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """meta (4, N) p-values + lane table (8, Wk) -> (N, Wk) trilinear lane
    weights ((wx * wy) * wz) * valid, in f32."""
    px, py, pz = (meta[a][:, None] for a in range(3))
    wx = torch.clamp_min(1.0 - (tab[0] - px).abs(), 0.0)
    wy = torch.clamp_min(1.0 - (tab[1] - py).abs(), 0.0)
    wz = torch.clamp_min(1.0 - (tab[2] - pz).abs(), 0.0)
    return wx * wy * wz * tab[3]


def interleave(rows: torch.Tensor, bn: int) -> torch.Tensor:
    """(L, N, 64) rows -> (N / bn, L, bn, 64): a block's levels contiguous."""
    L, N = rows.shape[:2]
    return rows.reshape(L, N // bn, bn, WH).transpose(0, 1).contiguous()


def encode_ablation_plain(variant: str, rows: torch.Tensor,
                          meta_T: torch.Tensor, w1big: torch.Tensor):
    """Plain PyTorch version of one K9 variant: rows (L, N, 64) int32 (the
    u32 bits; (N / bn, L, bn, 64) for full_il), meta_T (L, 4, N) f32, w1big
    (L, 128, 64) f32 -> h1 (N, 64) f32, ft2 (L, 4, N) f32."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    L, _, N = meta_T.shape
    if variant == "full_il":
        rows = rows.transpose(0, 1).reshape(L, N, WH)
    dev = rows.device
    tab = torch.from_numpy(lane_table()).to(dev)
    sel = torch.from_numpy(feat_selector()).to(dev)
    h1 = torch.zeros((N, H), dtype=torch.float32, device=dev)
    ft2 = torch.zeros((L, F, N), dtype=torch.float32, device=dev)
    for l in range(L):
        u = rows[l].contiguous()
        if variant == "stream":
            h1 = h1 + u.view(torch.float32)
            continue
        if variant == "no_decode":
            lo = hi = u.view(torch.float32)
        else:
            u64 = u.to(torch.int64) & 0xFFFFFFFF
            lo, hi = f16_bits_to_f32(u64), f16_bits_to_f32(u64 >> 16)
        if variant != "no_wrow":
            lo = lo * _wrow(meta_T[l], tab[:, :WH])
            hi = hi * _wrow(meta_T[l], tab[:, WH:])
        lo, hi = _bf(lo), _bf(hi)
        if variant != "no_ft":
            ft2[l] = (lo @ sel[:WH] + hi @ sel[WH:]).T
        h1 = h1 + (lo @ _bf(w1big[l, :WH]) + hi @ _bf(w1big[l, WH:]))
    return h1, ft2


class _Kernel:
    """The wrapper of one variant's `extern "C"` entry in
    csrc/encode_ablations.cu; `launches` counts its launches."""

    def __init__(self, variant: str):
        self.variant = variant
        self.launches = 0

    def __call__(self, rows, meta_T, w1big, bn: int = 0):
        L, N = meta_T.shape[0], meta_T.shape[2]
        il = self.variant == "full_il"
        if N % TILE or (il and (bn <= 0 or bn % TILE or N % bn)):
            raise ValueError(f"N={N} must be a multiple of {TILE}, and of "
                             f"bn={bn}, a multiple of {TILE}, for full_il")
        shape = (N // bn, L, bn, WH) if il else (L, N, WH)
        _check_tensors(meta_T.device,
                       ("rows", rows, torch.int32, shape, 16),
                       ("meta_T", meta_T, torch.float32, (L, META_W, N), 16),
                       ("w1big", w1big, torch.float32, (L, W, H), 16))
        h1 = torch.empty((N, H), dtype=torch.float32, device=rows.device)
        ft2 = torch.empty((L, F, N), dtype=torch.float32, device=rows.device)
        entry = f"encode_ablation_{self.variant}"
        fn = getattr(_build.library("encode_ablations"), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        err = fn(rows.data_ptr(), meta_T.data_ptr(), w1big.data_ptr(),
                 h1.data_ptr(), ft2.data_ptr(), N, L, bn,
                 torch.cuda.current_stream(rows.device).cuda_stream)
        _build.check(err, entry)
        self.launches += 1
        return h1, ft2


CUDA = {v: _Kernel(v) for v in VARIANTS}


def encode_ablation(variant: str, rows: torch.Tensor, meta_T: torch.Tensor,
                    w1big: torch.Tensor, bn: int = 0):
    """One K9 variant: the kernel for CUDA tensors, the plain version only
    for CPU tensors.  `bn` is the block of full_il's layout."""
    if rows.device.type == "cpu":
        return encode_ablation_plain(variant, rows, meta_T, w1big)
    return CUDA[variant](rows, meta_T, w1big, bn)
