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
(`CUDA[variant]`, which counts its launches) for CUDA tensors.  A
contracting variant's call first packs w1big into bf16 `mma` B fragments
on the card, once per call, in the layout `pack_w1_layout` spells out.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ngp_pl_torch import _build
from ngp_pl_torch.ops.hash_encoding import _bf, _check_tensors

VARIANTS = ("full", "no_decode", "no_wrow", "no_ft", "stream", "full_il")
W, WH, H, F = 128, 64, 64, 4   # lanes per row, u32 words per row, h1, features
N_PTS = 27                     # corner points of a brick row
META_W = 4                     # meta_T rows: px, py, pz, pad
TILE = 128                     # samples per kernel item: N and bn are multiples
W1P_WORDS = W * H // 2         # u32 words of one level's packed bf16 w1


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


def pack_w1_layout(w1big: torch.Tensor) -> torch.Tensor:
    """The kernel's packed w1, in PyTorch: w1big (L, 128, 64) f32 -> (L, 8,
    4, 32, 4, 2) bf16 [l][kc][ntp][lane][q][half], the `mma` B fragments of
    k-chunk kc = 2 cp + h for lane (g, t) = (lane >> 2, lane & 3): q = 0, 1
    are b0, b1 of n-tile 2 ntp, q = 2, 3 those of n-tile 2 ntp + 1; b0 (b1)
    holds lanes j and j + 64 of w1's rows, j = 16 cp + 4 t + 2 h (+ 1), in
    column 8 nt + g.  The kernel's A fragments permute the 128 lanes the same
    way, so each k-chunk pairs the row values of lanes j and j + 64 with
    these weights."""
    L = w1big.shape[0]
    kc, ntp, lane, q = torch.meshgrid(torch.arange(8), torch.arange(4),
                                      torch.arange(32), torch.arange(4),
                                      indexing="ij")
    col = (2 * ntp + (q >> 1)) * 8 + (lane >> 2)
    j = 16 * (kc >> 1) + 4 * (lane & 3) + 2 * (kc & 1) + (q & 1)
    w = w1big.to(torch.bfloat16)
    pairs = torch.stack([w[:, j, col], w[:, j + WH, col]], dim=-1)
    return pairs.reshape(L, 8, 4, 32, 4, 2)


class _Kernel:
    """The wrapper of one variant's `extern "C"` entry in
    csrc/encode_ablations.cu; `launches` counts its launches."""

    def __init__(self, variant: str):
        self.variant = variant
        self.launches = 0
        self._il = variant == "full_il"
        self._stream = variant == "stream"

    @functools.cached_property
    def _fn(self):
        entry = f"encode_ablation_{self.variant}"
        fn = getattr(_build.library("encode_ablations"), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        return fn

    def __call__(self, rows, meta_T, w1big, bn: int = 0):
        L, _, N = meta_T.shape
        if N % TILE or (self._il and (bn <= 0 or bn % TILE or N % bn)):
            raise ValueError(f"N={N} must be a multiple of {TILE}, and of "
                             f"bn={bn}, a multiple of {TILE}, for full_il")
        shape = (N // bn, L, bn, WH) if self._il else (L, N, WH)
        # the checks of `_check_tensors` written out, since the host's work
        # before the launch is part of the call's event time; on a miss
        # `_check_tensors` says what is wrong
        dev = meta_T.get_device()
        p_rows, p_meta, p_w1 = rows.data_ptr(), meta_T.data_ptr(), \
            w1big.data_ptr()
        if not (dev >= 0 and rows.get_device() == dev
                and w1big.get_device() == dev and rows.dtype is torch.int32
                and meta_T.dtype is torch.float32
                and w1big.dtype is torch.float32 and rows.shape == shape
                and meta_T.shape[1] == META_W and w1big.shape == (L, W, H)
                and rows.is_contiguous() and meta_T.is_contiguous()
                and w1big.is_contiguous() and (p_rows | p_meta | p_w1) % 16
                == 0):
            _check_tensors(meta_T.device,
                           ("rows", rows, torch.int32, shape, 16),
                           ("meta_T", meta_T, torch.float32, (L, META_W, N),
                            16),
                           ("w1big", w1big, torch.float32, (L, W, H), 16))
        # h1, ft2 and (but for stream) the packed w1 in one allocation, the
        # views made after the launch
        n_h1, n_ft2 = N * H, L * F * N
        buf = torch.empty(n_h1 + n_ft2 + (0 if self._stream
                                          else L * W1P_WORDS),
                          dtype=torch.float32, device=rows.device)
        base = buf.data_ptr()
        err = self._fn(p_rows, p_meta, p_w1,
                       None if self._stream else base + 4 * (n_h1 + n_ft2),
                       base, base + 4 * n_h1, N, L, bn,
                       torch._C._cuda_getCurrentRawStream(dev))
        _build.check(err, f"encode_ablation_{self.variant}")
        self.launches += 1
        return (buf[:n_h1].view(N, H),
                buf[n_h1:n_h1 + n_ft2].view(L, F, N))


def pack_w1_cuda(w1big: torch.Tensor) -> torch.Tensor:
    """The kernels' own pack of w1big (L, 128, 64) f32 on the card, as
    (L * 8,192,) int32 words of bf16 pairs (`pack_w1_layout`'s order)."""
    L = w1big.shape[0]
    _check_tensors(w1big.device,
                   ("w1big", w1big, torch.float32, (L, W, H), 16))
    w1p = torch.empty((L * W1P_WORDS,), dtype=torch.int32,
                      device=w1big.device)
    fn = _build.library("encode_ablations").encode_ablation_pack_w1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    _build.check(fn(w1big.data_ptr(), w1p.data_ptr(), L,
                    torch.cuda.current_stream(w1big.device).cuda_stream),
                 "encode_ablation_pack_w1")
    return w1p


CUDA = {v: _Kernel(v) for v in VARIANTS}


def encode_ablation(variant: str, rows: torch.Tensor, meta_T: torch.Tensor,
                    w1big: torch.Tensor, bn: int = 0):
    """One K9 variant: the kernel for CUDA tensors, the plain version only
    for CPU tensors.  `bn` is the block of full_il's layout."""
    if rows.device.type == "cpu":
        return encode_ablation_plain(variant, rows, meta_T, w1big)
    return CUDA[variant](rows, meta_T, w1big, bn)
