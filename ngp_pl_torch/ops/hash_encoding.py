"""Multiresolution brick-row hash encoding + first dense layer (K1).

Counterpart of ngp_pl_tpu/ops/hash_encoding.py and the packed-f16 forward of
ngp_pl_tpu/ops/hash_encoding_pallas.py.  The table layout is the JAX
package's: each level is a grid of 2x2x2-cell bricks, one table row per brick
holding its 3x3x3 corner points x F features (108 of 128 floats at F=4);
coarse levels are stored dense, finer levels hash the brick coordinate with
the Instant-NGP primes.  Any sample's 8 trilinear corners lie in one row.

The render path reads an f16 copy of the table (`table_f16`), tinycudann's
table precision; the TPU swizzled it into u32 lanes only as a layout trick.

`hash_encode_fwd` is K1's wrapper: on a CUDA tensor it launches the kernel
of csrc/hash_encode_fwd.cu, on a CPU tensor it runs `hash_encode_fwd_plain`,
which keeps the TPU kernel's rounding points (bf16 trilinear weights, bf16
weighted row values, bf16 w1, f32 accumulation).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ngp_pl_torch import _build

# Instant-NGP spatial hash primes (pi_1 = 1 implicitly on x).
PRIMES = (1, 2654435761, 805459861)

BRICK_CELLS = 2               # cells per brick edge
BRICK_PTS = BRICK_CELLS + 1   # corner points per edge (3x3x3 = 27)
F16_MAX = 65504.0


@dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of the multiresolution brick table."""

    n_levels: int
    n_features: int
    log2_bricks: int               # hashed-level brick-slot budget S = 2**lb
    resolutions: Tuple[int, ...]   # R_l: cells per axis at level l
    brick_grids: Tuple[int, ...]   # bricks per axis at level l (= ceil(R/2))
    offsets: Tuple[int, ...]       # start row of each level in the table
    sizes: Tuple[int, ...]         # rows per level (dense: B^3, else S)
    row_width: int = 64

    @property
    def total_rows(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def dense(self) -> Tuple[bool, ...]:
        return tuple(s == b ** 3 for s, b in zip(self.sizes, self.brick_grids))


def make_grid_spec(
    n_levels: int = 16,
    n_features: int = 2,
    log2_hashmap_size: int = 19,
    base_resolution: int = 16,
    per_level_scale: float = 1.3819,
    log2_bricks: Optional[int] = None,
) -> HashGridSpec:
    """Same geometry as the JAX package: brick budget S = T/32 (2^19 -> 2^14)
    unless `log2_bricks` overrides it; a level is dense while its brick grid
    fits 2*S rows.  F=2 rows pad 54 -> 64 floats, F=4 rows 108 -> 128."""
    if n_features not in (2, 4):
        raise NotImplementedError("brick layout supports F in {2, 4}")
    if log2_bricks is None:
        log2_bricks = max(1, log2_hashmap_size - 5)
    S = 2 ** log2_bricks
    dense_budget = 2 * S
    resolutions, brick_grids, offsets, sizes = [], [], [], []
    off = 0
    for l in range(n_levels):
        R = int(math.floor(base_resolution * (per_level_scale ** l)))
        B = (R + BRICK_CELLS - 1) // BRICK_CELLS
        size = B ** 3 if B ** 3 <= dense_budget else S
        resolutions.append(R)
        brick_grids.append(B)
        offsets.append(off)
        sizes.append(size)
        off += size
    return HashGridSpec(
        n_levels=n_levels,
        n_features=n_features,
        log2_bricks=log2_bricks,
        resolutions=tuple(resolutions),
        brick_grids=tuple(brick_grids),
        offsets=tuple(offsets),
        sizes=tuple(sizes),
        row_width=64 if n_features == 2 else 128,
    )


def init_hash_table(spec: HashGridSpec,
                    generator: torch.Generator) -> torch.Tensor:
    """U(-1e-4, 1e-4) init, tinycudann's default; pad lanes stay 0."""
    t = torch.rand((spec.total_rows, spec.row_width), generator=generator,
                   dtype=torch.float32) * 2e-4 - 1e-4
    used = BRICK_PTS ** 3 * spec.n_features
    t[:, used:] = 0.0
    return t


def table_f16(table: torch.Tensor) -> torch.Tensor:
    """f16 copy of the f32 table, clamped to the f16 finite range (an
    overflowing weight would otherwise become inf)."""
    return table.clamp(-F16_MAX, F16_MAX).half()


def slots_local_frac_lm(x: torch.Tensor, spec: HashGridSpec):
    """Level-major slot (L, N) int64 global row ids, local (L, N, 3) int64 in
    {0, 1} and frac (L, N, 3) f32.  x must already be clipped to [0, 1].

    The hash is computed in int64 and masked: brick coordinates are < 2^10,
    so the low 32 bits of each product equal the uint32 wrapping product."""
    dev = x.device
    res = torch.tensor(spec.resolutions, dtype=torch.float32, device=dev)
    res_i = torch.tensor(spec.resolutions, dtype=torch.int64, device=dev)
    bgrid = torch.tensor(spec.brick_grids, dtype=torch.int64, device=dev)
    level_off = torch.tensor(spec.offsets, dtype=torch.int64, device=dev)
    dense_mask = torch.tensor(spec.dense, device=dev)

    pos = x[None, :, :] * res[:, None, None]                    # (L, N, 3)
    cell = torch.floor(pos)
    frac = pos - cell
    cell = torch.minimum(cell.to(torch.int64).clamp_min(0),
                         res_i[:, None, None] - 1)
    brick = cell >> 1
    local = cell & 1
    hashed = (brick[..., 0] * PRIMES[0] ^ brick[..., 1] * PRIMES[1]
              ^ brick[..., 2] * PRIMES[2]) & (2 ** spec.log2_bricks - 1)
    dense = ((brick[..., 0] * bgrid[:, None] + brick[..., 1])
             * bgrid[:, None] + brick[..., 2])
    slot = torch.where(dense_mask[:, None], dense, hashed)
    return slot + level_off[:, None], local, frac


def expand_w1(w1: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """(L*F, H) first-layer weight -> (L, W, H) per-lane form: lane `lane`
    of level l carries feature `lane % F`."""
    L, F, W = spec.n_levels, spec.n_features, spec.row_width
    lane = torch.arange(W, device=w1.device)
    idx = torch.arange(L, device=w1.device)[:, None] * F + (lane % F)[None, :]
    return w1[idx.reshape(-1)].reshape(L, W, w1.shape[-1])


def _bf(a: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: products of two such values are exact in f32,
    which is how the plain versions emulate bf16 operands with f32 sums."""
    return a.to(torch.bfloat16).to(torch.float32)


# corner c of a sample's cell: offsets (c >> 2, c >> 1, c) & 1
_CORNER_BITS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def _hat(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - torch.abs(c - p), 0.0)


def hash_encode_fwd_plain(x: torch.Tensor, table16: torch.Tensor,
                          w1: torch.Tensor, spec: HashGridSpec,
                          feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (see csrc/hash_encode_fwd.cu).

    Per level it gathers only the 8 corner points x F halves a sample needs
    from its brick row; the 19 other points of the row have weight exactly 0
    in the TPU kernel's 27-point sum."""
    L, F = spec.n_levels, spec.n_features
    slot, local, frac = slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
    p = local.to(torch.float32) + frac                          # (L, N, 3)
    corner = torch.tensor(_CORNER_BITS, device=x.device)        # (8, 3)
    lanes = torch.arange(F, device=x.device)
    flat = table16.reshape(-1)
    per_level = []
    for l in range(L):                  # one level at a time bounds memory
        pt_c = local[l, :, None, :] + corner[None]              # (N, 8, 3)
        w = _hat(pt_c.to(torch.float32), p[l, :, None, :])
        w8 = _bf(w[..., 0] * w[..., 1] * w[..., 2])             # (N, 8)
        pt = (pt_c[..., 0] * 3 + pt_c[..., 1]) * 3 + pt_c[..., 2]
        idx = (slot[l, :, None, None] * spec.row_width
               + pt[..., None] * F + lanes)                     # (N, 8, F)
        vals = flat[idx].to(torch.float32)
        per_level.append(_bf(vals * w8[..., None]).sum(dim=1))  # (N, F)
    f = torch.cat(per_level, dim=1)                             # (N, L*F)
    if feats is not None:
        feats.copy_(f)
    return f @ _bf(w1)


def _check_cuda_args(x, table16, w1, spec, feats):
    """The kernel's own contract: F=4 rows of 128 halves, so the shapes of
    the table and w1 pin F whatever `spec` says."""
    L, F = spec.n_levels, 4
    if L > 16:
        raise ValueError(f"at most 16 levels, got {L}")
    for name, t, dt, shape in (
            ("x", x, torch.float32, (x.shape[0], 3)),
            ("table16", table16, torch.float16, (spec.total_rows, 128)),
            ("w1", w1, torch.float32, (L * F, 64))):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if table16.data_ptr() % 16:
        raise ValueError("table16 must be 16-byte aligned")
    if feats is not None:
        if (feats.device != x.device or feats.dtype != torch.float32
                or tuple(feats.shape) != (x.shape[0], L * F)
                or not feats.is_contiguous() or feats.data_ptr() % 16):
            raise ValueError("feats must be a contiguous, 16-byte aligned "
                             f"f32 ({x.shape[0]}, {L * F}) tensor on the card")


def hash_encode_fwd_cuda(x: torch.Tensor, table16: torch.Tensor,
                         w1: torch.Tensor, spec: HashGridSpec,
                         feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on the card: x (N, 3) f32, table16 (rows, 128) f16,
    w1 (L*F, 64) f32 -> h1 (N, 64) f32 (+ feats (N, L*F) when given)."""
    _check_cuda_args(x, table16, w1, spec, feats)
    N = x.shape[0]
    h1 = torch.empty((N, 64), dtype=torch.float32, device=x.device)
    if N == 0:
        return h1
    L = spec.n_levels
    ints = ctypes.c_int * L
    lib = _build.library("hash_encode_fwd")
    fn = lib.hash_encode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    err = fn(x.data_ptr(), table16.data_ptr(), w1.data_ptr(), h1.data_ptr(),
             feats.data_ptr() if feats is not None else None, N, L,
             spec.log2_bricks, ints(*spec.resolutions), ints(*spec.brick_grids),
             ints(*spec.offsets), ints(*[int(d) for d in spec.dense]),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "hash_encode_fwd")
    hash_encode_fwd_cuda.launches += 1
    return h1


hash_encode_fwd_cuda.launches = 0


def hash_encode_fwd(x: torch.Tensor, table16: torch.Tensor,
                    w1: torch.Tensor, spec: HashGridSpec,
                    feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused hash encoding + first dense layer, forward only (K1; the
    counterpart of `hash_encode_mlp(..., need_x_grad=False)`).

    x: (N, 3) in [0, 1]^3 (clipped here); table16: the f16 table copy;
    w1: (L*F, H).  Returns the (N, H) f32 pre-activation.  The kernel runs
    for CUDA tensors, the plain version only for CPU tensors."""
    if spec.n_features != 4 or spec.row_width != 128:
        raise NotImplementedError(
            "the render slice covers the F=4 brick rows (K1); the F=2 "
            "geometry (K3) is a later slice")
    if x.device.type == "cpu":
        return hash_encode_fwd_plain(x, table16, w1, spec, feats)
    return hash_encode_fwd_cuda(x, table16, w1, spec, feats)
