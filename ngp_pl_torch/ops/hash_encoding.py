"""Multiresolution brick-row hash encoding + first dense layer (K1, K3).

Counterpart of ngp_pl_tpu/ops/hash_encoding.py and the forward and backward
kernels of ngp_pl_tpu/ops/hash_encoding_pallas.py.  The table layout is the
JAX package's: each level is a grid of 2x2x2-cell bricks, one table row per
brick holding its 3x3x3 corner points x F features (108 of 128 floats at
F=4, 54 of 64 at F=2); coarse levels are stored dense, finer levels hash the
brick coordinate with the Instant-NGP primes.  Any sample's 8 trilinear
corners lie in one row.

The two geometries read the table as the TPU kernels do (`encode_table`):
F=4 an f16 copy (`table_f16`), tinycudann's table precision, which the TPU
swizzled into u32 lanes only as a layout trick; F=2 the f32 table itself,
as the TPU gathered f32 rows for 64-wide rows.

`hash_encode_fwd` dispatches the forward: on a CUDA tensor it launches K1
(F=4, `hash_encode_fwd_cuda`) or K3 (F=2, `hash_encode_fwd_f2_cuda`), both
instances of the kernel in csrc/hash_encode_fwd.cu; on a CPU tensor it runs
`hash_encode_fwd_plain`, which keeps the TPU kernels' rounding points (bf16
trilinear weights at F=4 only, bf16 weighted row values, bf16 w1, f32
accumulation).

`hash_encode_bwd` dispatches the table gradient likewise: K2 fused with the
K5 scatter and the hashed levels' scatter-add (F=4,
`hash_encode_bwd_cuda`) or K4 fused with the per-level scatter-add (F=2,
`hash_encode_bwd_f2_cuda`), both in csrc/hash_encode_bwd.cu, with
`hash_encode_bwd_plain` beside them.  Each CUDA wrapper counts its own
launches.  `hash_encode_mlp` is the differentiable op (`HashEncodeMLP`, the
counterpart of `_encode_mlp_pl_cv`, ngp_pl_tpu/ops/hash_encoding.py:516-606):
its forward is K1 or K3, its backward the table-gradient kernel plus
d_w1 = feats^T g as a matmul, which the TPU left to XLA as well.  No
position gradient is produced (`need_x_grad=False`, the flagship case).
With a position gradient (pose refinement) the encode is
`hash_encode_mlp_xgrad`, the counterpart of the XLA `_encode_mlp_cv`
(:401-480), as PyTorch ops on both devices: another function than K1's.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.device import check_current

# Instant-NGP spatial hash primes (pi_1 = 1 implicitly on x).
PRIMES = (1, 2654435761, 805459861)

BRICK_CELLS = 2               # cells per brick edge
BRICK_PTS = BRICK_CELLS + 1   # corner points per edge (3x3x3 = 27)
F16_MAX = 65504.0
MAX_LEVELS = 16               # the kernels' per-level arrays


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


# The table the encode reads, by F: its dtype and whether a corner's
# trilinear weight is rounded to bf16.  F=4 reads the f16 copy, and its TPU
# kernel expands the weights with a bf16 dot (`_expand_w27`); F=2 reads the
# f32 table, and its TPU kernel keeps the weights in f32 (`_wrow`).
_ROW_DTYPE = {4: torch.float16, 2: torch.float32}


def _rounds_corner_weight(spec: HashGridSpec) -> bool:
    return spec.n_features == 4


def encode_table(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """The table the encode reads: the f16 copy at F=4, the f32 table
    itself at F=2."""
    return table_f16(table) if spec.n_features == 4 else table


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


def _level_corners(x: torch.Tensor, spec: HashGridSpec):
    """Yields, per level, the flat table index (N, 8, F) of each corner's F
    features and the corner weights (N, 8): ((hat_x * hat_y) * hat_z),
    bf16-rounded at F=4.  Only the 8 corner points of a sample's row; the
    19 others have weight exactly 0 in the TPU kernels' 27-point sums."""
    F, W = spec.n_features, spec.row_width
    slot, local, frac = slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
    p = local.to(torch.float32) + frac                          # (L, N, 3)
    corner = torch.tensor(_CORNER_BITS, device=x.device)        # (8, 3)
    lanes = torch.arange(F, device=x.device)
    for l in range(spec.n_levels):      # one level at a time bounds memory
        pt_c = local[l, :, None, :] + corner[None]              # (N, 8, 3)
        w = _hat(pt_c.to(torch.float32), p[l, :, None, :])
        w8 = w[..., 0] * w[..., 1] * w[..., 2]                  # (N, 8)
        if _rounds_corner_weight(spec):
            w8 = _bf(w8)
        pt = (pt_c[..., 0] * 3 + pt_c[..., 1]) * 3 + pt_c[..., 2]
        yield slot[l, :, None, None] * W + pt[..., None] * F + lanes, w8


def hash_encode_fwd_plain(x: torch.Tensor, table: torch.Tensor,
                          w1: torch.Tensor, spec: HashGridSpec,
                          feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (F=4) and K3 (F=2), see
    csrc/hash_encode_fwd.cu.  `table` is the table the encode reads
    (`encode_table`)."""
    flat = table.reshape(-1)
    per_level = []
    for idx, w8 in _level_corners(x, spec):
        vals = flat[idx].to(torch.float32)                      # (N, 8, F)
        per_level.append(_bf(vals * w8[..., None]).sum(dim=1))  # (N, F)
    f = torch.cat(per_level, dim=1)                             # (N, L*F)
    if feats is not None:
        feats.copy_(f)
    return f @ _bf(w1)


def _check_tensors(dev: torch.device, *tensors) -> None:
    """Each (name, tensor, dtype, shape, alignment) must be a contiguous
    tensor of that dtype and shape, aligned to that many bytes, on the CUDA
    device `dev`, which must be the current one.  Dtypes and shapes are
    checked before devices, so that a table of the wrong kind is named as
    such on any device."""
    for name, t, dt, shape, align in tensors:
        if (t.dtype != dt or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{name}: want a contiguous, {align}-byte "
                             f"aligned {dt} {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t, *_ in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on the CUDA device of x, got "
                             f"{t.device}")
    check_current(dev)


def _check_spec(spec: HashGridSpec, F: int) -> None:
    if spec.n_features != F:
        raise ValueError(f"this kernel encodes F={F} features per level, the "
                         f"grid has F={spec.n_features}")
    if spec.n_levels > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {spec.n_levels}")


def _level_args(spec: HashGridSpec):
    ints = ctypes.c_int * spec.n_levels
    return (spec.n_levels, spec.log2_bricks, ints(*spec.resolutions),
            ints(*spec.brick_grids), ints(*spec.offsets),
            ints(*[int(d) for d in spec.dense]))


def _launch_fwd(wrapper, entry: str, F: int, x, table, w1, spec, feats):
    """The kernel's own contract for F features per level: F=4 (K1) reads
    the f16 copy in rows of 128 halves, F=2 (K3) the f32 table in rows of
    64 floats; the shapes of the table and w1 pin F whatever `spec` says.
    Counts the launch on `wrapper`."""
    _check_spec(spec, F)
    N, L = x.shape[0], spec.n_levels
    tensors = [("x", x, torch.float32, (N, 3), 1),
               ("table", table, _ROW_DTYPE[F], (spec.total_rows, 32 * F), 16),
               ("w1", w1, torch.float32, (L * F, 64), 1)]
    if feats is not None:
        tensors.append(("feats", feats, torch.float32, (N, L * F), 16))
    _check_tensors(x.device, *tensors)
    h1 = torch.empty((N, 64), dtype=torch.float32, device=x.device)
    if N == 0:
        return h1
    fn = getattr(_build.library("hash_encode_fwd"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    err = fn(x.data_ptr(), table.data_ptr(), w1.data_ptr(), h1.data_ptr(),
             feats.data_ptr() if feats is not None else None, N,
             *_level_args(spec),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    wrapper.launches += 1
    return h1


def hash_encode_fwd_cuda(x: torch.Tensor, table16: torch.Tensor,
                         w1: torch.Tensor, spec: HashGridSpec,
                         feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on the card (F=4): x (N, 3) f32, table16 (rows, 128) f16,
    w1 (L*4, 64) f32 -> h1 (N, 64) f32 (+ feats (N, L*4) when given)."""
    return _launch_fwd(hash_encode_fwd_cuda, "hash_encode_fwd", 4, x,
                       table16, w1, spec, feats)


hash_encode_fwd_cuda.launches = 0


def hash_encode_fwd_f2_cuda(x: torch.Tensor, table: torch.Tensor,
                            w1: torch.Tensor, spec: HashGridSpec,
                            feats: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch K3 on the card (F=2): x (N, 3) f32, table (rows, 64) f32,
    w1 (L*2, 64) f32 -> h1 (N, 64) f32 (+ feats (N, L*2) when given)."""
    return _launch_fwd(hash_encode_fwd_f2_cuda, "hash_encode_fwd_f2", 2, x,
                       table, w1, spec, feats)


hash_encode_fwd_f2_cuda.launches = 0


def hash_encode_fwd(x: torch.Tensor, table: torch.Tensor,
                    w1: torch.Tensor, spec: HashGridSpec,
                    feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused hash encoding + first dense layer, forward only (the
    counterpart of `hash_encode_mlp(..., need_x_grad=False)`).

    x: (N, 3) in [0, 1]^3 (clipped here); table: the table the encode
    reads (`encode_table`); w1: (L*F, H).  Returns the (N, H) f32
    pre-activation.  K1 (F=4) or K3 (F=2) runs for CUDA tensors, the plain
    version only for CPU tensors."""
    if x.device.type == "cpu":
        return hash_encode_fwd_plain(x, table, w1, spec, feats)
    if spec.n_features == 2:
        return hash_encode_fwd_f2_cuda(x, table, w1, spec, feats)
    return hash_encode_fwd_cuda(x, table, w1, spec, feats)


# --- backward: the table-gradient kernels (K2+K5, K4) --------------------


def hash_encode_bwd_plain(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                          spec: HashGridSpec) -> torch.Tensor:
    """Plain PyTorch version of the table-gradient kernels (see
    csrc/hash_encode_bwd.cu): d_table (rows, W) f32 from the gradient g
    (N, H) of h1.  Per level and sample, d_wr[f] = bf16(g) . bf16(w1[l*F+f])
    in f32; each of the 8 corners gets bf16(d_wr[f] * corner weight) added
    into its table point (the weight bf16-rounded at F=4 only), as the
    TPU's d_rows (K2, K4) summed by the per-level scatters (K5 and XLA's
    scatter-add)."""
    F, W = spec.n_features, spec.row_width
    d_wr = _bf(g) @ _bf(w1).T                                   # (N, L*F)
    d_table = torch.zeros(spec.total_rows * W, dtype=torch.float32,
                          device=x.device)
    for l, (idx, w8) in enumerate(_level_corners(x, spec)):
        vals = _bf(d_wr[:, None, l * F:(l + 1) * F] * w8[..., None])
        d_table.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return d_table.reshape(spec.total_rows, W)


def _launch_bwd(wrapper, entry: str, F: int, x, g, w1, spec):
    """x (N, 3) f32, g (N, 64) f32, w1 (L*F, 64) f32 -> d_table
    (rows, 32*F) f32, zeroed here and accumulated by the kernel's
    reductions.  Counts the launch on `wrapper`."""
    _check_spec(spec, F)
    if spec.total_rows * 32 * F >= 2 ** 31:
        raise ValueError("the kernel indexes the table gradient with 32-bit "
                         f"ints; {spec.total_rows} rows of {32 * F} floats "
                         "are too many")
    N, L = x.shape[0], spec.n_levels
    _check_tensors(x.device,
                   ("x", x, torch.float32, (N, 3), 16),
                   ("g", g, torch.float32, (N, 64), 16),
                   ("w1", w1, torch.float32, (L * F, 64), 16))
    d_table = torch.zeros((spec.total_rows, 32 * F), dtype=torch.float32,
                          device=x.device)
    if N == 0:
        return d_table
    fn = getattr(_build.library("hash_encode_bwd"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    err = fn(x.data_ptr(), g.data_ptr(), w1.data_ptr(), d_table.data_ptr(),
             N, *_level_args(spec),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    wrapper.launches += 1
    return d_table


def hash_encode_bwd_cuda(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                         spec: HashGridSpec) -> torch.Tensor:
    """Launch K2 fused with K5 (F=4): d_table (rows, 128) f32."""
    return _launch_bwd(hash_encode_bwd_cuda, "hash_encode_bwd", 4, x, g, w1,
                       spec)


hash_encode_bwd_cuda.launches = 0


def hash_encode_bwd_f2_cuda(x: torch.Tensor, g: torch.Tensor,
                            w1: torch.Tensor, spec: HashGridSpec
                            ) -> torch.Tensor:
    """Launch K4 fused with the per-level scatter-add (F=2): d_table
    (rows, 64) f32."""
    return _launch_bwd(hash_encode_bwd_f2_cuda, "hash_encode_bwd_f2", 2, x, g,
                       w1, spec)


hash_encode_bwd_f2_cuda.launches = 0


def hash_encode_bwd(x: torch.Tensor, g: torch.Tensor, w1: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Table gradient of the fused hash encode + first layer: K2+K5 (F=4)
    or K4 (F=2) for CUDA tensors, the plain version only for CPU
    tensors."""
    if x.device.type == "cpu":
        return hash_encode_bwd_plain(x, g, w1, spec)
    g, w1 = g.contiguous(), w1.contiguous()
    if spec.n_features == 2:
        return hash_encode_bwd_f2_cuda(x, g, w1, spec)
    return hash_encode_bwd_cuda(x, g, w1, spec)


class HashEncodeMLP(torch.autograd.Function):
    """h1 = hash_encode(x) @ w1 with gradients to the f32 table and w1.

    The forward reads the table the encode reads (K1: the f16 copy; K3: the
    f32 table) and keeps the per-level features; the backward returns
    d_table from `hash_encode_bwd` for the f32 `table` parameter and
    d_w1 = bf16(feats)^T bf16(g) in f32."""

    @staticmethod
    def forward(ctx, x, table, w1, enc_table, spec):
        feats = torch.empty((x.shape[0], spec.out_dim), dtype=torch.float32,
                            device=x.device)
        h1 = hash_encode_fwd(x, enc_table, w1, spec, feats)
        ctx.save_for_backward(x, w1, feats)
        ctx.spec = spec
        return h1

    @staticmethod
    def backward(ctx, g):
        x, w1, feats = ctx.saved_tensors
        g = g.contiguous()
        d_w1 = _bf(feats).T @ _bf(g)
        d_table = hash_encode_bwd(x, g, w1.detach(), ctx.spec)
        return None, d_table, d_w1, None, None


def hash_encode_mlp(x: torch.Tensor, table: torch.Tensor, w1: torch.Tensor,
                    enc_table: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Differentiable fused hash encode + first layer: x (N, 3) in [0, 1]^3,
    table (rows, W) f32 parameter, w1 (L*F, H), enc_table the table the
    encode reads (`encode_table(table)`: the f16 copy at F=4, the table
    itself at F=2)."""
    return HashEncodeMLP.apply(x, table, w1, enc_table, spec)


# --- the encode with a position gradient (pose refinement) ---------------
#
# The counterpart of `_encode_mlp_cv` (ngp_pl_tpu/ops/hash_encoding.py:
# 401-480), which the JAX package runs in XLA whenever positions need a
# gradient: f32 rows gathered from the f32 table, per-lane trilinear
# weights in f32, bf16 weighted rows contracted with bf16 w1 in f32 sums.
# It is another function than K1/K3 (those read the f16 copy at F=4 and
# round the corner weights through bf16 there), so it runs as PyTorch ops
# on both devices, a level at a time to bound the (N, W) intermediates.
# `XGRAD_CALLS` counts its forward and backward calls, and each runs
# inside a profiler range of its name.

XGRAD_CALLS = {"xgrad_encode_fwd": 0, "xgrad_encode_bwd": 0}


def _lane_consts(spec: HashGridSpec, device):
    """Each lane's corner point coordinates (cx, cy, cz) in {0, 1, 2}, its
    feature index and whether it holds a point (27 * F of the W lanes)."""
    W, F = spec.row_width, spec.n_features
    lane = torch.arange(W, device=device)
    p = torch.clamp_max(lane // F, BRICK_PTS ** 3 - 1)
    valid = (lane < BRICK_PTS ** 3 * F).to(torch.float32)
    return p // 9, (p // 3) % 3, p % 3, lane % F, valid


def _axis_w(c, local_a, frac_a):
    """Weight of lane coordinate c along one axis: 1 - frac at the cell's
    low corner, frac at its high corner, 0 elsewhere; (N, W)."""
    lo = (c[None, :] == local_a[:, None]).to(torch.float32)
    hi = (c[None, :] == local_a[:, None] + 1).to(torch.float32)
    return lo * (1.0 - frac_a[:, None]) + hi * frac_a[:, None]


def _axis_dw(c, local_a):
    """d _axis_w / d frac along one axis: +1, -1 or 0; (N, W)."""
    return ((c[None, :] == local_a[:, None] + 1).to(torch.float32)
            - (c[None, :] == local_a[:, None]).to(torch.float32))


def _xgrad_level(table, l, slot, local, frac, consts):
    """Level l's f32 rows (N, W), per-axis weights and lane weights."""
    cx, cy, cz, _, valid = consts
    rows = table[slot[l]]
    ws = (_axis_w(cx, local[l, :, 0], frac[l, :, 0]),
          _axis_w(cy, local[l, :, 1], frac[l, :, 1]),
          _axis_w(cz, local[l, :, 2], frac[l, :, 2]))
    wrow = ws[0] * ws[1] * ws[2] * valid[None, :]
    return rows, ws, wrow


class HashEncodeMLPXGrad(torch.autograd.Function):
    """h1 = encode(x) @ w1 with gradients to x, the f32 table and w1, as
    `_encode_mlp_cv` computes them."""

    @staticmethod
    def forward(ctx, x, table, w1, spec):
        XGRAD_CALLS["xgrad_encode_fwd"] += 1
        with torch.profiler.record_function("xgrad_encode_fwd"):
            consts = _lane_consts(spec, x.device)
            slot, local, frac = slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
            w1b = _bf(expand_w1(w1, spec))                      # (L, W, H)
            h1 = x.new_zeros((x.shape[0], w1.shape[-1]))
            for l in range(spec.n_levels):
                rows, _, wrow = _xgrad_level(table, l, slot, local, frac,
                                             consts)
                h1 += _bf(rows * wrow) @ w1b[l]
        ctx.save_for_backward(x, table, w1)
        ctx.spec = spec
        return h1

    @staticmethod
    def backward(ctx, g):
        XGRAD_CALLS["xgrad_encode_bwd"] += 1
        with torch.profiler.record_function("xgrad_encode_bwd"):
            return _xgrad_backward(ctx, g)


def _xgrad_backward(ctx, g):
    x, table, w1 = ctx.saved_tensors
    spec = ctx.spec
    L, F, W = spec.n_levels, spec.n_features, spec.row_width
    consts = _lane_consts(spec, x.device)
    cx, cy, cz, lane_f, valid = consts
    slot, local, frac = slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
    w1b = _bf(expand_w1(w1.detach(), spec))
    g16 = _bf(g)
    d_table = torch.zeros_like(table)
    d_w1big = []
    d_x = torch.zeros_like(x)
    for l in range(L):
        rows, (wx, wy, wz), wrow = _xgrad_level(table, l, slot, local,
                                                frac, consts)
        d_w1big.append(_bf(rows * wrow).T @ g16)                # (W, H)
        d_wr = g16 @ w1b[l].T                                   # (N, W)
        d_table.index_add_(0, slot[l], d_wr * wrow)
        rg = rows * d_wr * valid[None, :]
        dwx = _axis_dw(cx, local[l, :, 0])
        dwy = _axis_dw(cy, local[l, :, 1])
        dwz = _axis_dw(cz, local[l, :, 2])
        d_frac = torch.stack([(rg * dwx * wy * wz).sum(-1),
                              (rg * wx * dwy * wz).sum(-1),
                              (rg * wx * wy * dwz).sum(-1)], dim=-1)
        d_x += d_frac * float(spec.resolutions[l])
    idx = (torch.arange(L, device=x.device)[:, None] * F
           + lane_f[None, :]).reshape(-1)
    d_w1 = torch.zeros_like(w1).index_add_(
        0, idx, torch.stack(d_w1big).reshape(L * W, -1))
    d_x = d_x * ((x > 0.0) & (x < 1.0)).to(torch.float32)
    return d_x, d_table, d_w1, None


def hash_encode_mlp_xgrad(x: torch.Tensor, table: torch.Tensor,
                          w1: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Differentiable hash encode + first layer with the position gradient
    (`hash_encode_mlp(..., need_x_grad=True)` of the JAX package): x (N, 3)
    in [0, 1]^3 (clipped for the lookup; its gradient is 0 outside the open
    box), table (rows, W) f32 parameter, w1 (L*F, H) -> h1 (N, H) f32."""
    return HashEncodeMLPXGrad.apply(x, table, w1, spec)
