"""The benchmark's arithmetic: data-sheet peaks, the work of each hand
kernel's launch and of the model's samples, a launch's roofline bound, and
the rate and the percentile of a window.

The peaks and the work counts are frozen copies of the port's
`ngp_pl_torch/benchmarking/roofline.py` (`bound`, `k1_work`) and of the
byte and operation counts its chip check writes beside K2+K5/K4, K7 and K8,
with one change: a table gradient's bytes count the distinct table points
its samples write, as the encode's count the points they read, not the
whole gradient's zero fill, which another kernel writes.  Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from perfbench.reference import field as rf

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # f32 outside the tensor cores
HIDDEN = 64                    # the first layer's width


def bound_s(nbytes: float, tensor_flops: float, fp32_flops: float) -> float:
    """The least seconds for the work: bytes over the memory's rate, or its
    operations over their peaks, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S,
               tensor_flops / BF16_TENSOR_FLOPS + fp32_flops / FP32_FLOPS)


def table_points(x01: torch.Tensor, g: rf.Grid) -> int:
    """Distinct (row, corner point) pairs that the samples x01 (N, 3) in
    [0, 1]^3 read or write, each of F values."""
    corner = torch.tensor(rf.CORNERS, device=x01.device)
    keys = []
    for slot, local, _ in rf._level_slots(x01.clamp(0.0, 1.0), g):
        pt_c = local[:, None, :] + corner[None]
        pt = (pt_c[..., 0] * 3 + pt_c[..., 1]) * 3 + pt_c[..., 2]
        keys.append((slot[:, None] * rf.BRICK_PTS ** 3 + pt).reshape(-1))
    return int(torch.unique(torch.cat(keys)).numel())


def encode_fwd_bound(N: int, points: int, g: rf.Grid, table_bytes: int,
                     feats: bool) -> float:
    """K1/K3: x in, h1 (and the f32 features) out, w1, the table points
    read; the first layer on the tensor cores, the interpolation in f32."""
    LF = g.n_levels * g.n_features
    nbytes = (N * 12 + N * HIDDEN * 4 + points * g.n_features * table_bytes
              + LF * HIDDEN * 4 + (N * LF * 4 if feats else 0))
    interp = N * g.n_levels * (8 * g.n_features * 2 + 8 * 2)
    return bound_s(nbytes, 2.0 * N * LF * HIDDEN, float(interp))


def encode_bwd_bound(N: int, points: int, g: rf.Grid) -> float:
    """K2+K5/K4: x and the h1 gradient in, w1, the f32 table points
    written; d_wr on the tensor cores, the corner products and adds in
    f32."""
    LF = g.n_levels * g.n_features
    nbytes = (N * 12 + N * HIDDEN * 4 + LF * HIDDEN * 4
              + points * g.n_features * 4)
    rest = N * g.n_levels * (8 * 2 + 8 * g.n_features * 2)
    return bound_s(nbytes, 2.0 * N * LF * HIDDEN, float(rest))


def tail_fwd_bound(P: int, weight_shapes: Sequence) -> float:
    """K7: h1 and SH in, sigma and rgb out, the weights."""
    w = sum(a * b for a, b in weight_shapes)
    return bound_s(P * (64 * 4 + 16 * 4 + 4 + 12) + w * 4, 2.0 * P * w, 0.0)


def tail_bwd_bound(P: int, weight_shapes: Sequence) -> float:
    """K8: h1, SH and both gradients in, dh1 out, the weights and their
    gradients; the forward again, the backward through the layers and the
    weight gradients on the tensor cores."""
    w = sum(a * b for a, b in weight_shapes)
    macs = 2 * w + 192 + 4096 + 2048
    return bound_s(P * (64 + 16 + 1 + 3 + 64) * 4 + 2 * w * 4,
                   2.0 * P * macs, 0.0)


def sample_flops(model: Dict, train: bool) -> float:
    """The model's operations for one sample: the encode's interpolation
    and both MLPs forward, and with `train` their backward (twice the
    matmuls, the interpolation's scatter once more)."""
    L, F = model["n_levels"], model["n_features"]
    interp = L * (8 * F * 2 + 8 * 2)
    mm = 2.0 * sum(a * b for shapes in rf.mlp_shapes(model).values()
                   for a, b in shapes)
    return (3.0 * mm + 2.0 * interp) if train else (mm + interp)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    closest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds
