"""The least time the card could take for a kernel's work: the larger of the
bytes it must move over the memory rate and its operations over the peak
rate of their type (H100 SXM, NVIDIA data sheet)."""
from __future__ import annotations

import torch

from ngp_pl_torch.ops import hash_encoding as he

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12     # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # f32 outside the tensor cores


def bound(nbytes: float, tensor_flops: float, fp32_flops: float):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tensor_flops / BF16_TENSOR_FLOPS + fp32_flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_work(x: torch.Tensor, spec: he.HashGridSpec, table: torch.Tensor,
            w1: torch.Tensor):
    """(bytes, bf16 tensor flops, f32 operations, table points read) of one
    encode forward (K1 or K3): x in, h1 out, w1, and the table points these
    samples read, each distinct (row, corner point) once, F values of the
    table's type each (a row holds 27 points; its pad lanes are never
    read)."""
    N = x.shape[0]
    slot, local, _ = he.slots_local_frac_lm(x, spec)
    corner = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                           for c in range(8)], device=x.device)
    pts = local[:, :, None, :] + corner                  # (L, N, 8, 3)
    pt = (pts[..., 0] * 3 + pts[..., 1]) * 3 + pts[..., 2]
    points = int(torch.unique(slot[:, :, None] * he.BRICK_PTS ** 3
                              + pt).numel())
    nbytes = (N * 12 + N * 64 * 4
              + points * spec.n_features * table.element_size()
              + w1.numel() * 4)
    contraction = 2.0 * N * spec.out_dim * 64
    interp = N * spec.n_levels * (8 * spec.n_features * 2 + 8 * 2)
    return nbytes, contraction, float(interp), points
