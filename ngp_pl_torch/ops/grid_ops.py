"""Density-grid bit packing (counterpart of ngp_pl_tpu/ops/grid_ops.py;
reference models/csrc/raymarching.cu:122-161).

The reference packs the thresholded grid into a uint8 bitfield, 8 cells a
byte; both packages march a plain uint8 grid and keep these for the
reference's memory format (`models/occupancy.export_bitfield`).
"""
from __future__ import annotations

import torch


def packbits(density_grid: torch.Tensor, threshold) -> torch.Tensor:
    """Flat density grid (N,) -> bitfield (N//8,) uint8, LSB = first cell."""
    occ = (density_grid.reshape(-1, 8) > threshold).to(torch.uint8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=occ.device)
    return (occ * weights).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """(N//8,) uint8 bitfield -> (N,) uint8 occupancy flags in {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitfield.device)
    return ((bitfield[:, None] >> shifts[None, :]) & 1).reshape(-1)
