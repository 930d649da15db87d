"""Morton (Z-order) encode and decode (counterpart of
ngp_pl_tpu/ops/morton.py; reference models/csrc/raymarching.cu:35-119).

The reference keeps its density grid in Morton order; both packages keep
it row-major and use these only for the reference's layout
(`models/occupancy.export_bitfield`).  JAX computes in uint32, whose
products wrap; torch has little uint32 arithmetic, so the codes are int64
tensors holding the uint32 values, masked to 32 bits after every multiply
and shift.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each uint32 3 apart (raymarching.cu:36-43)."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int coords (each < 1024) -> (...) Morton codes, uint32
    values in int64."""
    c = coords.to(torch.int64) & _U32
    xx = _expand_bits(c[..., 0])
    yy = _expand_bits(c[..., 1])
    zz = _expand_bits(c[..., 2])
    return (xx | (yy << 1) | (zz << 2)) & _U32


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _expand_bits (raymarching.cu:53-61)."""
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """(...) Morton codes -> (..., 3) int32 coords."""
    idx = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(idx), _compact_bits(idx >> 1),
                        _compact_bits(idx >> 2)], dim=-1).to(torch.int32)
