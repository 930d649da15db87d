"""Accumulating row scatter (K6): out[clamp(idx[p])] += rows[p] (counterpart
of `scatter_accum`, ngp_pl_tpu/ops/scatter_accum.py:40-87).

Indices are clamped to [0, n_rows - 1], as `scatter_accum` clips them
(`jnp.clip(row_idx, 0, R - 1)`, scatter_accum.py:57): a row whose index
lies outside the output is added to the first or the last output row, not
dropped.

The JAX package's train path does not call `scatter_accum` (its table
gradient goes through `scatter_onehot` and XLA's scatter-add, which the port
fuses into csrc/hash_encode_bwd.cu), so neither does the port's.
`scatter_rows` is K6's wrapper: on CUDA tensors it launches the kernel of
csrc/scatter_rows.cu, on CPU tensors it runs `scatter_rows_plain` (a
clamped `index_add_`)."""
from __future__ import annotations

import ctypes
import functools

import torch

from ngp_pl_torch import _build


def scatter_rows_plain(rows: torch.Tensor, idx: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K6: (n_rows, W) f32 sums of rows (P, W) f32
    at idx (P,) int64, each index clamped to [0, n_rows - 1]."""
    out = torch.zeros((n_rows, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, idx.clamp(0, n_rows - 1), rows)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("scatter_rows").scatter_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


def scatter_rows_cuda(rows: torch.Tensor, idx: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """Launch K6 on the card (indices clamped to [0, n_rows - 1]); the
    output's zero fill is part of the call."""
    P = rows.shape[0]
    if rows.device.type != "cuda" or idx.device != rows.device:
        raise ValueError("rows and idx must be on one CUDA device, got "
                         f"{rows.device} and {idx.device}")
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or not rows.is_contiguous()):
        raise ValueError(f"rows: want contiguous float32 (P, W), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if (idx.dtype != torch.int64 or tuple(idx.shape) != (P,)
            or not idx.is_contiguous()):
        raise ValueError(f"idx: want contiguous int64 ({P},), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if n_rows < 1:
        raise ValueError(f"n_rows must be at least 1, got {n_rows}")
    out = torch.zeros((n_rows, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    if P == 0 or rows.shape[1] == 0:
        return out
    err = _entry()(rows.data_ptr(), idx.data_ptr(), out.data_ptr(), P,
                   rows.shape[1], n_rows,
                   torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "scatter_rows")
    scatter_rows_cuda.launches += 1
    return out


scatter_rows_cuda.launches = 0


def scatter_rows(rows: torch.Tensor, idx: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """K6 dispatch: the kernel for CUDA tensors, the plain version only for
    CPU tensors."""
    if rows.device.type == "cpu":
        return scatter_rows_plain(rows, idx, n_rows)
    return scatter_rows_cuda(rows.contiguous(), idx.contiguous(), n_rows)
