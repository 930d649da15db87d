"""Inputs of the K9 and K6 benches, made from a seed with numpy or torch.

Imports only numpy and torch, so that `kernel_ab.py` can hand the same
inputs to the kernels of two trees of this repository.

- `k9_inputs`: the JAX encode ablation bench's (benchmarking/
  micro_pallas_fwd.py): rows (L, n, 64) u32 bits as int32 from
  `default_rng(0).integers(0, 2^31)`, then meta_T (L, 4, n) and w1big
  (L, 128, 64) f32 U[0, 1).
- `k9_f32_rows`: for the variants that read the rows' bits as f32
  (no_decode, stream) and would meet the inf and NaN patterns of the random
  words: the bits of f32 U(-2, 2).
- `k6_uniform`: 262,144 rows of 128 N(0, 1) floats into 16,384 rows at
  uniform random indices.
- `k6_runs`: the JAX scatter bench's ray-coherent pattern
  (benchmarking/micro_scatter2.py:50-57, its first level): 327,680 rows of
  128 N(0, 1) floats into R = 512 rows in runs of 74 equal indices, from
  `default_rng(0)`.
"""
from __future__ import annotations

import numpy as np
import torch

K9_LEVELS = 8
K9_N = 196608                  # the JAX bench's samples
K9_BN = 4096                   # its interleaved layout's block
K9_SEED = 0                    # the JAX bench's default_rng(0)
K6_UNIFORM = (262144, 128, 16384)   # P, W, R
K6_RUNS = (327680, 128, 512, 74)    # P, W, R, run length


def k9_inputs(n: int, dev, levels: int = K9_LEVELS):
    """(rows, meta_T, w1big) on `dev`, and the generator, for what the JAX
    bench's MAIN2 draws after them."""
    rng = np.random.default_rng(K9_SEED)
    rows = rng.integers(0, 2 ** 31, (levels, n, 64), dtype=np.int64).astype(
        np.uint32).view(np.int32)
    meta_T = rng.random((levels, 4, n)).astype(np.float32)
    w1big = rng.random((levels, 128, 64)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (rows, meta_T, w1big)], rng


def k9_f32_rows(shape, dev, seed: int = 6) -> torch.Tensor:
    """int32 bits of f32 U(-2, 2) of `shape`, drawn on `dev`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(shape, generator=g, device=dev) * 4.0 - 2.0).view(
        torch.int32)


def k6_uniform(dev):
    """(rows, idx, n_rows) at uniform random indices (torch seed 5)."""
    P, W, R = K6_UNIFORM
    g = torch.Generator().manual_seed(5)
    rows = torch.randn((P, W), generator=g)
    idx = torch.randint(0, R, (P,), generator=g)
    return rows.to(dev), idx.to(dev), R


def runs_pattern(rng: np.random.Generator, P: int, R: int,
                 run: int) -> np.ndarray:
    """(P,) int64 indices: ceil(P / run) uniform draws in [0, R), each
    repeated `run` times, as the JAX scatter bench makes them."""
    base = rng.integers(0, R, -(-P // run))
    return np.repeat(base, run)[:P].astype(np.int64)


def k6_runs(dev, P: int = K6_RUNS[0]):
    """(rows, idx, n_rows) of the ray-coherent runs pattern."""
    _, W, R, run = K6_RUNS
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(P, W)).astype(np.float32)
    idx = runs_pattern(rng, P, R, run)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(idx).to(dev), R
