"""Round-2b primitives: the gather and scatter of wide rows (the
paired-level encoding's 320- and 640-lane rows, f32 and bf16), the
4-pair bwd shape, a permutation gather and a row cumsum, the counterpart
of benchmarking/micro_r2b.py.

    python -m ngp_pl_torch.benchmarking.micro_r2b [--device cuda]
        [--N 262144 --rows_total 40000]

The JAX script's inputs, drawn from `np.random.default_rng(0)` in its
order: M = 4N slots into [0, rows_total); a (rows_total, W) table ~ N(0,
1) for each gather (W, dtype); for each scatter (W, dtype) M rows ~ N(0,
1) and M slots into 16,384 rows; the 4-pair bwd shape's (4, N, 640) rows
and per-pair slots into [4096, 16384 x3]; an (N, 8) payload and a
permutation of N; an (8192, 32) array.  The JAX script draws the normal
arrays from one jax.random key, so its (M, 640) and (4, N, 640) arrays
hold one draw; here too, from the numpy generator (`micro_prims.KeyDraws`:
one draw a size, cast to each dtype), so their values differ from the JAX
script's and their shapes and dtypes do not.

Labels (`LABELS`, the JAX script's; `KEYS` tells its repeated label
apart): the gathers (as f32), the scatters into zeros of the rows' dtype
(then as f32), the two 4-pair bwd scatters, the permutation gather and
the cumsum along rows.  The port stores no paired rows, so no port call
goes beside them (`NOTES`).
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(N=262144, rows_total=40000)
F32, BF16 = torch.float32, torch.bfloat16
GATHERS = ((320, F32), (320, BF16), (640, F32), (640, BF16), (256, F32),
           (1280, BF16))
SCATTERS = ((640, F32), (640, BF16), (320, F32))
PAIR_SIZES = (4096, 16384, 16384, 16384)
SCATTER_ROWS = 16384
LABELS = ("gather 1.05M rows x1280B (320 lanes float32)",
          "gather 1.05M rows x640B (320 lanes bfloat16)",
          "gather 1.05M rows x2560B (640 lanes float32)",
          "gather 1.05M rows x1280B (640 lanes bfloat16)",
          "gather 1.05M rows x1024B (256 lanes float32)",
          "gather 1.05M rows x2560B (1280 lanes bfloat16)",
          "scatter 1.05M rows x2560B", "scatter 1.05M rows x1280B",
          "scatter 1.05M rows x1280B",
          "scatter 4 pairs x 262k rows x1280B bf16 (bwd shape)",
          "scatter 4 pairs x 262k rows x2560B f32 (bwd shape)",
          "permutation gather 262k x 32B", "cumsum (8192, 32) axis=1")
PORT_LABELS = ()
KEYS = mp.unique(LABELS)
NOTES = {"*": "the port stores no paired-level rows and has no call for "
              "these shapes, so no `port: ` label goes beside them"}


def inputs(device: str, N: int = 262144, rows_total: int = 40000,
           seed: int = 0) -> dict:
    """The JAX script's inputs (see the module note), on `device`."""
    M = 4 * N
    rng = np.random.default_rng(seed)
    key = mp.KeyDraws(rng)
    t = functools.partial(mp.tensor, device=device)
    i64 = torch.int64
    slot = t(rng.integers(0, rows_total, M, dtype=np.int32), i64)
    inp = dict(N=N, slot=slot, scatters=[])
    inp["tables"] = [t(key.normal((rows_total, W)), dt) for W, dt in GATHERS]
    for W, dt in SCATTERS:
        d_rows = t(key.normal((M, W)), dt)
        slotm = t(rng.integers(0, SCATTER_ROWS, M, dtype=np.int32), i64)
        inp["scatters"].append((d_rows, slotm))
    d4f = t(key.normal((4, N, 640)))
    inp["d4"], inp["d4f"] = d4f.to(BF16), d4f
    inp["s4"] = t(np.stack([rng.integers(0, s, N, dtype=np.int32)
                            for s in PAIR_SIZES]), i64)
    inp["pay"] = t(key.normal((N, 8)))
    inp["perm"] = t(rng.permutation(N).astype(np.int32), i64)
    inp["x"] = t(key.normal((8192, 32)))
    return inp


def scatter4(s4, d, dtype):
    """The 4-pair bwd shape: pair p's N rows into its own zeros of
    `dtype` (as f32)."""
    return [mp.scatter_add(size, s4[p], d[p], dtype).float()
            for p, size in enumerate(PAIR_SIZES)]


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, by KEYS."""
    slot = inp["slot"]
    calls = [lambda tb=tb: tb[slot].float() for tb in inp["tables"]]
    calls += [lambda d=d, s=s: mp.scatter_add(SCATTER_ROWS, s, d).float()
              for d, s in inp["scatters"]]
    calls += [lambda: scatter4(inp["s4"], inp["d4"], BF16),
              lambda: scatter4(inp["s4"], inp["d4f"], F32),
              lambda: inp["pay"][inp["perm"]],
              lambda: torch.cumsum(inp["x"], 1)]
    return dict(zip(KEYS, calls))


def references(inp: dict, fns: dict) -> dict:
    return {}


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every label timed; returns {key: {"wall_ms", "device_ms"}}."""
    return mp.time_labels(functions(inputs(device, **shape)), device, runs,
                          warmup, log, width=58)


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
