"""Round-2 primitives: the encode's gather and scatter by dtype and width,
their one-hot matmul form for small levels, and the composite's segment
sum and cumsum, the counterpart of benchmarking/micro_r2.py.

    python -m ngp_pl_torch.benchmarking.micro_r2 [--device cuda]
        [--N 262144 --rows_total 110000 --rays 8192]

The JAX script's inputs, drawn from `np.random.default_rng(0)` in its
order: for each gather (W, dtype) a (rows_total, W) table ~ N(0, 1) and
8 x N slots; for each scatter (target rows, W, dtype) N rows ~ N(0, 1) and
N slots into the target; the bwd shape's (8, N, 128) rows and per-level
slots into [512, 3375, 17576, 16384 x5]; for S in (512, 3375) N slots and
N bf16 rows; the composite's (N, 8) payload and N sorted ray ids in
[0, rays); an (N,) pool; and the window rows (32,768 x 16 and x 32 u32,
kept as int32 of the same bits) with rays*112 and rays*56 indices.  The
JAX script draws the normal arrays from one jax.random key; here from the
numpy generator (`micro_prims.KeyDraws`: one draw a size, cast to each
dtype), so their values differ and their shapes and dtypes do not.

Labels (`LABELS`, the JAX script's; `KEYS` tells its two repeated labels
apart): the gathers (as f32, as the JAX script casts them), the scatters
into zeros of the rows' dtype (`index_add_`, then as f32), the 8-level
bwd scatter, the one-hot matmul scatter, `segment_sum`, the cumsum over
the pool, the window gathers.  Beside them (`PORT_LABELS`): K6 on the bwd
shape, and the port's compositor prefix `segment_excl_cumsum` on the pool
with the payload's segments.
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(N=262144, rows_total=110000, rays=8192)
GATHERS = ((128, torch.float32), (128, torch.bfloat16),
           (64, torch.float32), (64, torch.bfloat16))
SCATTERS = ((16384, 128, torch.float32), (16384, 128, torch.bfloat16),
            (8192, 128, torch.float32), (4096, 128, torch.float32),
            (16384, 64, torch.float32))
BWD_SIZES = (512, 3375, 17576, 16384, 16384, 16384, 16384, 16384)
ONE_HOT_ROWS = (512, 3375)
NW3 = 32768                     # window rows
LABELS = ("gather 2.1M rows x512B", "gather 2.1M rows x256B",
          "gather 2.1M rows x256B", "gather 2.1M rows x128B",
          "scatter 0.26M rows x512B -> 8MB",
          "scatter 0.26M rows x256B -> 4MB",
          "scatter 0.26M rows x512B -> 4MB",
          "scatter 0.26M rows x512B -> 2MB",
          "scatter 0.26M rows x256B -> 4MB",
          "scatter 8 levels x 262k rows x512B (bwd shape)",
          "one-hot matmul scatter N=262k -> 512 rows",
          "one-hot matmul scatter N=262k -> 3375 rows",
          "segment_sum 262k x 8-lane payload -> 8k rays",
          "cumsum over pool (262k,)",
          "window gather 0.92M x64B", "window gather 0.46M x128B")
PORT_LABELS = ("port: K6 scatter_rows 8 levels (bwd shape)",
               "port: segment_excl_cumsum over pool (262k,)")
KEYS = mp.unique(LABELS) + PORT_LABELS
NOTES = {
    **{k: mp.ONE_HOT_NOTE for k in LABELS[10:12]},
    LABELS[12]: mp.SEGMENT_SUM_NOTE,
    LABELS[14]: "int32 rows of the u32 bits",
    LABELS[15]: "int32 rows of the u32 bits",
    PORT_LABELS[1]: (
        "exclusive cumsum within each ray's segment of the pool (float64 "
        "prefix), held against the same from the primitive's cumsum"),
}


def inputs(device: str, N: int = 262144, rows_total: int = 110000,
           rays: int = 8192, seed: int = 0) -> dict:
    """The JAX script's inputs (see the module note), on `device`."""
    L = 8
    rng = np.random.default_rng(seed)
    key = mp.KeyDraws(rng)
    t = functools.partial(mp.tensor, device=device)
    i64 = torch.int64
    inp = dict(N=N, rays=rays, gathers=[], scatters=[], one_hot=[])
    for W, dt in GATHERS:
        table = t(key.normal((rows_total, W)), dt)
        slot = t(rng.integers(0, rows_total, L * N, dtype=np.int32), i64)
        inp["gathers"].append((table, slot))
    for tgt, W, dt in SCATTERS:
        d_rows = t(key.normal((N, W)), dt)
        slot = t(rng.integers(0, tgt, N, dtype=np.int32), i64)
        inp["scatters"].append((tgt, d_rows, slot))
    inp["d_rows8"] = t(key.normal((L, N, 128)))
    inp["slots8"] = t(np.stack([rng.integers(0, s, N, dtype=np.int32)
                                for s in BWD_SIZES]), i64)
    for S in ONE_HOT_ROWS:
        slot = t(rng.integers(0, S, N, dtype=np.int32), i64)
        inp["one_hot"].append((S, slot, t(key.normal((N, 128)),
                                           torch.bfloat16)))
    inp["payload"] = t(key.normal((N, 8)))
    inp["seg"] = t(np.sort(rng.integers(0, rays, N, dtype=np.int32)), i64)
    inp["x"] = t(key.normal((N,)))
    win = rng.integers(0, 2 ** 32, (NW3, 16), dtype=np.uint64)
    inp["win"] = t(win.astype(np.uint32).view(np.int32))
    inp["idx"] = t(rng.integers(0, NW3, rays * 112, dtype=np.int32), i64)
    inp["idx2"] = t(rng.integers(0, NW3, rays * 56, dtype=np.int32), i64)
    win2 = rng.integers(0, 2 ** 32, (NW3, 32), dtype=np.uint64)
    inp["win2"] = t(win2.astype(np.uint32).view(np.int32))
    inp["offsets"] = torch.searchsorted(
        inp["seg"], torch.arange(rays, device=device))
    return inp


def scatter8(inp, scatter=None):
    """The bwd shape: level l's N rows into its own zeros."""
    scatter = scatter or mp.scatter_add
    return [scatter(s, inp["slots8"][l], inp["d_rows8"][l])
            for l, s in enumerate(BWD_SIZES)]


def excl_from_cumsum(c, x, offsets, seg):
    """`segment_excl_cumsum`'s result from an inclusive cumsum c of x: the
    prefix before each sample less its segment's start, clipped as the
    compositor clips it."""
    from ngp_pl_torch.ops.volume_render import _EXCL_MAX

    excl = c - x
    base = excl[torch.clamp(offsets, 0, x.shape[0] - 1)]
    return torch.clamp(excl - base[seg], 0.0, _EXCL_MAX)


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, by KEYS."""
    from ngp_pl_torch.ops.volume_render import segment_excl_cumsum

    calls = [lambda tb=tb, s=s: tb[s].float() for tb, s in inp["gathers"]]
    calls += [lambda tgt=tgt, d=d, s=s: mp.scatter_add(tgt, s, d).float()
              for tgt, d, s in inp["scatters"]]
    calls.append(lambda: scatter8(inp))
    calls += [lambda S=S, s=s, d=d: mp.one_hot_scatter(s, S, d)
              for S, s, d in inp["one_hot"]]
    x, seg, offsets = inp["x"], inp["seg"], inp["offsets"]
    calls += [lambda: mp.segment_sum(inp["payload"], seg, inp["rays"] + 1),
              lambda: torch.cumsum(x, 0),
              lambda: inp["win"][inp["idx"]],
              lambda: inp["win2"][inp["idx2"]],
              lambda: scatter8(inp, mp.k6_scatter),
              lambda: segment_excl_cumsum(x, offsets, seg)]
    return dict(zip(KEYS, calls))


def references(inp: dict, fns: dict) -> dict:
    """Each `port: ` label's kernel (None for no kernel) and its
    primitive's call on the same input."""
    x, seg, offsets = inp["x"], inp["seg"], inp["offsets"]
    return {PORT_LABELS[0]: ("K6", fns[KEYS[9]]),
            PORT_LABELS[1]: (None, lambda: excl_from_cumsum(
                fns[KEYS[13]](), x, offsets, seg))}


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every label timed; returns {key: {"wall_ms", "device_ms"}}."""
    return mp.time_labels(functions(inputs(device, **shape)), device, runs,
                          warmup, log, width=56)


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
