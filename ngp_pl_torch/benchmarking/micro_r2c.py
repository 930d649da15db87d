"""Round-2c primitives: raw gather, scatter, cumsum and matmul rates at the
bench's pool shapes, the counterpart of benchmarking/micro_r2c.py.

    python -m ngp_pl_torch.benchmarking.micro_r2c [--device cuda]
        [--N 262144 --S 16384 --rays 8192 --chain 896]

The JAX script's inputs, all drawn from `np.random.default_rng(0)` in its
order and cast as it casts them: a (8*S, 128) f32 table ~ U(0, 1) and its
bf16 copy, (8, N) slots into the whole table and (8, N) into one level's
S rows, (8, N, 128) rows and their bf16 copy, an (8*S,) vector, an (8, N,
128) array for the elementwise pass, an (N,) pool, an (N, 8) payload
with N sorted ids in [0, rays), (rays, chain) int32 keys in [-900, 0), an
(N, 64) bf16 input and a (64, 64) bf16 weight.

Labels (`LABELS`, the JAX script's), each with its derived line where
the JAX script prints one (`DERIVED`: ns a row, or GB/s read over its
1.073 GB), read from the device ms on the card and from the wall ms on
the CPU: the gathers, the per-level scatter-adds, the one-hot matmul into
512 rows (its own comparison one-hot), the elementwise pass, the cumsum,
`segment_sum`, the top 32 of each row of the keys and the 4-layer bf16
matmul stack.  Beside them (`PORT_LABELS`): K6 on the 8 x N per-level
scatter.
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(N=262144, S=16384, rays=8192, chain=896)
L, W = 8, 128
SMALL_ROWS = 512                # the dense level's target
TOP_K = 32
PASS_GB = 1.073                 # what the JAX script divides by
LABELS = ("gather 2M rows f32 (512B)", "gather 2M rows bf16 (256B)",
          "gather 262k rows f32", "gather 2M scalars f32 (4B)",
          "scatter-add 8x262k rows f32 -> 8MB",
          "scatter-add 262k rows -> 256KB target",
          "scatter-add 8x262k bf16-src rows",
          "onehot-matmul 262k rows -> 512-row table",
          "elementwise pass over (8,262k,128) f32 1GB",
          "cumsum (262144,) f32", "segment_sum (262k,8) -> 8k segs",
          "top_k 32 over (8192,896)", "4x (262k,64)@(64,64) bf16 relu")
PORT_LABELS = ("port: K6 scatter_rows 8x262k rows f32 -> 8MB",)
KEYS = LABELS + PORT_LABELS
NOTES = {
    LABELS[7]: "the JAX script's comparison one-hot, as bf16, and "
               + mp.BF16_MM_NOTE,
    LABELS[10]: mp.SEGMENT_SUM_NOTE,
    LABELS[11]: ("lax.top_k puts the lower index first among equal keys "
                 "(these keys are integers, with ties); torch.topk orders "
                 "ties as it likes, so this is a stable descending sort cut "
                 "to 32"),
}


def derived(inp: dict) -> dict:
    """Each derived line's unit and its value from a label's ms."""
    N = inp["N"]
    def per(rows):
        return "ns_per_row", lambda ms: ms * 1e6 / rows

    return {LABELS[0]: per(L * N), LABELS[1]: per(L * N), LABELS[2]: per(N),
            LABELS[3]: per(L * N), LABELS[4]: per(L * N),
            LABELS[5]: per(N), LABELS[6]: per(L * N), LABELS[10]: per(N),
            LABELS[8]: ("GB_per_s", lambda ms: PASS_GB / ms * 1e3)}


def inputs(device: str, N: int = 262144, S: int = 16384, rays: int = 8192,
           chain: int = 896, seed: int = 0) -> dict:
    """The JAX script's inputs (see the module note), on `device`."""
    rng = np.random.default_rng(seed)
    t = functools.partial(mp.tensor, device=device)
    f32, i64, bf16 = torch.float32, torch.int64, torch.bfloat16
    inp = dict(N=N, S=S, rays=rays)
    inp["table"] = t(rng.random((L * S, W)), f32)
    inp["table_bf"] = inp["table"].to(bf16)
    inp["slots"] = t(rng.integers(0, L * S, (L, N)), i64)
    inp["slots_lvl"] = t(rng.integers(0, S, (L, N)), i64)
    inp["rows"] = t(rng.random((L, N, W)), f32)
    inp["rows_bf"] = inp["rows"].to(bf16)
    inp["vec"] = t(rng.random((L * S,)), f32)
    inp["big"] = t(rng.random((L, N, W)), f32)
    inp["flat"] = t(rng.random((N,)), f32)
    inp["pool8"] = t(rng.random((N, 8)), f32)
    inp["seg"] = t(np.sort(rng.integers(0, rays, N)), i64)
    inp["keys"] = t(rng.integers(-900, 0, (rays, chain)), torch.int32)
    inp["x"] = t(rng.random((N, 64)), f32).to(bf16)
    inp["w"] = t(rng.random((64, 64)), f32).to(bf16)
    return inp


def per_level(rows, slots, S, scatter=None):
    """L scatters of N rows into (S, W) f32 zeros, stacked."""
    scatter = scatter or mp.scatter_add
    return torch.stack([scatter(S, slots[l], rows[l].float())
                        for l in range(rows.shape[0])])


def top_k(keys, k: int):
    """(values, indices) of each row's k largest, ties by lower index."""
    v, i = torch.sort(keys, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def mlp4(x, w):
    h = x
    for _ in range(4):
        h = torch.relu(h @ w)
    return h


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, by KEYS."""

    N, S = inp["N"], inp["S"]
    s, s_lvl, rows = inp["slots"], inp["slots_lvl"], inp["rows"]
    small = s_lvl[0] & (SMALL_ROWS - 1)

    def onehot_mm():
        oh = small[:, None] == torch.arange(SMALL_ROWS, device=s.device)
        return mp.mm_f32_out(oh.to(torch.bfloat16).t(), rows[0])

    calls = (
        lambda: inp["table"][s.reshape(-1)].reshape(L, N, W),
        lambda: inp["table_bf"][s.reshape(-1)].reshape(L, N, W),
        lambda: inp["table"][s[0]],
        lambda: inp["vec"][s.reshape(-1)],
        lambda: per_level(rows, s_lvl, S),
        lambda: mp.scatter_add(SMALL_ROWS, small, rows[0]),
        lambda: per_level(inp["rows_bf"], s_lvl, S),
        onehot_mm,
        lambda: inp["big"] * 1.0001 + 0.5,
        lambda: torch.cumsum(inp["flat"], 0),
        lambda: mp.segment_sum(inp["pool8"], inp["seg"], inp["rays"] + 1),
        lambda: top_k(inp["keys"], TOP_K),
        lambda: mlp4(inp["x"], inp["w"]),
        lambda: per_level(rows, s_lvl, S, mp.k6_scatter))
    return dict(zip(KEYS, calls))


def references(inp: dict, fns: dict) -> dict:
    return {PORT_LABELS[0]: ("K6", fns[LABELS[4]])}


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every label timed, with its derived rate; returns {label:
    {"wall_ms", "device_ms"[, "ns_per_row" or "GB_per_s"]}}."""
    inp = inputs(device, **shape)
    return mp.time_labels(functions(inp), device, runs, warmup, log,
                          width=46, derived=derived(inp))


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
