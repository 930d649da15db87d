"""Scatter structure for the level-paired table design, and cumsum
structures at pool size, the counterpart of benchmarking/micro_scatter.py.

    python -m ngp_pl_torch.benchmarking.micro_scatter [--device cuda]
        [--N 196608 --R 16384 --rays 8192]

The JAX script's inputs, all drawn from `np.random.default_rng(0)` in its
order and cast as it casts them: (8, N, 128) f32 rows ~ U(0, 1) and (8, N)
slots into R rows; (4, N, 256) rows and their bf16 copy; level 0's slots
with the first 0%, 50% and 87.5% of them past the end (R + 5); slots in
runs of 1, 8 and 64; N/8 and N/64 slots for the pre-combined runs; an (N,)
pool, an (N, 8) payload, N sorted ray ids in [0, rays) and each ray's
first slot.

Labels (`LABELS`, the JAX script's): 8 scatters of 128-lane rows against 4
of 256-lane rows (f32, and bf16 cast to f32), one 128-lane scatter with
out-of-range rows dropped (`NOTES`), with runs of equal slots, and of the
pre-combined runs; `torch.cumsum` against the hierarchical (512 x N/512)
cumsum, flat and (N, 8); `segment_sum`; the hierarchical cumsum's
boundary difference as a segment sum.  Beside the run cases
(`PORT_LABELS`): K6.  K6 clamps an out-of-range index to the last row
where `mode="drop"` drops it (as `scatter_accum` clips), so it is not
timed on the out-of-range cases.
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(N=196608, R=16384, rays=8192)
OOB = (0.0, 0.5, 0.875)
RUNS = (1, 8, 64)
DEDUP = (8, 64)
HIER = 512                      # the hierarchical cumsum's blocks
LABELS = ("8 x N x 128-lane f32 scatters",
          "4 x N x 256-lane f32 scatters (paired)",
          "4 x N x 256-lane bf16-in scatters (paired)",
          "1 x N x 128 scatter, 0% OOB-dropped",
          "1 x N x 128 scatter, 50% OOB-dropped",
          "1 x N x 128 scatter, 87% OOB-dropped",
          "1 x N x 128 scatter, runs of 1",
          "1 x N x 128 scatter, runs of 8",
          "1 x N x 128 scatter, runs of 64",
          "1 x 24576 x 128 scatter (dedup by 8)",
          "1 x 3072 x 128 scatter (dedup by 64)",
          "jnp.cumsum (N,)", "hierarchical cumsum (512 x N/512)",
          "jnp.cumsum (N, 8) axis 0", "hierarchical cumsum (N, 8)",
          "segment_sum (N, 8) -> 8192",
          "hier-cumsum + boundary-diff segsum")
PORT_LABELS = tuple(f"port: K6 scatter_rows 1 x N x 128, runs of {r}"
                    for r in RUNS)
KEYS = LABELS + PORT_LABELS
NOTES = {
    **{k: mp.DROP_NOTE for k in LABELS[3:6]},
    LABELS[11]: "torch.cumsum", LABELS[13]: "torch.cumsum along dim 0",
    LABELS[15]: mp.SEGMENT_SUM_NOTE,
    "port: K6": ("not timed on the out-of-range cases: K6 clamps an index "
                 "past the end to the last row, mode='drop' drops it"),
}


def inputs(device: str, N: int = 196608, R: int = 16384, rays: int = 8192,
           seed: int = 0) -> dict:
    """The JAX script's inputs (see the module note), on `device`."""
    rng = np.random.default_rng(seed)
    t = functools.partial(mp.tensor, device=device)
    f32, i64 = torch.float32, torch.int64
    inp = dict(N=N, R=R, rays=rays)
    inp["d128"] = t(rng.random((8, N, 128)), f32)
    slots8 = rng.integers(0, R, (8, N)).astype(np.int32)
    inp["slots8"] = t(slots8, i64)
    inp["d256"] = t(rng.random((4, N, 256)), f32)
    inp["d256b"] = inp["d256"].to(torch.bfloat16)
    oob = []
    for frac in OOB:
        sl2 = slots8[0].copy()
        sl2[:int(N * frac)] = R + 5
        oob.append(t(sl2, i64))
    inp["oob"] = oob
    inp["runs"] = [t(np.repeat(rng.integers(0, R, N // run), run)
                     .astype(np.int32), i64) for run in RUNS]
    inp["dedup"] = [t(rng.integers(0, R, N // run), i64) for run in DEDUP]
    inp["x"] = t(rng.random(N), f32)
    inp["xw"] = t(rng.random((N, 8)), f32)
    seg = np.sort(rng.integers(0, rays, N)).astype(np.int32)
    inp["seg"] = t(seg, i64)
    inp["offs"] = t(np.searchsorted(seg, np.arange(rays)), i64)
    return inp


def hier_cumsum(x, blocks: int = HIER):
    """Cumsum of x along dim 0 in `blocks` rows: each row's own cumsum
    plus the sum of the rows before it."""
    n = x.shape[0]
    x2 = x.reshape(blocks, n // blocks, *x.shape[1:])
    inner = torch.cumsum(x2, 1)
    last = inner[:, -1]
    carry = torch.cat([torch.zeros_like(last[:1]),
                       torch.cumsum(last, 0)[:-1]])
    return inner + carry[:, None]


def boundary_segsum(xw, offs):
    """Segment sums as the difference of the hierarchical cumsum at each
    segment's two ends."""
    n = xw.shape[0]
    cs = hier_cumsum(xw).reshape(n, -1)
    padded = torch.cat([torch.zeros_like(cs[:1]), cs])
    ends = torch.cat([offs[1:], torch.full((1,), n, dtype=offs.dtype,
                                           device=offs.device)])
    return padded[ends] - padded[offs]


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, by KEYS."""
    R = inp["R"]
    d128, slots8, d256 = inp["d128"], inp["slots8"], inp["d256"]
    d1 = d128[0]
    calls = [
        lambda: [mp.scatter_add(R, slots8[l], d128[l]) for l in range(8)],
        lambda: [mp.scatter_add(R, slots8[p], d256[p]) for p in range(4)],
        lambda: [mp.scatter_add(R, slots8[p], inp["d256b"][p].float())
                 for p in range(4)]]
    calls += [lambda s=s: mp.scatter_add(R, s, d1, drop=True)
              for s in inp["oob"]]
    calls += [lambda s=s: mp.scatter_add(R, s, d1) for s in inp["runs"]]
    calls += [lambda s=s: mp.scatter_add(R, s, d1[:s.shape[0]])
              for s in inp["dedup"]]
    x, xw = inp["x"], inp["xw"]
    calls += [lambda: torch.cumsum(x, 0), lambda: hier_cumsum(x),
              lambda: torch.cumsum(xw, 0), lambda: hier_cumsum(xw),
              lambda: mp.segment_sum(xw, inp["seg"], inp["rays"]),
              lambda: boundary_segsum(xw, inp["offs"])]
    calls += [lambda s=s: mp.k6_scatter(R, s, d1) for s in inp["runs"]]
    return dict(zip(KEYS, calls))


def references(inp: dict, fns: dict) -> dict:
    return {p: ("K6", fns[LABELS[6 + i]]) for i, p in enumerate(PORT_LABELS)}


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every label timed; returns {label: {"wall_ms", "device_ms"}}."""
    return mp.time_labels(functions(inputs(device, **shape)), device, runs,
                          warmup, log)


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
