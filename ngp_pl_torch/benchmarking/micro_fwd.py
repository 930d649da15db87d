"""Encode-forward ablation bench (K9), the counterpart of
benchmarking/micro_pallas_fwd.py.

    python -m ngp_pl_torch.benchmarking.micro_fwd [--interleaved]
    python -m ngp_pl_torch.benchmarking.micro_fwd --device cpu --n 256 \\
        --bn 128 --interleaved

Times the five stripped variants of the packed-f16 encode forward that the
JAX bench's `main()` times, on its inputs: L=8, rows of 64 u32 words, H=64,
F=4, N=196,608, from numpy `default_rng(0)` (rows from integers(0, 2^31),
then meta_T and w1big U[0, 1)).  With `--interleaved` (the JAX bench's
MAIN2) also the full variant on rows laid out (N/bn, L, bn, 64) and the
gather into that layout (`index_select`, as XLA's gather there).  Beside
them, the port's K1 (`hash_encode_fwd`), which gathers its own corners, at
N random points of the flagship grid: K9-full against K1 splits K1's time
into gather and math.

Prints one JSON line per row: the median time of 20 calls after 3 of
warm-up (CUDA events, the wrapper's host work included), as the JAX bench
times; on the card also the device time of the row's kernels alone (mean of
20 more calls under torch.profiler, `timing.device_ms`; every kernel of the
call for gather_il) and the bound's share of it; the least time the card
could take (the larger of the bytes over 3.35 TB/s and the operations over
the peak rate of their type, H100 data sheet) and which of the two it is;
and the launches of the row's kernel (warm-up, timed and profiled calls).  The rows are 402.7 MB, far past the 50 MB L2; K1's table
points stay in it.  Runs on the card unless `--device cpu`, where the plain
versions run and their host times are reported as `cpu_ms`; without CUDA it
raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from ngp_pl_torch.benchmarking import bench_inputs as bi
from ngp_pl_torch.benchmarking.roofline import bound, k1_work
from ngp_pl_torch.benchmarking.timing import device_ms
from ngp_pl_torch.config import TrainConfig
from ngp_pl_torch.device import resolve_device
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops import encode_ablations as ea
from ngp_pl_torch.ops import hash_encoding as he

L = bi.K9_LEVELS
N_BENCH = bi.K9_N
BN = bi.K9_BN                  # the interleaved layout's block
GATHER_ROWS = 100000           # rows of the table gathered from (MAIN2)
SEED = bi.K9_SEED              # the JAX bench's default_rng(0)
RUNS, WARMUP = 20, 3           # timed calls and warm-up calls per row
K9_NAMES = ("encode_ablation",)   # the K9 kernels as the profiler names them


def variant_work(variant: str, levels: int, n: int):
    """(bytes, bf16 tensor flops, f32 operations) one call of a K9 variant
    must move and do: each input read once (meta_T's 3 rows of p-values,
    not its pad row), each output written once."""
    rows = levels * n * ea.WH * 4
    out = n * ea.H * 4 + levels * ea.F * n * 4
    if variant == "stream":
        return rows + out, 0.0, float(levels * n * ea.WH)
    meta = 0 if variant == "no_wrow" else levels * 3 * n * 4
    w1 = levels * ea.W * ea.H * 4
    # per sample and level: 27 point weights (3 hats of 3 operations and 2
    # products each) and 128 weighted lanes, then 108 feature additions
    weights = 0 if variant == "no_wrow" else ea.N_PTS * 11 + ea.W
    feats = 0 if variant == "no_ft" else ea.N_PTS * ea.F
    return (rows + meta + w1 + out, 2.0 * n * levels * ea.W * ea.H,
            float(levels * n * (weights + feats)))


def time_ms(fn: Callable, dev: torch.device) -> float:
    """Median time of one call over RUNS after WARMUP: CUDA events on the
    card, the host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(RUNS):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device="cuda", n: int = N_BENCH, interleaved: bool = False,
        bn: int = BN,
        emit: Optional[Callable[[Dict], None]] = None) -> List[Dict]:
    """Time every row once; `emit` gets each record as it is made (default:
    print it as one JSON line)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if on_card else "cpu"
    emit = emit or (lambda rec: print(json.dumps(rec), flush=True))
    (rows, meta_T, w1big), rng = bi.k9_inputs(n, dev, L)
    records = []

    def record(name, fn, work, counter=None, names=None):
        before = counter.launches if counter is not None else 0
        ms = time_ms(fn, dev)
        bound_ms, bound_by = bound(*work[:3])
        rec = {"row": name, "n": n, "device": card,
               "ms" if on_card else "cpu_ms": ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": work[0]}
        if on_card:
            rec["device_ms"] = device_ms(fn, names, runs=RUNS)
            rec["bound_share"] = bound_ms / rec["device_ms"]
        rec["launches"] = (counter.launches - before
                           if counter is not None else 0)
        records.append(rec)
        emit(rec)

    for v in ("full", "no_decode", "no_wrow", "no_ft", "stream"):
        record(v, lambda v=v: ea.encode_ablation(v, rows, meta_T, w1big),
               variant_work(v, L, n), ea.CUDA[v], K9_NAMES)
    if interleaved:
        rows_il = ea.interleave(rows, bn)
        record("full_il", lambda: ea.encode_ablation("full_il", rows_il,
                                                     meta_T, w1big, bn),
               variant_work("full_il", L, n), ea.CUDA["full_il"], K9_NAMES)
        del rows_il
        slot = torch.from_numpy(rng.integers(0, GATHER_ROWS, (L, n))).to(dev)
        sl = slot.reshape(L, n // bn, bn).transpose(0, 1).reshape(-1)
        packed = torch.zeros((GATHER_ROWS, ea.WH), dtype=torch.int32,
                             device=dev)
        # XLA's gather in the JAX bench; reads the table and the indices,
        # writes the interleaved rows
        record("gather_il", lambda: packed.index_select(0, sl),
               (packed.numel() * 4 + sl.numel() * 8 + L * n * ea.WH * 4,
                0.0, 0.0))
        del slot, sl, packed
    del rows, meta_T, w1big

    ngp = NGP(TrainConfig().ngp_config(), seed=SEED, device=dev)
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(SEED)
                   ).to(dev)
    table, w1 = ngp.encode_table(), ngp.sigma_mlp[0].detach()
    record("k1", lambda: he.hash_encode_fwd(x, table, w1, ngp.spec),
           k1_work(x, ngp.spec, table, w1), he.hash_encode_fwd_cuda,
           ("hash_encode_fwd_kernel",))
    return records


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=N_BENCH,
                   help="samples; a multiple of 128 and of --bn")
    p.add_argument("--bn", type=int, default=BN,
                   help="block of the interleaved layout")
    p.add_argument("--interleaved", action="store_true",
                   help="also the interleaved full variant and its gather")
    a = p.parse_args(argv)
    return run(a.device, a.n, a.interleaved, a.bn)


if __name__ == "__main__":
    main()
