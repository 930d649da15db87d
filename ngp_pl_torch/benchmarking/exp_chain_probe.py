"""The exponential-step chain on the card against the CPU, in two routes,
and its time on the card:

    python -m ngp_pl_torch.benchmarking.exp_chain_probe [--rays 8192]

`ray_march.chain_t` takes its exp and log, and the cascade pick its log2,
through float64, correctly rounded to float32 on either device (route
"float64").  Route "float32" takes torch's float32 exp, log and log2
instead.  On bench_mc's grid (4 cascades of 128^3 at scale 4) with a
random occupancy of 30%, rays from 6-12 away towards the box and 512 chain
steps each, the probe reports per route: the share of chain positions, and
the count of two-window bits (`_occ_window_chain_mc`) and of direct
lookups (`occupancy_at`) that differ between the card and the CPU; and the
card's CUDA-event time of the two-window chain.  Also the share of the
chain's exp arguments where the card's float32 exp and the CPU's differ.
One JSON line, with the card's name and power limit."""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess

import numpy as np
import torch

from ngp_pl_torch.benchmarking.timing import time_ms
from ngp_pl_torch.ops import ray_march as trm

G, C, SCALE, F_EXP, MS = 128, 4, 4.0, 1.0 / 256, 1024
KA = 128                      # intervals of 4 steps: 512 chain steps


@contextlib.contextmanager
def route(name):
    """Within the block the chain and the cascade pick take torch's
    float32 exp, log and log2 when `name` is "float32"."""
    saved = trm._exp, trm._log, trm._floor_log2
    if name == "float32":
        trm._exp, trm._log = torch.exp, torch.log
        trm._floor_log2 = lambda x: torch.floor(torch.log2(x)).to(
            torch.int64)
    try:
        yield
    finally:
        trm._exp, trm._log, trm._floor_log2 = saved


def inputs(n_rays, seed):
    rng = np.random.default_rng(seed)
    occ = (rng.random((C, G, G, G)) < 0.3).astype(np.uint8)
    cam = rng.normal(size=(n_rays, 3))
    cam *= rng.uniform(6.0, 12.0, (n_rays, 1)) / np.linalg.norm(
        cam, axis=1, keepdims=True)
    d = -cam + rng.normal(size=(n_rays, 3)) * 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = rng.uniform(0.5, 3.0, n_rays)
    return [torch.from_numpy(a.astype(np.float32)) if a.dtype.kind == "f"
            else torch.from_numpy(a) for a in (occ, cam, d, t0)]


def march(occ, win, ro, rd, t0):
    """(bits of the two-window chain, chain positions, direct bits)."""
    dt_min = math.sqrt(3.0) / MS
    dt_max = math.sqrt(3.0) * 2.0 * SCALE / G
    bits, ts, dts = trm._occ_window_chain_mc(
        ro, rd, t0, KA, win, cascades=C, scale=SCALE, grid_size=G,
        exp_step_factor=F_EXP, dt_min=dt_min, dt_max=dt_max)
    direct = trm.occupancy_at(occ, trm._positions(ts, ro, rd), dts, C,
                              SCALE, G)
    return bits, ts, direct


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    host = inputs(args.rays, args.seed)
    host.insert(1, trm.occupancy_windows(host[0]))
    card = [t.cuda() for t in host]
    out = {}
    for name in ("float64", "float32"):
        with route(name):
            a = march(*host)
            b = [t.cpu() for t in march(*card)]
            ms = time_ms(lambda: march(*card))
        out[name] = dict(
            ts_differ_share=float((a[1] != b[1]).float().mean()),
            window_bits_differ=int((a[0] != b[0]).sum()),
            direct_bits_differ=int((a[2] != b[2]).sum()),
            positions=a[1].numel(), card_ms=ms)
    k = torch.arange(2 * MS, dtype=torch.float32)
    x = (k[None, :] * math.log1p(F_EXP)
         - torch.rand(4096, 1, generator=torch.Generator().manual_seed(1)))
    out["exp_f32_card_vs_cpu_differ_share"] = float(
        (torch.exp(x) != torch.exp(x.cuda()).cpu()).float().mean())
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
