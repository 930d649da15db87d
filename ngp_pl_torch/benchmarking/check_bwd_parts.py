"""The encode backward's cost split into its parts at the bench's N: the
counterpart of benchmarking/check_bwd_parts.py.

    python -m ngp_pl_torch.benchmarking.check_bwd_parts [--n_features 4]
        [--device cuda]

The grid: at `--n_features 4` the flagship's (L=8, F=4, T=2^19, scale
0.5: K1, K2+K5), at 2 the JAX script's own `make_grid_spec()` (L=16, F=2,
per-level scale 1.3819: K3, K4).  N=262,144; the table from a torch
generator seeded 0, w1 N(0, 0.2^2) seeded 1, x U(0, 1)^3 seeded 2, g N(0,
1) seeded 3.  The JAX parts under the JAX script's labels:
  "pallas fwd (gather+kernel)"  the encode kernel with its feats, as the
                                train step calls it (the row gather is
                                the kernel's own)
  "pallas bwd kernel only"      the table-gradient kernel: the call's
                                device ms and, apart, the kernel's alone
                                without the gradient's zero fill
  "d_w1big contraction"         d_w1 = bf16(feats)^T bf16(g) in f32, the
                                backward's matmul
  "per-level scatter (real slots)", "per-level scatter (run-repeated
  slots)"                       null: the scatter-add is inside the
                                table-gradient kernel (the reason is in
                                the record)
and the kernels again on run-repeated slots, as the JAX script builds
them: at level l a run of 1176 / R_l samples in one brick row.  One x
serves every level here, so the samples lie on lines parallel to the x
axis at steps of 1/588 (a brick of level l, 2 / R_l wide, holds 1176 /
R_l of them), each line's y and z from numpy's `default_rng(0)`.  Each
part: the fenced wall ms of 20 calls after 3 and, on the card, the device
ms a call.  The table goes to stderr; on stdout a JSON line of the setup,
then {label: {"wall_ms", "device_ms", ...}}.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

N = 262144
RUN_LINE = 588                 # samples a unit of x: 1176 / R a brick
FUSED = "the per-level scatter-add is inside the table-gradient kernel"
LABELS = ("pallas fwd (gather+kernel)", "pallas bwd kernel only",
          "d_w1big contraction", "per-level scatter (real slots)",
          "per-level scatter (run-repeated slots)")
RUN_LABELS = ("pallas fwd (gather+kernel), run-repeated slots",
              "pallas bwd kernel only, run-repeated slots")


def geometry(n_features: int):
    """The flagship's grid at F=4, the JAX script's `make_grid_spec()` at
    F=2."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.models.ngp import grid_spec_for
    from ngp_pl_torch.ops.hash_encoding import make_grid_spec

    if n_features == 2:
        return make_grid_spec()
    return grid_spec_for(TrainConfig().ngp_config())


def run_repeated_x(n: int, device) -> torch.Tensor:
    """n samples on lines along x at steps of 1 / RUN_LINE, each line's y
    and z uniform from numpy's `default_rng(0)`."""
    lines = -(-n // RUN_LINE)
    yz = np.random.default_rng(0).random((lines, 2))
    x = (np.arange(RUN_LINE) + 0.5) / RUN_LINE
    pts = np.concatenate([np.broadcast_to(x[None, :, None],
                                          (lines, RUN_LINE, 1)),
                          np.broadcast_to(yz[:, None, :],
                                          (lines, RUN_LINE, 2))], axis=-1)
    return torch.as_tensor(pts.reshape(-1, 3)[:n], dtype=torch.float32,
                           device=device).contiguous()


def inputs(spec, n: int, device):
    """(x, table, w1, g) on `device`."""
    from ngp_pl_torch.ops.hash_encoding import init_hash_table

    gen = [torch.Generator().manual_seed(s) for s in range(4)]
    table = init_hash_table(spec, gen[0])
    w1 = torch.randn((spec.out_dim, 64), generator=gen[1]) * 0.2
    x = torch.rand((n, 3), generator=gen[2])
    g = torch.randn((n, 64), generator=gen[3])
    return tuple(t.to(device) for t in (x, table, w1, g))


def part_fns(spec, x, table, w1, g) -> dict:
    """The encode kernel with feats, the table-gradient kernel and the d_w1
    product on these inputs, by label."""
    from ngp_pl_torch.ops import hash_encoding as he

    enc = he.encode_table(table, spec)
    feats = torch.empty((x.shape[0], spec.out_dim), device=x.device)
    he.hash_encode_fwd(x, enc, w1, spec, feats)
    return dict(zip(LABELS[:3], (
        lambda: he.hash_encode_fwd(x, enc, w1, spec, feats),
        lambda: he.hash_encode_bwd(x, g, w1, spec),
        lambda: he._bf(feats).T @ he._bf(g))))


def _time(fn, device, runs, warmup, kernel=None) -> dict:
    """profile_step.timeit, and with `kernel` the device ms of the kernel
    alone beside the call's (the table gradient's zero fill apart)."""
    from ngp_pl_torch.benchmarking.profile_step import timeit

    rec = timeit(fn, device, runs=runs, warmup=warmup)
    if kernel and rec["device_ms"] is not None:
        from ngp_pl_torch.benchmarking.timing import device_split_ms

        rec["kernel_device_ms"], rec["device_ms"] = device_split_ms(
            fn, (kernel,), runs=runs)
    return rec


def run(n_features: int = 4, device="cuda", n: int = N, runs: int = 20,
        warmup: int = 3, log=None) -> dict:
    """{"setup": ..., "parts": {label: record}}."""
    log = log or sys.stderr
    spec = geometry(n_features)
    x, table, w1, g = inputs(spec, n, device)
    parts = {}
    bwd = "hash_encode_bwd_kernel"
    for label, fn in part_fns(spec, x, table, w1, g).items():
        parts[label] = _time(fn, device, runs, warmup,
                             bwd if "bwd" in label else None)
    for label in LABELS[3:]:
        parts[label] = {"wall_ms": None, "device_ms": None, "null": FUSED}
    fns = part_fns(spec, run_repeated_x(n, device), table, w1, g)
    for label, key in zip(RUN_LABELS, LABELS[:2]):
        parts[label] = _time(fns[key], device, runs, warmup,
                             bwd if "bwd" in label else None)
    for label, r in parts.items():
        if r["wall_ms"] is None:
            print(f"{label:44s}     null  ({r['null']})", file=log,
                  flush=True)
            continue
        print(f"{label:44s} {r['wall_ms']:8.2f} ms"
              + ("" if r["device_ms"] is None
                 else f"  device {r['device_ms']:8.3f} ms"), file=log,
              flush=True)
    setup = {"n": n, "n_levels": spec.n_levels, "n_features": n_features,
             "resolutions": list(spec.resolutions),
             "runs_per_level": [max(1, int(1176 / r))
                                for r in spec.resolutions]}
    return {"setup": setup, "parts": parts}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--n_features", type=int, default=4, choices=[2, 4])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(args.n_features, args.device)
    print(json.dumps({**rec["setup"], "card": card_line(args.device)}),
          flush=True)
    print(json.dumps(rec["parts"]), flush=True)
    return rec


if __name__ == "__main__":
    main()
