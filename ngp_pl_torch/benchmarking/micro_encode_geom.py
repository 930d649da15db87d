"""The fused encode's forward and forward+backward across the two table
geometries at pool shapes: the counterpart of
benchmarking/micro_encode_geom.py.

    python -m ngp_pl_torch.benchmarking.micro_encode_geom [--device cuda]

`bench_spec` as the JAX script's: N=262,144, H=64; the table, w1 (N(0,
0.05^2)) and x (U(0, 1)^3) from one torch generator seeded 0 (the JAX
script draws all three from PRNGKey(0)); "fwd" is sum(h1) of
`hash_encode_mlp` (K1 at F=4, K3 at F=2), "fwd+bwd" the table gradient of
sum(sin h1) (K2+K5, K4 in its backward), reduced to a scalar.  The
geometries: "L16 F2 (reference geom)" (T=2^19, per-level scale 1.3819)
and "L8 F4 (tile rows)" (per-level scale (2048 x 0.5 / 16)^(1/7)).  Each:
the fenced wall ms of 20 calls after 3 and, on the card, the device ms a
call.  The table goes to stderr; on stdout, last, a JSON line {label:
{"wall_ms", "device_ms"}} with each geometry's rows, width and MB.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch


def geometries():
    """(tag, spec) of both, in the JAX script's order."""
    from ngp_pl_torch.ops.hash_encoding import make_grid_spec

    b8 = math.exp(math.log(2048 * 0.5 / 16) / 7)
    return (("L16 F2 (reference geom)",
             make_grid_spec(n_levels=16, n_features=2, log2_hashmap_size=19,
                            per_level_scale=1.3819)),
            ("L8 F4 (tile rows)",
             make_grid_spec(n_levels=8, n_features=4, log2_hashmap_size=19,
                            per_level_scale=b8)))


def bench_spec(tag, spec, device="cuda", n: int = 262144, h: int = 64,
               runs: int = 20, warmup: int = 3, log=None) -> dict:
    """The JAX `bench_spec`: {"rows", "width", "mb", "<tag> fwd",
    "<tag> fwd+bwd"}."""
    from ngp_pl_torch.benchmarking.profile_step import timeit
    from ngp_pl_torch.ops.hash_encoding import (
        encode_table,
        hash_encode_mlp,
        init_hash_table,
    )

    log = log or sys.stderr

    gen = torch.Generator().manual_seed(0)
    table = init_hash_table(spec, gen).to(device).requires_grad_(True)
    w1 = (torch.randn((spec.out_dim, h), generator=gen) * 0.05).to(device)
    x = torch.rand((n, 3), generator=gen).to(device)
    mb = spec.total_rows * spec.row_width * 4 / 1e6
    print(f"{tag}: rows {spec.total_rows} width {spec.row_width} "
          f"({mb:.0f} MB)", file=log, flush=True)

    def h1():
        return hash_encode_mlp(x, table, w1, encode_table(table.detach(),
                                                          spec), spec)

    def fwd():
        with torch.no_grad():
            return h1().sum()

    def grad():
        (d,) = torch.autograd.grad(torch.sin(h1()).sum(), [table])
        return d.sum()

    out = {"rows": spec.total_rows, "width": spec.row_width, "mb": mb}
    for label, fn in ((f"{tag} fwd", fwd), (f"{tag} fwd+bwd", grad)):
        out[label] = timeit(fn, device, runs=runs, warmup=warmup)
        dev_ms = out[label]["device_ms"]
        print(f"{label:52s} {out[label]['wall_ms']:8.2f} ms"
              + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms"),
              file=log, flush=True)
    return out


def run(device="cuda", **kw) -> dict:
    """Both geometries; {tag: bench_spec's record}."""
    return {tag: bench_spec(tag, spec, device, **kw)
            for tag, spec in geometries()}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(args.device)
    print(json.dumps({"card": card_line(args.device), **rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
