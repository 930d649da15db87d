"""Where the fused encode's forward and backward time goes at pool shapes,
stage by stage: the counterpart of benchmarking/micro_encode_fwd.py.

    [MICRO_N=262144] python -m ngp_pl_torch.benchmarking.micro_encode_fwd
        [--device cuda]

The JAX script's grid (L=8, F=4, T=2^19, per-level scale 1.3819^2), H=64,
N = MICRO_N (262,144); from numpy's `default_rng(0)` in its order x U(0,
1)^3, w1 N(0, 0.1^2), g N(0, 1); the table from a torch generator seeded
0.  The stages under the JAX script's labels:
  "slot math (L,N)"        `slots_local_frac_lm` (the kernels compute the
                           same from x themselves)
  "slot math + meta_T"     null: the corner weights are the kernels' own
  "gather f32"             null: K1 gathers its own rows
  "cast+gather bf16"       `table_f16`, the f16 copy K1 reads (its gather
                           is K1's own)
  "pallas fwd kernel (rows pre-gathered)"  K1 with feats
  "pallas bwd kernel (d_rows)"  K2+K5 (its scatter-add fused)
  "per-level scatter-add"  null: inside K2+K5
  "dL/dw1 contraction"     bf16(feats)^T bf16(g) in f32
Each: the fenced wall ms of 20 calls after 3 and, on the card, the device
ms a call.  The table goes to stderr; on stdout a JSON line of the setup,
then {label: {"wall_ms", "device_ms", "port"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

H = 64
STAGES = ("slot math (L,N)", "slot math + meta_T", "gather f32",
          "cast+gather bf16", "pallas fwd kernel (rows pre-gathered)",
          "pallas bwd kernel (d_rows)", "per-level scatter-add",
          "dL/dw1 contraction")
# what the port runs under each label, or why nothing
PORT = {"slot math (L,N)": "slots_local_frac_lm",
        "slot math + meta_T": None, "gather f32": None,
        "cast+gather bf16": "table_f16 (the gather is K1's own)",
        "pallas fwd kernel (rows pre-gathered)": "K1 with feats",
        "pallas bwd kernel (d_rows)": "K2+K5",
        "per-level scatter-add": None,
        "dL/dw1 contraction": "bf16(feats)^T bf16(g)"}
NULL = {"slot math + meta_T": "the corner weights are computed in K1 and "
                              "K2+K5 from x",
        "gather f32": "K1 gathers its own rows",
        "per-level scatter-add": "the scatter-add is inside K2+K5"}


def geometry():
    from ngp_pl_torch.ops.hash_encoding import make_grid_spec

    return make_grid_spec(n_levels=8, n_features=4,
                          per_level_scale=1.3819 ** 2)


def inputs(spec, n: int, device):
    """(x, table, w1, g) on `device`."""
    from ngp_pl_torch.ops.hash_encoding import init_hash_table

    rng = np.random.default_rng(0)
    x = rng.random((n, 3)).astype(np.float32)
    w1 = rng.normal(0, 0.1, (spec.out_dim, H)).astype(np.float32)
    g = rng.normal(0, 1, (n, H)).astype(np.float32)
    table = init_hash_table(spec, torch.Generator().manual_seed(0))
    return (torch.from_numpy(x).to(device), table.to(device),
            torch.from_numpy(w1).to(device), torch.from_numpy(g).to(device))


def stage_fns(spec, x, table, w1, g) -> dict:
    """The timed stages by label (the null ones left out)."""
    from ngp_pl_torch.ops import hash_encoding as he

    enc = he.table_f16(table)
    feats = torch.empty((x.shape[0], spec.out_dim), device=x.device)
    he.hash_encode_fwd(x, enc, w1, spec, feats)

    def slots():
        slot, local, frac = he.slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
        return slot.sum() + local.sum() + frac.sum()

    return {"slot math (L,N)": slots,
            "cast+gather bf16": lambda: he.table_f16(table),
            "pallas fwd kernel (rows pre-gathered)":
                lambda: he.hash_encode_fwd(x, enc, w1, spec, feats),
            "pallas bwd kernel (d_rows)":
                lambda: he.hash_encode_bwd(x, g, w1, spec),
            "dL/dw1 contraction": lambda: he._bf(feats).T @ he._bf(g)}


def run(device="cuda", n: int = 262144, runs: int = 20, warmup: int = 3,
        log=None) -> dict:
    """{label: {"wall_ms", "device_ms", "port"}} in the JAX order."""
    from ngp_pl_torch.benchmarking.profile_step import timeit

    log = log or sys.stderr
    spec = geometry()
    fns = stage_fns(spec, *inputs(spec, n, device))
    out = {}
    for label in STAGES:
        if label in NULL:
            out[label] = {"wall_ms": None, "device_ms": None,
                          "port": None, "null": NULL[label]}
            print(f"{label:46s}     null  ({NULL[label]})", file=log,
                  flush=True)
            continue
        out[label] = {**timeit(fns[label], device, runs=runs,
                               warmup=warmup), "port": PORT[label]}
        dev_ms = out[label]["device_ms"]
        print(f"{label:46s} {out[label]['wall_ms']:8.3f} ms"
              + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms"),
              file=log, flush=True)
    return out


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n = int(os.environ.get("MICRO_N", 262144))
    rec = run(args.device, n)
    print(json.dumps({"n": n, "n_levels": 8, "n_features": 4,
                      "card": card_line(args.device)}), flush=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
