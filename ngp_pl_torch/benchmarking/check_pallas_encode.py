"""The fused encode with its hand kernels against its plain versions,
checked and timed: the counterpart of benchmarking/check_pallas_encode.py.

    [CHECK_L=16] [CHECK_F=2] python -m \
        ngp_pl_torch.benchmarking.check_pallas_encode [--device cuda]

The JAX script holds its Pallas encode (`_encode_mlp_pl_cv`) against the
XLA path (`_encode_mlp_cv`), another function (f32 rows, no f16 copy, per
lane weights), to 1e-2.  The port's plain versions compute the function
its kernels compute, so the port holds `hash_encode_mlp` with the kernels
(K1, and K2+K5 in the backward, at F=4; K3 and K4 at F=2) against the same
op with the plain versions (`plain.plain_versions`) on the same (x, table,
w1, g).  Under the JAX labels "XLA" is the plain versions, "Pallas" the
kernels.

The geometry: CHECK_L levels of CHECK_F features (the JAX script's knobs,
16 and 2 by default), T=2^19, `make_grid_spec`'s other defaults; its table
U(-1e-4, 1e-4) times 1e4 (values of order 1) from a torch generator seeded
0, w1 N(0, 0.2^2) seeded 1.  The check at N=4096 (x U(0, 1)^3 seeded 2, g
N(0, 1) seeded 3): h1's error of max |h1| ("fwd rel err"), the table
gradient's and w1's ("bwd rel err: d_table ... d_w1 ..."), beside the JAX
script's asserts (1e-2, 1e-2, 2e-2).  The reference runs on the CPU: at a
few thousand samples cuBLAS sums the plain table gradient's d_wr in
another order than the kernel and the CPU do and rounds single products to
the other bf16 neighbour (tests/test_torch_port_guard.py).  The times at
N=262,144 (x seeded 4, g seeded 5): "XLA fwd", "Pallas fwd", "XLA
fwd+bwd", "Pallas fwd+bwd" (both gradients reduced to a scalar, as the JAX
script reduces them), each the fenced wall ms of 20 calls after 3
(`profile_step.timeit`) and, on the card, the device ms a call
(`timing.device_ms`; null on the CPU).  The table goes to stderr; on
stdout "OK" or "MISMATCH" (the JAX script's asserts), then a JSON line:
the geometry, the errors, the times.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

N_CHECK = 4096
N_TIME = 262144
# the JAX script's asserts
LIMITS = {"fwd": 1e-2, "d_table": 1e-2, "d_w1": 2e-2}
LABELS = ("XLA fwd", "Pallas fwd", "XLA fwd+bwd", "Pallas fwd+bwd")


def geometry(n_levels: int, n_features: int):
    """The JAX script's grid, `make_grid_spec(n_levels, n_features)`."""
    from ngp_pl_torch.ops.hash_encoding import make_grid_spec

    return make_grid_spec(n_levels=n_levels, n_features=n_features)


def inputs(spec, n: int, seed: int, device):
    """(x, table, w1, g) on `device`: the script's table and w1, x (n, 3)
    and g (n, 64) from `seed` and `seed` + 1."""
    from ngp_pl_torch.ops.hash_encoding import init_hash_table

    table = init_hash_table(spec, torch.Generator().manual_seed(0)) * 1e4
    w1 = torch.randn((spec.out_dim, 64),
                     generator=torch.Generator().manual_seed(1)) * 0.2
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))
    g = torch.randn((n, 64),
                    generator=torch.Generator().manual_seed(seed + 1))
    return tuple(t.to(device) for t in (x, table, w1, g))


def encode_grads(spec, x, table, w1, g):
    """h1 of `hash_encode_mlp` and the gradients of sum(h1 * g) to the
    table and w1, on the inputs' device."""
    from ngp_pl_torch.ops.hash_encoding import encode_table, hash_encode_mlp

    t = table.detach().clone().requires_grad_(True)
    w = w1.detach().clone().requires_grad_(True)
    h1 = hash_encode_mlp(x, t, w, encode_table(t.detach(), spec), spec)
    d_t, d_w = torch.autograd.grad((h1 * g).sum(), [t, w])
    return h1.detach(), d_t, d_w


def _rel(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max() / (b.abs().max() + 1e-9))


def check(spec, x, table, w1, g) -> dict:
    """The kernels' h1, d_table and d_w1 on the inputs' device against the
    plain versions' on the CPU: errors of max."""
    got = encode_grads(spec, x, table, w1, g)
    ref = encode_grads(spec, *(t.cpu() for t in (x, table, w1, g)))
    return dict(zip(("fwd", "d_table", "d_w1"),
                    (_rel(a, b) for a, b in zip(got, ref))))


def time_fns(spec, x, table, w1, g) -> dict:
    """The four timed calls by label: fwd, fwd+bwd; "XLA" ones run in
    `plain_versions`."""
    from ngp_pl_torch.ops.hash_encoding import encode_table, hash_encode_mlp

    t = table.detach().clone().requires_grad_(True)
    w = w1.detach().clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            return hash_encode_mlp(x, t, w, encode_table(t.detach(), spec),
                                   spec).sum()

    def grad():
        h1 = hash_encode_mlp(x, t, w, encode_table(t.detach(), spec), spec)
        d_t, d_w = torch.autograd.grad((h1 * g).sum(), [t, w])
        return (d_t * d_t).sum() + (d_w * d_w).sum()

    return dict(zip(LABELS, (fwd, fwd, grad, grad)))


def run(n_levels: int = 16, n_features: int = 2, device="cuda",
        n_check: int = N_CHECK, n_time: int = N_TIME, runs: int = 20,
        warmup: int = 3, log=None) -> dict:
    """The check and the times of one geometry; returns the record."""
    from ngp_pl_torch.benchmarking.plain import ALL, plain_versions
    from ngp_pl_torch.benchmarking.profile_step import timeit

    log = log or sys.stderr
    spec = geometry(n_levels, n_features)
    print(f"geometry L={n_levels} F={n_features} W={spec.row_width}",
          file=log, flush=True)
    err = check(spec, *inputs(spec, n_check, 2, device))
    print(f"fwd rel err: {err['fwd']:.2e}", file=log, flush=True)
    print(f"bwd rel err: d_table {err['d_table']:.2e}  d_w1 "
          f"{err['d_w1']:.2e}", file=log, flush=True)
    fns = time_fns(spec, *inputs(spec, n_time, 4, device))
    times = {}
    for label, fn in fns.items():
        if label.startswith("XLA"):
            with plain_versions(*ALL):
                times[label] = timeit(fn, device, runs=runs, warmup=warmup)
        else:
            times[label] = timeit(fn, device, runs=runs, warmup=warmup)
        dev_ms = times[label]["device_ms"]
        print(f"{label:44s} {times[label]['wall_ms']:8.2f} ms"
              + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms"),
              file=log, flush=True)
    return {"n_levels": n_levels, "n_features": n_features,
            "row_width": spec.row_width, "n_check": n_check,
            "n_time": n_time, "rel_err": err, "limits": LIMITS,
            "ok": all(err[k] < LIMITS[k] for k in LIMITS), "times": times}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(int(os.environ.get("CHECK_L", 16)),
              int(os.environ.get("CHECK_F", 2)), args.device)
    print("OK" if rec["ok"] else "MISMATCH", flush=True)
    print(json.dumps({**rec, "card": card_line(args.device)}), flush=True)
    return rec


if __name__ == "__main__":
    main()
