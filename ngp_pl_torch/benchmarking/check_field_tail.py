"""The field tail's hand kernels (K7 forward, K8 backward) against the plain
tail on the device: the counterpart of benchmarking/check_field_tail.py.

    python -m ngp_pl_torch.benchmarking.check_field_tail [--device cuda]

The JAX script's inputs, drawn as it draws them from numpy's
`default_rng(0)`: P=8192, h1 N(0, 1) (P, 64), sh N(0, 0.3^2) (P, 16), w2
(64, 16), wr1 (32, 64), wr2 (64, 64), wr3 (64, 3) N(0, 0.2^2), then g N(0,
1) (P, 4).  Its "XLA tail" is the port's plain tail (`field_tail_plain`:
bf16 operands, f32 sums), which the port also runs with float64 sums, as
chip_smoke.py holds K7 and K8.  Forward: `field_tail` (K7 on the card)
against it, the JAX script's errors (sigma's relative to |sigma| + 1e-3,
rgb's absolute) and chip_smoke's (`field_tail_gates.k7_error` against the
f32 and the float64 tail, held to K7_TOL there).  Backward: the gradients
of sum(sigma g[:, 0] 1e-2) + sum(rgb g[:, 1:]) to h1, w2, wr1, wr2 and wr3
through `field_tail_fn` (K8 on the card) against `field_tail_bwd_plain`
with f32 and with float64 sums: the JAX script's error of max per output
(its d_h1 ... d_wr2; d_wr3 besides) and chip_smoke's (K8_F32_TOL and
K8_TOL).  Prints the JAX script's lines, each with chip_smoke's readings
and limits beside, then its "OK" (every JAX error under its limit: sigma
and the gradients 5e-2, rgb 5e-3) or "MISMATCH", then a JSON line of the
readings.  chip_smoke's limits are read from chip_smoke.py in the
checkout, or given to `run`.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

P = 8192
GRAD_NAMES = ("d_h1", "d_w2", "d_wr1", "d_wr2", "d_wr3")
# the JAX script's limits
SIGMA_LIMIT, RGB_LIMIT, GRAD_LIMIT = 5e-2, 5e-3, 5e-2


def inputs(n: int = P):
    """(h1, sh, w2, wr1, wr2, wr3, g) as float32 numpy arrays."""
    rng = np.random.default_rng(0)
    shapes = ((n, 64, 1.0), (n, 16, 0.3), (64, 16, 0.2), (32, 64, 0.2),
              (64, 64, 0.2), (64, 3, 0.2))
    out = [rng.normal(0, s, (a, b)).astype(np.float32) for a, b, s in shapes]
    out.append(rng.normal(0, 1, (n, 4)).astype(np.float32))
    return tuple(out)


def chip_smoke_limits() -> dict:
    """K7_TOL, K8_F32_TOL and K8_TOL of chip_smoke.py in this checkout."""
    from ngp_pl_torch.benchmarking.trained_gate_probe import chip_smoke

    cs = chip_smoke()
    return {k: getattr(cs, k) for k in ("K7_TOL", "K8_F32_TOL", "K8_TOL")}


def run(device="cuda", n: int = P, limits=None, out=None) -> dict:
    """The readings; prints the JAX script's lines and its verdict (to
    stdout unless `out` is given)."""
    from ngp_pl_torch.benchmarking.field_tail_gates import k7_error
    from ngp_pl_torch.ops import field_tail as ft

    out = out or sys.stdout
    limits = limits or chip_smoke_limits()
    *arrs, g = (torch.from_numpy(a).to(device) for a in inputs(n))
    h1, sh, *ws = arrs
    sig, rgb = ft.field_tail(h1, sh, *ws)
    s32, r32 = ft.field_tail_plain(h1, sh, *ws)
    e_sig = float(((sig - s32).abs() / (s32.abs() + 1e-3)).max())
    e_rgb = float((rgb - r32).abs().max())
    k7 = {"vs_f32": k7_error((sig, rgb), (s32, r32)),
          "vs_float64": k7_error(
              (sig, rgb), ft.field_tail_plain(h1, sh, *ws,
                                              acc=torch.float64))}
    print(f"fwd: sigma rel err {e_sig:.2e}  rgb abs err {e_rgb:.2e}"
          f"   [chip_smoke K7 {k7['vs_f32']:.2e} / {k7['vs_float64']:.2e}"
          f" (f32 / float64 sums) of K7_TOL {limits['K7_TOL']:.0e}]",
          file=out, flush=True)

    leaves = [h1.detach().clone().requires_grad_(True)] + [
        w.detach().clone().requires_grad_(True) for w in ws]
    s, r = ft.field_tail_fn(leaves[0], sh, *leaves[1:])
    loss = (s * g[:, 0] * 1e-2).sum() + (r * g[:, 1:]).sum()
    got = torch.autograd.grad(loss, leaves)
    g_sigma, g_rgb = (g[:, 0] * 1e-2).contiguous(), g[:, 1:].contiguous()
    ref32 = ft.field_tail_bwd_plain(h1, sh, g_sigma, g_rgb, *ws)
    ref64 = ft.field_tail_bwd_plain(h1, sh, g_sigma, g_rgb, *ws,
                                    acc=torch.float64)

    def rel(a, b, floor):
        return float((a - b).abs().max() / (b.abs().max() + floor))

    bwd, k8 = {}, {}
    for name, a, b32, b64 in zip(GRAD_NAMES, got, ref32, ref64):
        bwd[name] = rel(a, b32, 1e-6)
        k8[name] = {"vs_f32": rel(a, b32, 0.0), "vs_float64": rel(a, b64, 0.0)}
        print(f"bwd {name}: rel err {bwd[name]:.2e}   [chip_smoke K8 "
              f"{k8[name]['vs_f32']:.2e} of K8_F32_TOL "
              f"{limits['K8_F32_TOL']:.0e}, {k8[name]['vs_float64']:.2e} "
              f"of K8_TOL {limits['K8_TOL']:.0e}]", file=out, flush=True)
    ok = (e_sig < SIGMA_LIMIT and e_rgb < RGB_LIMIT
          and all(v < GRAD_LIMIT for v in bwd.values()))
    print("OK" if ok else "MISMATCH", file=out, flush=True)
    return {"n": n, "sigma_rel_err": e_sig, "rgb_abs_err": e_rgb,
            "bwd_rel_err": bwd, "ok": ok, "k7": k7, "k8": k8,
            "limits": {"sigma": SIGMA_LIMIT, "rgb": RGB_LIMIT,
                       "grad": GRAD_LIMIT, **limits}}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(args.device)
    print(json.dumps({**rec, "card": card_line(args.device)}), flush=True)
    return rec


if __name__ == "__main__":
    main()
