"""Readings of the two gates that hold K7 and K8 to their plain versions in
chip_smoke.py, on chip_smoke.py's inputs, on the CPU:

    python -m ngp_pl_torch.benchmarking.field_tail_gates [--sizes 393216]

Each gate compares outputs with the plain version in f32 sums and with the
same math in float64 sums (`acc`).  The f32 plain version's own miss of its
float64 twin is what a correct kernel may read against it; a limit must lie
above that and below what a wrong kernel reads.  Wrong kernels are stood in
for by `variant`, the plain math with one deliberate fault each.  One JSON
line per kernel and size: the f32 plain version's miss, and each wrong
variant's reading against both plain versions.
"""
from __future__ import annotations

import argparse
import json

import torch

from ngp_pl_torch.ops import field_tail as ft
from ngp_pl_torch.ops.hash_encoding import _bf

# seeds and clamp scales of chip_smoke.py's K7 and K8 checks
K7_INPUTS = (2, 1e3)      # h[0] far past the +/-30 clamp on 64 rows
K8_INPUTS = (4, 20.0)     # past +/-15
K7_WRONG = ("h_f32", "r2_f16", "no_relu_z2", "clamp15", "skip_group")
K8_WRONG = ("h_f32", "dz3_f32", "wr2_untransposed", "clamp30",
            "no_truncexp", "no_dh1_mask", "skip_tile", "skip_sample")


def tail_inputs(P, seed, clamp_scale, grads=False):
    """h1 (P, 64) N(0, 4) with its first 64 rows times `clamp_scale` and sh
    of random directions, on the CPU; with `grads` also g_sigma (P,) and
    g_rgb (P, 3), N(0, 1e-6)."""
    from ngp_pl_torch.ops.sh import sh_encode

    g = torch.Generator().manual_seed(seed)
    h1 = torch.randn((P, 64), generator=g) * 2.0
    h1[:64] *= clamp_scale
    d = torch.randn((P, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    out = (h1, sh_encode((d + 1.0) * 0.5))
    if grads:
        out += (torch.randn((P,), generator=g) * 1e-3,
                torch.randn((P, 3), generator=g) * 1e-3)
    return out


def model_weights():
    """w2, wr1, wr2, wr3 of the seeded flagship model, on the CPU."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.models.ngp import NGP

    tcfg = TrainConfig(dataset_name="synthetic")
    ngp = NGP(tcfg.ngp_config(), seed=tcfg.seed, device="cpu")
    return [ngp.sigma_mlp[1].detach()] + [w.detach() for w in ngp.rgb_mlp]


def variant(wrong, h1, sh, *rest):
    """K7 (2 + 4 arguments) or K8 (4 + 4) in f32 sums, with the fault
    `wrong`: an operand left unrounded (h_f32, dz3_f32) or rounded to f16
    (r2_f16), a relu, mask or TruncExp term left out, a clamp at the other
    kernel's bound, Wr2 untransposed in the backward, or samples skipped
    (the last group of 16, the last tile of 128, or sample 1000)."""
    def mm(a, b, round_a=True):
        return (_bf(a) if round_a else a) @ _bf(b)

    bwd = len(rest) == 6
    g_sigma, g_rgb, w2, wr1, wr2, wr3 = rest if bwd else (None, None, *rest)
    x = torch.relu(h1)
    h = mm(x, w2)
    z1 = mm(sh, wr1[:ft.H_SH]) + mm(h, wr1[ft.H_SH:], wrong != "h_f32")
    r1 = torch.relu(z1)
    z2 = mm(r1, wr2)
    r2 = z2 if wrong == "no_relu_z2" else torch.relu(z2)
    if wrong == "r2_f16":
        z3 = r2.half().float() @ _bf(wr3)
    else:
        z3 = mm(r2, wr3)
    rgb = torch.sigmoid(z3)
    if not bwd:
        sigma = torch.exp(torch.clamp(h[:, 0], *(
            (-15.0, 15.0) if wrong == "clamp15" else (-30.0, 30.0))))
        if wrong == "skip_group":
            sigma[-16:], rgb[-16:] = 1.0, 0.0
        return sigma, rgb
    if wrong in ("skip_tile", "skip_sample"):
        skip = slice(-128, None) if wrong == "skip_tile" else slice(1000, 1001)
        g_sigma, g_rgb = g_sigma.clone(), g_rgb.clone()
        g_sigma[skip], g_rgb[skip] = 0.0, 0.0
    d_z3 = g_rgb * rgb * (1.0 - rgb)
    d_z2 = torch.where(z2 > 0, mm(d_z3, wr3.T, wrong != "dz3_f32"), 0.0)
    d_z1 = torch.where(z1 > 0, mm(
        d_z2, wr2 if wrong == "wr2_untransposed" else wr2.T), 0.0)
    d_h = mm(d_z1, wr1[ft.H_SH:].T)
    if wrong != "no_truncexp":
        c = 30.0 if wrong == "clamp30" else 15.0
        d_h[:, 0] += g_sigma * torch.exp(torch.clamp(h[:, 0], -c, c))
    dh1 = mm(d_h, w2.T)
    if wrong != "no_dh1_mask":
        dh1 = torch.where(h1 > 0, dh1, 0.0)
    dwr1 = torch.cat([mm(sh.T, d_z1), mm(h.T, d_z1)], dim=0)
    return dh1, mm(x.T, d_h), dwr1, mm(r1.T, d_z2), mm(r2.T, d_z3)


def k7_error(got, ref) -> float:
    """chip_smoke.py's K7 reading: max |rgb - ref| and |log sigma - ref|."""
    return max(float((got[1] - ref[1]).abs().max()),
               float((torch.log(got[0]) - torch.log(ref[0])).abs().max()))


def k8_error(got, ref) -> float:
    """chip_smoke.py's K8 reading: the largest over the five outputs of
    max |x - ref| / max |ref|."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, ref))


def readings(kernel, P, ws=None):
    """The f32 plain version's miss of its float64 twin and each wrong
    variant's (f32, float64) readings, for K7 or K8 at P samples."""
    ws = ws if ws is not None else model_weights()
    if kernel == "K7":
        args = (*tail_inputs(P, *K7_INPUTS), *ws)
        plain, err, wrongs = ft.field_tail_plain, k7_error, K7_WRONG
    else:
        args = (*tail_inputs(P, *K8_INPUTS, grads=True), *ws)
        plain, err, wrongs = ft.field_tail_bwd_plain, k8_error, K8_WRONG
    f32, f64 = plain(*args), plain(*args, acc=torch.float64)
    out = {}
    for w in wrongs:
        got = variant(w, *args)
        out[w] = (err(got, f32), err(got, f64))
    return err(f32, f64), out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    help="sample counts (default: chip_smoke.py's, "
                         "K7 1,048,576 and K8 262,144, both 393,216)")
    sizes = ap.parse_args(argv).sizes
    ws = model_weights()
    for kernel, default in (("K7", (1048576, 393216)),
                            ("K8", (262144, 393216))):
        for P in sizes or default:
            miss, wrong = readings(kernel, P, ws)
            print(json.dumps({"kernel": kernel, "n": P,
                              "f32_plain_vs_float64_sums": miss,
                              "wrong_vs_f32_and_float64": wrong}), flush=True)


if __name__ == "__main__":
    main()
