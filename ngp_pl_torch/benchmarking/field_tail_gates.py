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

`tail_rounded_as` gives the plain tail another implementation's bf16
roundings of its hidden layers, read back through probe weights:
chip_smoke.py holds K7 by it on the trained steps (`k7_by_rounding`).
"""
from __future__ import annotations

import argparse
import json
import math

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


# `tail_rounded_as` reads a value back through a sigmoid of at most
# READ_SPAN, and its bf16 rounding only where |value| x scale >= READ_MIN,
# where one bf16 step lies 16x past the f32 sigmoid's resolution; one
# scale reads 11 binary orders of magnitude, READ_SCALES scales 10 orders
# apart read a layer down to ~1e-9 of its largest value.
READ_SPAN = 8.0
READ_MIN = 4e-3
READ_SCALES = 3


def _probes(layer, idx, w2, wr1, wr2, wr3, scale):
    """The tail's weights with those past `layer` replaced so that output
    channel c is `scale` times the bf16 value that the tail feeds on from
    `layer` ("h", "r1" or "r2": bf16 h, relu(z1), relu(z2)) at column
    idx[c], exactly: every product has one nonzero factor a power of two
    and the rest zero, h passes as relu(h) - relu(-h).  New tensors, built
    on the host."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)     # noqa: E731
    wr3n = z(ft.H_HID, 3)
    if layer == "r2":
        for c, j in enumerate(idx):
            wr3n[j, c] = scale
        return w2, wr1, wr2, wr3n.to(w2.device)
    wr2n = z(ft.H_HID, ft.H_HID)
    if layer == "r1":
        for c, j in enumerate(idx):
            wr2n[j, c], wr3n[c, c] = 1.0, scale
        return w2, wr1, wr2n.to(w2.device), wr3n.to(w2.device)
    wr1n = z(ft.H_SH + ft.H_GEO, ft.H_HID)
    for c, j in enumerate(idx):
        a, b = 2 * c, 2 * c + 1
        wr1n[ft.H_SH + j, a], wr1n[ft.H_SH + j, b] = 1.0, -1.0
        wr2n[a, a], wr2n[b, a], wr2n[a, b], wr2n[b, b] = 1.0, -1.0, -1.0, 1.0
        wr3n[a, c], wr3n[b, c] = scale, -scale
    return (w2, *(w.to(w2.device) for w in (wr1n, wr2n, wr3n)))


def tail_rounded_as(tail, h1, sh, w2, wr1, wr2, wr3, tol):
    """The plain tail (`field_tail_plain`, f32 sums) with the bf16 roundings
    of its hidden layers that another implementation `tail` of it (K7)
    makes on the same inputs, and what that shows of `tail`.

    The plain and the kernel round h, relu(z1) and relu(z2) to bf16 after
    summing exact products in different orders, so a value near a
    rounding midpoint can round to the other neighbour and move rgb by
    ~1e-3.  `tail` is run again on probe weights (`_probes`) that carry
    each bf16 hidden value it fed on to an rgb output, 3 a launch, read
    back through the sigmoid; layer by layer the plain tail, fed with the
    values so read at the layer before, takes them where it rounds
    otherwise.  Returns ((sigma, rgb), seen): `out_of_window`, the values
    that lie outside the bf16 roundings of the plain's value +- tol x
    max |plain| of the layer (the kernel's value before its rounding
    missed the plain's past tol), `flips`, the values it rounds to the
    other side, `unread`, those too small to read (there the plain's
    rounding stands), and `max_rel_err`, the largest of max |rgb - ref|
    and max |log sigma - ref| of `tail`'s outputs against the returned
    ones, each of max |ref|."""
    mm = lambda a, b: _bf(a) @ _bf(b)      # noqa: E731  field_tail_plain's
    seen = dict(out_of_window=0, flips=0, unread=0)

    def take(layer, pre, relu, ws):
        act = torch.relu if relu else (lambda t: t)
        plain = _bf(act(pre))
        mag, m, n = plain.abs(), float(pre.abs().max()), pre.shape[1]
        if not m > 0.0:
            return plain
        got = torch.zeros_like(pre)
        read = torch.zeros_like(pre, dtype=torch.bool)
        top = 2.0 ** math.floor(math.log2(READ_SPAN / float(mag.max())))
        for i in range(READ_SCALES):
            scale = top * 2.0 ** (10 * i)
            pick = (mag * scale >= READ_MIN) & (mag * scale <= READ_SPAN)
            for c0 in range(0, n, 3):
                idx = list(range(c0, min(c0 + 3, n)))
                if not bool(pick[:, idx].any()):
                    continue
                p = tail(h1, sh, *_probes(layer, idx, *ws, scale))[1]
                p = p[:, :len(idx)].double()
                val = ((torch.log(p) - torch.log1p(-p)) / scale).float()
                got[:, idx] = torch.where(pick[:, idx], val, got[:, idx])
            read |= pick
        got = _bf(got)
        lo, hi = _bf(act(pre - tol * m)), _bf(act(pre + tol * m))
        seen["out_of_window"] += int((read & ~((got >= lo) & (got <= hi)))
                                     .sum())
        seen["flips"] += int((read & (got != plain)).sum())
        seen["unread"] += int((~read).sum())
        return torch.where(read & torch.isfinite(got), got, plain)

    ws = (w2, wr1, wr2, wr3)
    h = mm(torch.relu(h1), w2)
    hb = take("h", h, False, ws)
    z1 = mm(sh, wr1[:ft.H_SH]) + hb @ _bf(wr1[ft.H_SH:])
    r1 = take("r1", z1, True, ws)
    r2 = take("r2", r1 @ _bf(wr2), True, ws)
    sigma = torch.exp(torch.clamp(h[:, 0], -30.0, 30.0))
    rgb = torch.sigmoid(r2 @ _bf(wr3))
    got = tail(h1, sh, w2, wr1, wr2, wr3)
    seen["max_rel_err"] = max(
        float((got[1] - rgb).abs().max() / rgb.abs().max()),
        float((torch.log(got[0]) - torch.log(sigma)).abs().max()
              / torch.log(sigma).abs().max()))
    return (sigma, rgb), seen


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
