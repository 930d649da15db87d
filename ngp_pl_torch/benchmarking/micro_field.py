"""The small MLP stack after the encode, and the field's fwd+bwd gap, the
counterpart of benchmarking/micro_field.py.

    python -m ngp_pl_torch.benchmarking.micro_field [--device cuda]

The flagship (L=8, F=4, T=2^19 at scale 0.5, `TrainConfig`'s; seed 0:
the JAX script's `NGPConfig(scale=0.5)` is its package's default L16F2)
and N = 262,144 inputs drawn from torch generators seeded 1 (JAX:
PRNGKey(1)).  Two parts, under the JAX script's labels:
  main    (`MAIN`) the stack after the encode as the JAX script times it,
          through the port's `mlp_apply` (the tail of `_mlp_apply`, bf16
          dots with f32 sums; the field's own tail on the card is K7):
          sigma = trunc_exp of the density MLP's first output, SH of the
          directions, the colour MLP; fwd, fwd+bwd to the parameters, to
          the parameters and dh1, SH alone, fwd with the outputs kept;
  bisect  (`BISECT`) the encode (`hash_encode_mlp`: K1, and K2+K5 in the
          backward on the card) with g = ones and g = cos h1, the density,
          and `NGP.forward` (K1 + K7, then K8 + K2+K5), each fwd+bwd to the
          table.
Each: the fenced wall ms of 20 calls after 3 (`profile_step.timeit`,
the JAX script's `timeit`) and, on the card, the device ms of its kernels
a call (`timing.device_ms`).  The table goes to stderr; on stdout a JSON
line of the setup, then, last, {label: {"wall_ms", "device_ms"}}.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

MAIN = ("mlp-stack fwd", "mlp-stack fwd+bwd (params only)",
        "mlp-stack fwd+bwd (params + dh1)", "sh fwd",
        "mlp-stack fwd (materialize outs)")
BISECT = ("bisect: encode fwd+bwd (g=ones)",
          "bisect: encode fwd+bwd (g=cos h1)", "bisect: density fwd+bwd",
          "bisect: forward fwd+bwd")
N_DEFAULT = 262144


def model(device: str, **kw):
    """The flagship at scale 0.5 (`kw` changes its NGPConfig), seed 0."""
    import dataclasses

    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.models.ngp import NGP

    cfg = dataclasses.replace(TrainConfig(scale=0.5).ngp_config(), **kw)
    return NGP(cfg, seed=0, device=device)


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def stack(ngp, h1: torch.Tensor, d: torch.Tensor):
    """The JAX script's `stack`: (sigma (N,), rgb (N, 3)) from the first
    layer's pre-activation h1 (N, 64) and unit directions d (N, 3)."""
    from ngp_pl_torch.models.ngp import mlp_apply
    from ngp_pl_torch.ops.sh import sh_encode
    from ngp_pl_torch.ops.trunc_exp import trunc_exp

    h = mlp_apply(list(ngp.sigma_mlp[1:]), torch.relu(h1))
    sigma = trunc_exp(h[:, 0])
    sh = sh_encode((d + 1.0) * 0.5, ngp.cfg.sh_degree)
    rgb = mlp_apply(list(ngp.rgb_mlp), torch.cat([sh, h], dim=-1),
                    torch.sigmoid)
    return sigma, rgb


def main_fns(ngp, n: int) -> dict:
    """The main part's calls by label, on h1 ~ N(0, 1) and unit d."""
    from ngp_pl_torch.ops.sh import sh_encode

    dev = ngp.hash_table.device
    gen = torch.Generator().manual_seed(1)
    h1 = torch.randn((n, 64), generator=gen).to(dev)
    d = _unit(torch.randn((n, 3), generator=gen)).to(dev)
    ws = list(ngp.sigma_mlp[1:]) + list(ngp.rgb_mlp)
    first_rgb = len(ngp.sigma_mlp) - 1

    def fwd(h=h1):
        s, r = stack(ngp, h, d)
        return s.sum() + r.sum()

    def fwd_only():
        with torch.no_grad():
            return fwd()

    def grad_p():
        return torch.autograd.grad(fwd(), ws)[first_rgb].sum()

    def grad_ph():
        h = h1.detach().requires_grad_(True)
        gs = torch.autograd.grad(fwd(h), ws + [h])
        return gs[first_rgb].sum() + gs[-1].sum()

    def sh_only():
        return sh_encode((d + 1.0) * 0.5, ngp.cfg.sh_degree).sum()

    def fwd_mat():
        with torch.no_grad():
            return stack(ngp, h1, d)

    return dict(zip(MAIN, (fwd_only, grad_p, grad_ph, sh_only, fwd_mat)))


def bisect_fns(ngp, n: int) -> dict:
    """The bisect part's calls by label, on xyz ~ U(-0.5, 0.5)^3 and unit
    d ~ N(0, 1)^3."""
    from ngp_pl_torch.ops.hash_encoding import hash_encode_mlp

    dev = ngp.hash_table.device
    gen = torch.Generator().manual_seed(1)
    xyz = (torch.rand((n, 3), generator=gen) - 0.5).to(dev)
    d = _unit(torch.randn((n, 3), generator=gen)).to(dev)
    scale = ngp.cfg.scale
    xn = ((xyz + scale) / (2 * scale)).contiguous()
    table = ngp.hash_table

    def table_grad(loss):
        (g,) = torch.autograd.grad(loss, [table])
        return (g * g).sum()

    def h1():
        return hash_encode_mlp(xn, table, ngp.sigma_mlp[0],
                               ngp.encode_table(), ngp.spec)

    def forward():
        s, r = ngp(xyz, d)
        return s.sum() + r.sum()

    return dict(zip(BISECT, (
        lambda: table_grad(h1().sum()),
        lambda: table_grad(torch.sin(h1()).sum()),
        lambda: table_grad(ngp.density(xyz).sum()),
        lambda: table_grad(forward()))))


def run(device: str = "cuda", n: int = N_DEFAULT, runs: int = 20,
        warmup: int = 3, log=sys.stderr, **cfg) -> dict:
    """Both parts timed; returns {label: {"wall_ms", "device_ms"}} in
    order (MAIN, then BISECT)."""
    from ngp_pl_torch.benchmarking.profile_step import timeit

    ngp = model(device, **cfg)
    out = {}
    for fns in (main_fns(ngp, n), bisect_fns(ngp, n)):
        for label, fn in fns.items():
            out[label] = timeit(fn, device, runs=runs, warmup=warmup)
            dev_ms = out[label]["device_ms"]
            print(f"{label:44s} {out[label]['wall_ms']:8.2f} ms"
                  + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms"),
                  file=log, flush=True)
    return out


def main(argv=None) -> dict:
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(args.device)
    print(json.dumps({"n": N_DEFAULT, "card": card_line(args.device)}),
          flush=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
