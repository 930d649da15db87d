"""The rounds-layout train step part by part, the counterpart of
benchmarking/profile_rounds.py.

    python -m ngp_pl_torch.benchmarking.profile_rounds [--batch 8192]
        [--warm 512] [--enc_only] [--device cuda]

bench.py's operating point (`profile_step.profile_system`: the flagship on
8 procedural views at 96x96, batch `--batch`, JAX: PROF_BATCH) with the
layout pinned to rounds, warmed `--warm` steps in 16-step blocks (JAX:
PROF_WARM, 512) to the rounds layout's steady S and per-round chain; then
`freeze_buckets`, and under the JAX script's labels (`LABELS`):
  step_block [rounds|csr|strided] /16   one block in each layout (6 runs)
  rounds render fwd, fwd+bwd            `render_rays_train_rounds`
  march round, field fwd, fwd+bwd       round r < 4 at max(256, B >> r)
                                        slots x S (`march_rays_test_round`,
                                        `NGP.forward_rays`)
  the encoder's parts at B x S slot-samples (rounded down to 4096s, at
  least 4096), each the port's own stage where the port fuses the JAX
  stage (`FUSED`): K1 alone for the slot/meta and gather stages and the
  Pallas forward, K2+K5 without its zero fill (the kernel's device time)
  for the Pallas backward and with it for the per-level scatters, and the
  f16 table copy, which has no JAX label;
  encode+l1 fwd, fwd+bwd                `hash_encode_mlp`
  field tail fwd, fwd+bwd(dh1)          K7, K7 + K8 (`field_tail_fn`)
  strided composite fwd+bwd, march strided, strided render fwd+bwd, and
  one grid refresh (5 runs).
With `--enc_only` (JAX: PROF_ENC_ONLY) only the strided block and the
parts from the encoder on.  The ray batch, its noise and the random
inputs come from `np.random.default_rng(0)` in the JAX script's order.

Each part: the fenced wall ms of 20 calls after 3
(`profile_step.timeit`, the JAX script's `timeit`) and, on the card, the
device ms of its kernels a call (`timing.device_ms`).  The table goes to
stderr; on stdout a JSON line of the setup (S, chain, card), then, last,
{label: {"wall_ms", "device_ms", "port"}} ("port" names the port's stage
where it is not the JAX one; device_ms null on the CPU).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

LAYOUTS = ("rounds", "csr", "strided")
ROUNDS = 4                       # the rounds layout's unrolled rounds
BLOCK_RUNS = 6
GRID_RUNS = 5
ENC_ROWS = 4096                  # the slot-samples round to this
K2_KERNEL = "hash_encode_bwd"    # K2+K5's kernel, without its zero fill
# the JAX labels whose stage the port fuses, and the port's stage timed
FUSED = {
    "slots+meta (sum-fenced)": "K1 alone (slots and trilinear meta are "
                               "computed inside K1)",
    "packed-f16 row gather (L*N rows)": "K1 alone (K1 gathers the f16 rows "
                                        "itself)",
    "pallas encode fwd (decode+wrow+mxu)": "K1 alone, with its features",
    "pallas encode bwd (d_rows)": "K2+K5 without its zero fill (the "
                                  "kernel's device time)",
    "per-level table scatter-add": "K2+K5 with its zero fill (the scatter "
                                   "is fused into K2)",
    "field tail fwd": "K7",
    "field tail fwd+bwd(dh1)": "K7 + K8",
}
F16_COPY = "f16 table copy (port)"


def block_label(layout: str, nb: int) -> str:
    return f"step_block [{layout}] /{nb}"


def round_labels(slots: int, S: int):
    return (f"march round (slots {slots} S {S})",
            f"field fwd (slots {slots} S {S})",
            f"field fwd+bwd (slots {slots} S {S})")


def warm(system, steps: int, log=sys.stderr) -> dict:
    """The camera marking and `steps // 16` blocks; then the buckets
    freeze.  Returns the setup at the steady state."""
    from ngp_pl_torch.device import card_line

    B, nb = system.tcfg.batch_size, system.tcfg.grid_update_interval
    system.on_train_start()
    print("warming to rounds steady state...", file=log, flush=True)
    m = None
    for _ in range(steps // nb):
        m = system.step_block()
    setup = {"layout": system.layout, "batch": B, "warm": steps,
             "S": system._pool_mult, "rounds_chain": system._rounds_chain,
             "chain_length": system.chain_length,
             "card": card_line(system.dev)}
    if m is not None:
        setup.update(loss=float(m["loss"]),
                     rm_s=float(m["rm_samples"]) / B,
                     vr_s=float(m["vr_samples"]) / B)
    print(f"steady: layout {setup['layout']} S {setup['S']} rounds_chain "
          f"{setup['rounds_chain']} rm_s {setup.get('rm_s', 0.0):.1f} "
          f"vr_s {setup.get('vr_s', 0.0):.1f}", file=log, flush=True)
    system.freeze_buckets = True
    return setup


def part_fns(system, enc_only: bool = False, seed: int = 0) -> dict:
    """Every part after the blocks, by label, each a call of no
    arguments, on the system's frozen state."""
    from ngp_pl_torch.benchmarking.profile_step import ray_batch
    from ngp_pl_torch.models.occupancy import update_density_grid
    from ngp_pl_torch.models.rendering import (
        render_rays_train,
        render_rays_train_rounds,
        scene_hits,
    )
    from ngp_pl_torch.ops.field_tail import field_tail, field_tail_fn
    from ngp_pl_torch.ops.hash_encoding import (
        hash_encode_bwd,
        hash_encode_fwd,
        hash_encode_mlp,
        table_f16,
    )
    from ngp_pl_torch.ops.ray_march import (
        _fma,
        march_rays_test_round,
        march_rays_train_strided,
    )
    from ngp_pl_torch.ops.volume_render import composite_train_strided

    ngp, cfg, rcfg = system.ngp, system.cfg, system.rcfg
    gs, dev = system.grid_state, system.dev
    S, chain = system._pool_mult, system._rounds_chain
    B = system.tcfg.batch_size
    occ = gs.occ_grid
    win_rows = gs.win_rows if system.window_march else None
    rng = np.random.default_rng(seed)
    rays_o, rays_d, noise = ray_batch(system, rng=rng)
    bg = torch.ones(3, device=dev)
    table = ngp.hash_table

    def table_grad(loss):
        (g,) = torch.autograd.grad(loss, [table])
        return (g * g).sum()

    fns = {}
    if not enc_only:
        def rounds():
            return render_rays_train_rounds(
                ngp, win_rows, rays_o, rays_d, noise, bg, rcfg=rcfg,
                n_samples=S, chain_length=chain, occ_grid=occ)["rgb"].sum()

        def rounds_fwd():
            with torch.no_grad():
                return rounds()

        fns["rounds render fwd"] = rounds_fwd
        fns["rounds render fwd+bwd"] = lambda: table_grad(rounds())
        hits = scene_hits(rays_o, rays_d, cfg.scale)
        t_end = hits[:, 1]
        t_cur0 = torch.where(hits[:, 0] >= 0, hits[:, 0], t_end)
        for r in range(ROUNDS):
            slots = max(256, B >> r)
            ro, rd = rays_o[:slots], rays_d[:slots]
            tc, te = t_cur0[:slots], t_end[:slots]

            def march_r(ro=ro, rd=rd, tc=tc, te=te):
                return march_rays_test_round(
                    ro, rd, tc, te, occ, cascades=cfg.cascades,
                    scale=cfg.scale, exp_step_factor=cfg.exp_step_factor,
                    grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
                    n_samples=S, chain_length=chain, win_rows=win_rows)

            ts = march_r()[0]
            xyz = _fma(ts[..., None], rd[:, None, :], ro[:, None, :])

            def field(xyz=xyz, rd=rd):
                s, c = ngp.forward_rays(xyz, rd)
                return s.sum() + c.sum()

            def field_fwd(field=field):
                with torch.no_grad():
                    return field()

            march_l, fwd_l, grad_l = round_labels(slots, S)
            fns[march_l] = lambda march_r=march_r: march_r()[3]
            fns[fwd_l] = field_fwd
            fns[grad_l] = lambda field=field: table_grad(field())

    # the encoder's parts at B x S slot-samples
    spec = ngp.spec
    total = max(ENC_ROWS, B * S // ENC_ROWS * ENC_ROWS)
    xs = torch.as_tensor(rng.random((total, 3)), dtype=torch.float32,
                         device=dev)
    w1 = ngp.sigma_mlp[0].detach()
    enc = ngp.encode_table()
    feats = torch.empty((total, spec.out_dim), device=dev)
    g = torch.as_tensor(rng.random((total, w1.shape[-1])),
                        dtype=torch.float32, device=dev)

    def k1_alone():
        return hash_encode_fwd(xs, enc, w1, spec)

    def enc_public():
        return hash_encode_mlp(xs, table, ngp.sigma_mlp[0], ngp.encode_table(),
                               spec).sum()

    def enc_fwd():
        with torch.no_grad():
            return enc_public()

    fns.update({
        "slots+meta (sum-fenced)": k1_alone,
        "packed-f16 row gather (L*N rows)": k1_alone,
        "pallas encode fwd (decode+wrow+mxu)":
            lambda: hash_encode_fwd(xs, enc, w1, spec, feats),
        "pallas encode bwd (d_rows)": lambda: hash_encode_bwd(xs, g, w1,
                                                              spec),
        "per-level table scatter-add": lambda: hash_encode_bwd(xs, g, w1,
                                                               spec),
        F16_COPY: lambda: table_f16(table.detach()),
        "encode+l1 fwd (public)": enc_fwd,
        "encode+l1 fwd+bwd (public)": lambda: table_grad(enc_public()),
    })
    # the fused field tail at the same shape
    h1 = k1_alone()
    sh = torch.as_tensor(rng.random((16, total)), dtype=torch.float32,
                         device=dev).T.contiguous()
    ws = [w.detach() for w in (ngp.sigma_mlp[1], ngp.rgb_mlp[0],
                               ngp.rgb_mlp[1], ngp.rgb_mlp[2])]

    def tail_fwd():
        s, c = field_tail(h1, sh, *ws)
        return s.sum() + c.sum()

    def tail_grad():
        h = h1.detach().requires_grad_(True)
        s, c = field_tail_fn(h, sh, *ws)
        (gh,) = torch.autograd.grad(s.sum() + c.sum(), [h])
        return (gh * h1).sum()

    fns["field tail fwd"] = tail_fwd
    fns["field tail fwd+bwd(dh1)"] = tail_grad

    # the strided compositor at (B, S)
    sig = torch.as_tensor(rng.random((B, S)), dtype=torch.float32,
                          device=dev).requires_grad_(True)
    rgbs = torch.as_tensor(rng.random((3, B, S)), dtype=torch.float32,
                           device=dev).permute(1, 2, 0).contiguous()
    rgbs.requires_grad_(True)
    dts2 = torch.full((B, S), 1e-3, device=dev)
    ts2 = torch.cumsum(dts2, dim=1)
    val2 = torch.ones((B, S), dtype=torch.bool, device=dev)

    def comp_grad():
        out = composite_train_strided(sig, rgbs, dts2, ts2, val2,
                                      T_threshold=rcfg.t_threshold)
        gs_, gr = torch.autograd.grad(out["rgb"].sum() + out["depth"].sum(),
                                      [sig, rgbs])
        return gs_.sum() + gr.sum()

    fns["strided composite fwd+bwd"] = comp_grad
    # the strided march and render at the training shape
    hits2 = scene_hits(rays_o, rays_d, cfg.scale)
    chain_tr = system.chain_length

    def march_str():
        m = march_rays_train_strided(
            rays_o, rays_d, hits2, noise, win_rows, cascades=cfg.cascades,
            scale=cfg.scale, exp_step_factor=cfg.exp_step_factor,
            grid_size=cfg.grid_size, max_samples=rcfg.max_samples,
            n_samples=S, chain_length=chain_tr, occ_grid=occ)
        return m.ts.sum() + m.total

    def render_str_grad():
        out = render_rays_train(ngp, win_rows, rays_o, rays_d, noise, bg,
                                rcfg=rcfg, n_samples=S, chain_length=chain_tr,
                                occ_grid=occ)
        return table_grad(out["rgb"].sum())

    fns[f"march strided (chain {chain_tr})"] = march_str
    fns["strided render fwd+bwd"] = render_str_grad
    gen = torch.Generator(device=dev).manual_seed(7)
    fns["grid update (amortize /16)"] = lambda: update_density_grid(
        ngp, gs, system.density_threshold, warmup=False, erode=False,
        generator=gen).mean_density
    return fns


def _device_ms(fn, label: str, runs: int):
    """The part's device ms a call: K2+K5's kernel alone for the Pallas
    backward's label, every kernel, copy and fill otherwise."""
    from ngp_pl_torch.benchmarking.timing import device_ms

    names = [K2_KERNEL] if label == "pallas encode bwd (d_rows)" else None
    return device_ms(fn, names=names, runs=runs)


def timeit(fn, label: str, dev, runs: int, warmup: int = 3) -> dict:
    """`profile_step.timeit`'s fenced wall ms, and the device ms as
    `_device_ms` reads it (null on the CPU)."""
    from ngp_pl_torch.benchmarking.profile_step import timeit as wall

    rec = wall(fn, dev, runs=runs, warmup=warmup)
    if rec["device_ms"] is not None and label == "pallas encode bwd (d_rows)":
        rec["device_ms"] = _device_ms(fn, label, runs)
    if label in FUSED:
        rec["port"] = FUSED[label]
    return rec


def run(system, warm_steps: int = 512, enc_only: bool = False,
        runs: int = 20, block_runs: int = BLOCK_RUNS,
        grid_runs: int = GRID_RUNS, warmup: int = 3,
        log=sys.stderr) -> dict:
    """Warm `system` (layout rounds), freeze it, time every part;
    returns {"setup": ..., "parts": {label: record}} in order."""
    if system.layout != "rounds":
        raise ValueError(f"the system steps in {system.layout}; the probe "
                         f"warms the rounds layout")
    setup = warm(system, warm_steps, log)
    nb = system.tcfg.grid_update_interval
    parts = {}

    def show(label):
        rec = parts[label]
        dev_ms = rec["device_ms"]
        print(f"{label:44s} {rec['wall_ms']:8.2f} ms"
              + ("" if dev_ms is None else f"  device {dev_ms:8.3f} ms")
              + (f"  [{rec['port']}]" if "port" in rec else ""),
              file=log, flush=True)

    for layout in (("strided",) if enc_only else LAYOUTS):
        system.layout = layout
        label = block_label(layout, nb)
        parts[label] = timeit(lambda: system.step_block()["loss"], label,
                              system.dev, block_runs, warmup)
        show(label)
        print(f"  -> {parts[label]['wall_ms'] / nb:8.2f} ms/step", file=log,
              flush=True)
    system.layout = "rounds"
    for label, fn in part_fns(system, enc_only).items():
        n = grid_runs if label.startswith("grid update") else runs
        parts[label] = timeit(fn, label, system.dev, n, warmup)
        show(label)
    return {"setup": setup, "parts": parts}


def main(argv=None) -> dict:
    from ngp_pl_torch.benchmarking.profile_step import profile_system

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192,
                    help="rays a step (JAX: PROF_BATCH)")
    ap.add_argument("--warm", type=int, default=512,
                    help="warm-up steps, in 16-step blocks (JAX: PROF_WARM)")
    ap.add_argument("--enc_only", action="store_true",
                    help="the strided block and the encoder's parts only "
                    "(JAX: PROF_ENC_ONLY)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    system = profile_system(args.device, args.batch, "rounds")
    rec = run(system, args.warm, args.enc_only)
    print(json.dumps(rec["setup"]), flush=True)
    print(json.dumps(rec["parts"]), flush=True)
    return rec


if __name__ == "__main__":
    main()
