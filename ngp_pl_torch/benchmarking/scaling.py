"""Weak scaling of data-parallel training (counterpart of
benchmarking/scaling.py and, for the gradient all-reduce's cost, of
benchmarking/psum_micro.py).

    python -m ngp_pl_torch.benchmarking.scaling                # the card
    python -m ngp_pl_torch.benchmarking.scaling --ranks 1 2 --device cpu

The flagship (L=8, F=4, T=2^19, grid 128^3, scale 0.5, CSR, bench.py's
scene of 8 views at 96x96) trains in N ranks, one process per GPU (NCCL;
gloo ranks on the CPU with `--device cpu`), for each N of `--ranks` (which
must hold 1, the base), at `--per_rank` rays per rank, so that each rank's
work stays fixed (weak scaling, as the JAX harness): WARM_STEPS steps in
16-step blocks, the buckets frozen, then `--steps` timed between two
fences.  A run's record: global rays/s, rays/s per rank, the efficiency
(rays/s per rank over the one-rank run's), and `full_pool_steps` of
`csr_steps`, the steps past grid warmup on which some rank's CSR pool was
full (`rm_samples_rank_max`, the most samples a rank's pool kept, at B/N
x the multiple).  Then the largest N
again at SPLIT_RAYS global rays (the flagship's 8192 split N ways), whose
record holds its global rays/s over the one-rank run's (`vs_one_rank`).

Each run also times the gradient all-reduce of its ranks on their own
gradients' sizes (`parallel.grad_mean` of the model's parameters, CUDA
events over 32 calls after 8 untimed; host clock on the CPU): the
all-reduce's ms per step.

Parity, in the largest N: after PARITY_STEPS steps (past grid warmup, so
that the controller has left the warmup budget), rank 0 saves the state
and every rank takes one step's gradient on one explicit global batch
(drawn from a seed) on its shard, at the controller's budget and at a
CSR pool with room (`ROOM_MULT`); a separate one-rank process loads the
state and takes the same batch whole.  The record holds the loss's
relative error and each gradient's largest error over its largest
magnitude at both, and whether the ranks' parameters, Adam moments and
grids are `torch.equal` after the steps.

Prints one JSON line per run and, last, {"metric": "weak_scaling", ...}
with every run, the device's name and the card's power limit.  Files go to
`--out` (build/scaling by default).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ngp_pl_torch.device import sync

PARITY_SEED = 11
WARM_STEPS = 256               # steps before the timed ones
SPLIT_RAYS = 8192              # global rays of the split run
PARITY_STEPS = 512             # steps before the parity step
PARITY_RAYS = 8192             # the parity step's explicit global batch
# The CSR multiple of the parity steps' second reading: a pool of 128 slots
# a ray holds a trained batch (~40 samples a ray) with its staging budget
# to spare, so that N ranks' pools hold the one-rank pool's samples; at
# the warmup's multiple (x32) each rank's pool and staging budget bind on
# its own shard (ROADMAP §4)
ROOM_MULT = 128


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def _system(dev: str, batch: int, tcfg=None):
    """The flagship (or `tcfg`) at a global batch of `batch` rays."""
    import dataclasses

    from ngp_pl_torch.benchmarking.train_setup import (
        train_config,
        train_system,
    )

    tcfg = tcfg or train_config(exp_name="scaling", no_save_test=True)
    return train_system(dataclasses.replace(tcfg, batch_size=batch),
                        dev=dev)


def count_full_pools(system) -> list:
    """Wrap `system`'s train step so that each CSR step past grid warmup
    (where every chain step is occupied and every pool fills) appends (the
    most samples one rank's pool kept, a rank's pool slots) to the list
    returned; `full_pool_steps` counts the steps on which some rank's pool
    filled every slot (a pool keeps at most its slots: where its shard
    found more, the rest were cut)."""
    from ngp_pl_torch import parallel

    seen = []
    step = system._train_step
    b = system.tcfg.batch_size // parallel.world_size()

    def counted():
        counts = (system.layout == "csr" and system._host_step
                  >= system.tcfg.grid_warmup_steps)
        slots = b * system._pool_mult
        m = step()
        if counts:
            seen.append((m["rm_samples_rank_max"], slots))
        return m

    system._train_step = counted
    return seen


def full_pool_steps(seen: list) -> int:
    return sum(int(s) >= slots for s, slots in seen)


def allreduce_ms(system, calls: int = 32) -> float:
    """ms of one `grad_mean` of tensors shaped as the model's gradients."""
    from ngp_pl_torch import parallel

    grads = [torch.randn_like(p) for p in system.optimizer.params]
    for _ in range(8):
        parallel.grad_mean(grads)
    sync(system.dev)
    if system.dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(calls):
            parallel.grad_mean(grads)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / calls
    t = time.perf_counter()
    for _ in range(calls):
        parallel.grad_mean(grads)
    return (time.perf_counter() - t) * 1e3 / calls


def ranks_equal(system) -> bool:
    """Whether every rank holds rank 0's parameters, Adam moments and grid
    (on every rank the same answer)."""
    from ngp_pl_torch import parallel

    gs = system.grid_state
    mine = (system.optimizer.params + system.optimizer.mu
            + system.optimizer.nu + [gs.density_grid, gs.occ_grid])
    ok = True
    for t in mine:
        t0 = t.detach().clone()
        parallel.broadcast_([t0])
        ok = ok and bool(torch.equal(t0, t.detach()))
    flags = parallel.gather_scalars(torch.tensor(
        [float(ok)], dtype=torch.float64, device=system.dev))
    return bool((flags == 1.0).all())


def explicit_grads(system, n_rays: int, seed: int = PARITY_SEED,
                   pool_mult: int = None):
    """(loss, gradients, record) of one step on a global batch of `n_rays`
    drawn from `seed`, each rank on its shard (the whole batch without a
    group), at the system's layout, chain and budget (or the CSR multiple
    `pool_mult`): the global loss and the ranks' mean gradient; no update.
    The record holds this rank's samples found and its pool's slots."""
    from ngp_pl_torch import parallel
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.training.train_step import sample_batch, train_render

    g = torch.Generator(device=system.dev).manual_seed(seed)
    img, pix, payload = (parallel.shard(t) for t in sample_batch(
        system.rays, n_rays, "all_images", g))
    noise = parallel.shard(torch.rand(n_rays, generator=g,
                                      device=system.dev))
    ro, rd = get_rays(system.directions[pix], system.poses[img])
    gs = system.grid_state
    res, loss_of = train_render(
        system.ngp, gs.win_rows if system.window_march else None,
        ro.contiguous(), rd.contiguous(), noise, system.background(),
        tcfg=system.tcfg, rcfg=system.rcfg,
        n_samples=pool_mult or system._pool_mult,
        chain_length=system.step_chain(), layout=system.layout,
        occ_grid=gs.occ_grid)
    loss = loss_of(payload[:, :3])
    grads = parallel.grad_mean(torch.autograd.grad(
        loss, system.optimizer.params))
    loss = parallel.gather_scalars(loss.detach().double().reshape(1)).mean()
    budget = pool_mult or system._pool_mult
    return float(loss), [x.detach().cpu() for x in grads], dict(
        pool_mult=budget, chain=system.step_chain(), layout=system.layout,
        samples=int(res["rm_counts"].sum()),
        slots=n_rays // parallel.world_size() * budget)


@torch.no_grad()
def pool_split(ranks=(2, 4), dev: str = "cuda") -> dict:
    """How far per-rank budgets part from the global one on the seeded
    flagship's first step (grid warmup, every chain step occupied), with
    no process group: the batch's shards are marched here one after the
    other, as N ranks would.  CSR: the slots of the global pool (B x its
    multiple) that differ from the N shards' pools (B/N x the multiple
    each) laid end to end.  Rounds: the rays whose loss mask differs when
    each shard gets max(256, (B/N) >> r) slots in round r instead of
    max(256, B >> r)."""
    from ngp_pl_torch.benchmarking.train_setup import (
        train_config,
        train_system,
    )
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models.rendering import (
        render_rays_train_rounds,
        scene_hits,
    )
    from ngp_pl_torch.ops.ray_march import march_rays_train_window

    out = {}
    for layout in ("csr", "rounds"):
        system = train_system(train_config(train_layout=layout), dev=dev)
        system.on_train_start()
        system._refresh_grid(0)
        img, pix, _ = system.sample_batch()
        noise = torch.rand(system.tcfg.batch_size,
                           generator=system.generator, device=system.dev)
        ro, rd = get_rays(system.directions[pix], system.poses[img])
        ro, rd = ro.contiguous(), rd.contiguous()
        B, cfg, gs = ro.shape[0], system.cfg, system.grid_state

        def run(rows, n):
            o, d = ro[rows].contiguous(), rd[rows].contiguous()
            if layout == "rounds":
                return render_rays_train_rounds(
                    system.ngp, gs.win_rows, o, d, noise[rows],
                    torch.ones(3, device=system.dev), rcfg=system.rcfg,
                    n_samples=system._pool_mult,
                    chain_length=system.step_chain(), occ_grid=gs.occ_grid
                )["loss_mask"]
            m = march_rays_train_window(
                o, d, scene_hits(o, d, cfg.scale), noise[rows],
                gs.win_rows, scale=cfg.scale, grid_size=cfg.grid_size,
                max_samples=system.rcfg.max_samples,
                pool_size=o.shape[0] * system._pool_mult,
                chain_length=system.step_chain())
            at = rows.start
            return torch.where(m.valid, m.ray_idx + at, -1), m.ts

        whole = run(slice(0, B), 1)
        rec = dict(batch=B, budget=system._pool_mult,
                   chain=system.step_chain())
        for n in ranks:
            parts = [run(slice(r * B // n, (r + 1) * B // n), n)
                     for r in range(n)]
            if layout == "rounds":
                rec[f"ranks_{n}"] = int((torch.cat(parts) != whole).sum())
            else:
                ri = torch.cat([p[0] for p in parts])
                ts = torch.cat([p[1] for p in parts])
                rec[f"ranks_{n}"] = int(((ri != whole[0])
                                         | (ts != whole[1])).sum())
        if layout == "csr":
            rec["slots"] = B * system._pool_mult
            rec["filled"] = int((whole[0] >= 0).sum())
        else:
            rec["rays_in_loss"] = int(whole.sum())
        out[layout] = rec
        del system
    return out


def rank_run(out: str, name: str, dev: str, per_rank: int, warm: int,
             steps: int, parity_rays: int, tcfg=None) -> None:
    """One rank's share of run `name`; rank 0 writes <out>/<name>.json."""
    from ngp_pl_torch import parallel

    n = parallel.world_size()
    system = _system(dev, per_rank * n, tcfg)
    seen = count_full_pools(system)
    nb = system.tcfg.grid_update_interval
    system.on_train_start()
    for _ in range(max(warm // nb, 1)):
        m = system.step_block()
    float(m["loss"])
    system.freeze_buckets = True
    m = system.step_block()
    float(m["loss"])
    sync(system.dev)
    t0 = time.perf_counter()
    blocks = max(steps // nb, 1)
    for _ in range(blocks):
        m = system.step_block()
    loss = float(m["loss"])             # the fence
    dt = time.perf_counter() - t0
    rec = dict(name=name, ranks=n, per_rank=per_rank, batch=per_rank * n,
               steps=blocks * nb, seconds=dt,
               rays_per_s=per_rank * n * blocks * nb / dt,
               rays_per_s_per_rank=per_rank * blocks * nb / dt,
               loss=loss, skipped=int(m["n_skipped"]),
               layout=system.layout, pool_mult=system._pool_mult,
               chain=system.step_chain(),
               full_pool_steps=full_pool_steps(seen), csr_steps=len(seen),
               allreduce_ms=allreduce_ms(system),
               ranks_equal=ranks_equal(system))
    if parity_rays:
        path = os.path.join(out, f"{name}_state.npz")
        if parallel.rank() == 0:
            system.save(path)
        parallel.barrier()
        steps = {m: explicit_grads(system, parity_rays, pool_mult=m)
                 for m in (None, ROOM_MULT)}
        rec["parity"] = dict(rays=parity_rays, **steps[None][2],
                             room=steps[ROOM_MULT][2])
        if parallel.rank() == 0:
            torch.save(steps, os.path.join(out, f"{name}_grads.pt"))
    if parallel.rank() == 0:
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(rec, f)


def pair_system(dev: str = "cuda"):
    """The flagship on bench.py's scene with two test views (the pair
    check's validate)."""
    from ngp_pl_torch.benchmarking.train_setup import train_config
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    return NeRFSystem(
        train_config(exp_name="ddp", no_save_test=True), device=dev,
        train_dataset=SyntheticDataset(split="train", img_size=96,
                                       n_train=8, device=dev),
        test_dataset=SyntheticDataset(split="test", img_size=96, n_test=2,
                                      device=dev))


def load_state(system, path: str, ctl: dict) -> None:
    """A full checkpoint, and the controller's layout, budget and chain."""
    system.load(path)
    system.layout, system._pool_mult = ctl["layout"], ctl["pool_mult"]
    system.chain_length = ctl["chain"]


def pair_run(out: str, path: str, ctl: dict, n_rays: int, steps: int,
             adapted: tuple, dev: str = "cuda") -> None:
    """A rank of chip_smoke.py's two-rank check on one card: from the
    state in `path` (and `ctl`), one step's loss and gradients on an
    explicit global batch of `n_rays` at the controller's budget and at
    ROOM_MULT (`explicit_grads`), the 2-view validate, then `steps`
    more steps in 16-step blocks, counting those on which a rank's pool
    was full (`count_full_pools`); the counts of the hand kernels'
    launches from 0 at the start; whether the ranks' parameters, moments
    and grids are equal after the steps; then, from the state and
    controller of `adapted` (a later one, past grid warmup), the explicit
    step at the controller's budget.  Rank 0 writes <out>/pair.pt."""
    from ngp_pl_torch import parallel
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    counters = {"K1": he.hash_encode_fwd_cuda, "K7": ft.field_tail_cuda,
                "K2+K5": he.hash_encode_bwd_cuda, "K8": ft.field_tail_bwd_cuda}
    for c in counters.values():
        c.launches = 0
    system = pair_system(dev)
    load_state(system, path, ctl)
    checks = {m: explicit_grads(system, n_rays, pool_mult=m)
              for m in (None, ROOM_MULT)}
    scores = system.validate(save_images=False)
    seen = count_full_pools(system)
    t0 = time.perf_counter()
    for _ in range(steps // system.tcfg.grid_update_interval):
        m = system.step_block()
    finite = bool(torch.isfinite(m["loss"]))
    seconds = time.perf_counter() - t0
    launches = parallel.gather_scalars(torch.tensor(
        [float(c.launches) for c in counters.values()], dtype=torch.float64,
        device=system.dev)).tolist()
    equal = ranks_equal(system)
    full = full_pool_steps(seen)
    load_state(system, *adapted)
    later = explicit_grads(system, n_rays)
    if parallel.rank() == 0:
        torch.save(dict(steps=checks, adapted=later,
                        validate=scores, finite=finite, seconds=seconds,
                        full_pool_steps=full, csr_steps=len(seen),
                        launches=[dict(zip(counters, r)) for r in launches],
                        ranks_equal=equal, device=str(system.dev)),
                   os.path.join(out, "pair.pt"))


def one_rank_reference(out: str, name: str, dev: str, batch: int,
                       parity_rays: int, tcfg=None) -> None:
    """The one-rank step on the state and batch of run `name`'s parity."""
    with open(os.path.join(out, f"{name}.json")) as f:
        ctl = json.load(f)["parity"]
    system = _system(dev, batch, tcfg)
    load_state(system, os.path.join(out, f"{name}_state.npz"), ctl)
    torch.save({m: explicit_grads(system, parity_rays, pool_mult=m)
                for m in (None, ROOM_MULT)},
               os.path.join(out, f"{name}_grads_1.pt"))


def step_errors(got, ref) -> dict:
    """Loss error relative to the reference's, and each gradient's largest
    error over its largest magnitude, of two `explicit_grads` results."""
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got[1], ref[1])]
    return dict(loss_rel_err=abs(got[0] - ref[0]) / abs(ref[0]),
                grad_rel_err=errs, grad_rel_err_max=max(errs),
                loss=got[0], loss_one_rank=ref[0])


def parity(out: str, name: str) -> dict:
    """The N-rank steps against the one-rank ones: at the controller's
    budget, and at ROOM_MULT (`room`)."""
    n = torch.load(os.path.join(out, f"{name}_grads.pt"), weights_only=False)
    one = torch.load(os.path.join(out, f"{name}_grads_1.pt"),
                     weights_only=False)
    return dict(**step_errors(n[None], one[None]),
                room=step_errors(n[ROOM_MULT], one[ROOM_MULT]))


def main(argv=None, tcfg=None) -> dict:
    """The runs, printed and returned; `tcfg` replaces the flagship's
    train configuration (the tests' small model)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--per_rank", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("build", "scaling"))
    args = ap.parse_args(argv)
    if 1 not in args.ranks:
        raise ValueError(f"--ranks {args.ranks}: the efficiency's base is "
                         f"the one-rank run; add 1")
    from ngp_pl_torch import parallel
    from ngp_pl_torch.device import resolve_device

    resolve_device(args.device)
    n_max = max(args.ranks)
    parallel.resolve_world(n_max, args.device)     # raises past the GPUs
    if args.device != "cpu":
        from ngp_pl_torch import _build

        _build.build()
    os.makedirs(args.out, exist_ok=True)
    runs = [(f"weak_{n}", n, args.per_rank, WARM_STEPS, args.steps, 0)
            for n in args.ranks]
    runs += [(f"split_{n_max}", n_max, SPLIT_RAYS // n_max, WARM_STEPS,
              args.steps, 0),
             (f"parity_{n_max}", n_max, args.per_rank, PARITY_STEPS, 16,
              PARITY_RAYS)]
    recs = []
    for name, n, per_rank, warm, steps, prays in runs:
        parallel.launch(rank_run, n, (args.out, name, args.device, per_rank,
                                      warm, steps, prays, tcfg),
                        device=args.device)
        with open(os.path.join(args.out, f"{name}.json")) as f:
            rec = json.load(f)
        if prays:
            parallel.launch(one_rank_reference, 1,
                            (args.out, name, args.device, per_rank * n,
                             prays, tcfg), device=args.device)
            errs = parity(args.out, name)
            rec["parity"]["room"].update(errs.pop("room"))
            rec["parity"].update(errs)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    base = next(r for r in recs if r["name"] == "weak_1")
    for r in recs:
        if r["name"].startswith("weak_"):
            r["efficiency"] = (r["rays_per_s_per_rank"]
                               / base["rays_per_s_per_rank"])
        elif r["name"].startswith("split_"):
            r["vs_one_rank"] = r["rays_per_s"] / base["rays_per_s"]
    dev = (torch.cuda.get_device_name(0) if args.device != "cpu"
           else "cpu")
    out = {"metric": "weak_scaling", "device": dev,
           "card": _card_line() if args.device != "cpu" else None,
           "runs": [{k: r[k] for k in (
               "name", "ranks", "batch", "rays_per_s",
               "rays_per_s_per_rank", "efficiency", "vs_one_rank",
               "allreduce_ms", "ranks_equal", "skipped", "pool_mult",
               "chain", "full_pool_steps", "csr_steps", "parity") if k in r}
               for r in recs]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
