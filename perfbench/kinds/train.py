"""A closed loop of training steps (`kind: "train"`, on one rank or
several).  Set-up builds the system from the seed and takes its first
block, whose first steps and grid refresh the reference follows; then the
warm-up blocks, the buckets frozen, and whole blocks measured fence to
fence (or, with `--trace 1`, a short traced window).  `seed_readings` is
what `perfbench/control.py` reads to set the limits."""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import harness, loops, program, trace, yardstick
from perfbench.reference import field as rf

REF_STEPS = 3


def faults(world: int):
    """The faults `perfbench/control.py` plants in this kind's timed path."""
    named = ("state_unchanged", "half_batch")
    return named + ("no_exchange",) if world > 1 else named


def first_block(run, views, test, fault=None):
    """The system built from the seed and its first block taken, with
    `fault` planted in it: (system, the benchmark's weights, the first
    REF_STEPS steps' records, the block's metrics)."""
    sysm, params0 = run.system(views, test)
    first: List[Dict] = []
    sysm.on_train_start()
    with program.first_steps(sysm, REF_STEPS, first):
        with (fault(sysm) if fault else contextlib.nullcontext()):
            m = sysm.step_block()
    return sysm, params0, first, m


def measure(run) -> Optional[str]:
    """The training cell: returns the result line on rank 0, None on the
    other ranks."""
    cell, tr_cfg = run.cell, run.cell.traffic
    views, test = run.views()
    run.stamp("scene")
    sysm, params0, first, m = first_block(run, views, test,
                                          run.faults.get("step"))
    for _ in range(tr_cfg["warm_blocks"] - 1):
        m = sysm.step_block()
    program.fence(m)
    sysm.freeze_buckets = True
    t = time.perf_counter()
    for _ in range(tr_cfg["rate_blocks"]):
        m = sysm.step_block()
    program.fence(m)
    block_s = (time.perf_counter() - t) / tr_cfg["rate_blocks"]
    every = loops.gather([float(max(1, math.ceil(run.seconds / block_s))),
                          block_s], run)
    n_blocks = int(every[0][0])           # rank 0's count on every rank
    run.stamp("warm")
    nb = sysm.tcfg.grid_update_interval
    rays_per_step = sysm.tcfg.batch_size
    loops.barrier(run)
    program.fence(m)
    setup_s = run.since_start()
    line_metrics: Dict = {}
    breakdown = busy_s = window_s = None
    skipped = torch.zeros((), dtype=torch.int32, device=run.dev)
    if run.traced:
        steps: List[Dict] = []

        def body():
            with program.step_metrics(sysm, steps):
                for _ in range(tr_cfg["trace_blocks"]):
                    sysm.step_block()
        tr = loops.traced(run, body)
        if tr["seen"] != tr["counted"]:
            loops.log(f"profile holds {tr['seen']} hand-kernel launches, the"
                      f" wrappers counted {tr['counted']}: profiling one "
                      f"block")
            steps.clear()
            tr_cfg = dict(tr_cfg, trace_blocks=1)
            tr = loops.traced(run, body)
        units = tr_cfg["trace_blocks"] * nb
        samples = float(sum(float(s["rm_samples"]) for s in steps))
        ctx = loops.trace_ctx(run, tr, units, samples, train=True)
        attempted = units
        line_metrics = harness.read_per_layer(cell, ctx)
        breakdown = trace.breakdown(tr)
        busy_s, window_s = ctx["busy_s"], ctx["window_s"]
    else:
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            m = sysm.step_block()
            skipped = skipped + m["n_skipped"]
        loops.barrier(run)
        program.fence(m)
        window = time.perf_counter() - t0
        attempted = n_blocks * nb
        rate = yardstick.rate(attempted * rays_per_step, window)
        name = "ddp_train_rays_per_s" if run.world > 1 else \
            "train_rays_per_s"
        line_metrics = {name: {"value": rate, "unit": "rays/s"},
                        "setup_s": {"value": setup_s, "unit": "s"}}
        line_metrics = {k: v for k, v in line_metrics.items()
                        if k in {m["name"] for m in cell.end_to_end()}}
    failed = int(skipped)
    peak = max(p for (p,) in loops.gather([float(run.peak())], run))
    loops.log(f"setup {run.setup} setup_s {setup_s:.3f} blocks {n_blocks} "
              f"layout {sysm.layout} x{sysm._pool_mult} chain "
              f"{sysm.chain_length} rate-block s by rank "
              f"{[round(b, 4) for _, b in every]}")
    # the reference: the first steps' inputs from every rank, then the
    # program's state freed
    caps = gather_first(first, run)
    refresh = first[0] if first else None
    del sysm, m, first
    run.release()
    if not run.lead:
        return None
    got = readings(caps, params0, views, cell.config, refresh, run.dev)
    checks = harness.compare(got, cell.limits)
    ok = harness.passed(checks) and not harness.banned_loaded()
    harness.print_checks(checks)
    return harness.result_line(ok, attempted, failed, line_metrics,
                               run.device(int(peak), busy_s, window_s),
                               checks, breakdown)


def gather_first(first: List[Dict], run) -> List[Dict]:
    """The first steps' records with every rank's batch indices and noise
    (`shards`, rank by rank) and its rays' colours (`rgb`, rank after
    rank)."""
    out = []
    for rec in first:
        mine = (rec["img"], rec["pix"], rec["noise"], rec["rgb"])
        if run.world > 1:
            import torch.distributed as dist
            parts = [[torch.empty_like(t) for _ in range(run.world)]
                     for t in mine]
            for p, t in zip(parts, mine):
                dist.all_gather(p, t)
            every = list(zip(*parts))
        else:
            every = [mine]
        out.append(dict(rec, shards=[s[:3] for s in every],
                        rgb=torch.cat([s[3] for s in every])))
    return out


def reference(caps: List[Dict], params0: Dict, views, config: Dict, dev,
              quant=None) -> Dict:
    """The reference's first steps on the batches, noise, grids and budgets
    the program's first steps took (`caps`, every rank's shards)."""
    from perfbench.reference import train as rt

    if any(c["layout"] != "csr" for c in caps):
        raise RuntimeError("the first steps ran another layout than CSR: "
                           "the reference follows the CSR pool only")
    poses = torch.from_numpy(views.poses).to(dev)
    dirs = torch.from_numpy(views.directions).to(dev)
    steps = []
    for c in caps:
        shards = []
        for img, pix, noise in c["shards"]:
            o, d = rt.rays(dirs, poses, img, pix)
            shards.append({"rays_o": o, "rays_d": d,
                           "target": views.rays[img, pix],
                           "noise": noise, "occ_grid": c["occ_grid"],
                           "chain": c["chain"], "pool_mult": c["pool_mult"]})
        steps.append(shards)
    return rt.follow(params0, steps, config["model"], config["recipe"],
                     quant)


def program_side(caps: List[Dict]) -> Dict:
    """The program's first steps as the gaps read them: each step's loss,
    the first gradient as the optimizer got it (its first moments after
    one step over 1 - b1) and the leaves after the last step."""
    from perfbench.reference import train as rt

    return {"losses": [float(c["loss"]) for c in caps],
            "rgb": caps[0]["rgb"],
            "grads": [m / (1.0 - rt.ADAM_B1) for m in caps[0]["mu"]],
            "leaves": caps[-1]["leaves"]}


def reference_side(ref: Dict) -> Dict:
    """A reference run (the control, in lower precision) as `program_side`
    gives the program's."""
    names = list(ref["first_grad"])
    return {"losses": ref["losses"], "rgb": ref["rgb"],
            "grads": [ref["first_grad"][n] for n in names],
            "leaves": [ref["leaves"][n] for n in names]}


def gaps(side: Dict, ref: Dict, params0: Dict) -> Dict[str, float]:
    """The numbers the train cells compare: the largest relative gap of a
    first step's loss; the first gradient's norm and the parameters'
    change after the last step, each leaf's gap of norms over the larger
    of that leaf's reference norm and the median leaf's, the worst leaf;
    the change over the leaves whose reference gradient is at least a
    thousandth of the median leaf's.  And two that the control, in a lower
    precision, moves where the norms above average its rounding out: the
    first step's rays' colours, their mean absolute difference, and the
    first gradient's difference, the worst leaf's norm of it over the
    larger of that leaf's reference norm and the median leaf's."""
    names = [n for n, _ in rf.leaves(params0)]
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(side["losses"], ref["losses"]))
    g_ref = [float(ref["first_grad"][n].norm()) for n in names]
    grad_gap = _leaf_gap([float(g.norm()) for g in side["grads"]], g_ref)
    grad_diff = _leaf_gap([float((g - ref["first_grad"][n]).norm())
                           for g, n in zip(side["grads"], names)],
                          g_ref, 0.0)
    p0 = [p for _, p in rf.leaves(params0)]
    d_side = [float((a - b).norm()) for a, b in zip(side["leaves"], p0)]
    d_ref = [float((ref["leaves"][n] - b).norm()) for n, b in zip(names, p0)]
    counted = [i for i, v in enumerate(g_ref)
               if v >= 1e-3 * float(np.median(g_ref))]
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": _leaf_gap([d_side[i] for i in counted],
                                         [d_ref[i] for i in counted]),
            "rgb_gap": float((side["rgb"] - ref["rgb"]).abs().mean()),
            "grad_diff": grad_diff}


def grid_checks(refresh: Dict, params0: Dict, views, model: Dict,
                dev) -> Dict[str, float]:
    """The first block's grid refresh against the reference: the share of
    cells whose invisibility differs from the cameras'; of the positions
    the refresh sampled, the share outside the cell each stands for; the
    refreshed densities' gap from the reference field's at those positions
    from the benchmark's weights (`grid_density_gap`); and the share of
    cells whose occupancy differs from their refreshed density against
    min(mean, threshold)."""
    from perfbench.reference import grid as rg

    grid_state, pos = refresh["grid"], refresh["grid_pos"]
    inv = rg.invisible(views.K, views.poses, views.img_wh[0],
                       views.img_wh[1], model["grid_size"], model["scale"],
                       dev)
    dens = grid_state.density_grid.reshape(-1)
    occ = rg.occupied(dens, float(grid_state.mean_density))
    sigma = rg.density(params0, pos, model)
    return {"grid_invisible_miss": float(((dens < 0) != inv).float().mean()),
            "grid_cell_miss": rg.outside_cells(pos, model["grid_size"],
                                               model["scale"]),
            "grid_density_gap": rg.density_gap(dens, sigma, inv),
            "grid_occupied_miss": float(
                (occ != (grid_state.occ_grid.reshape(-1) > 0)).float()
                .mean())}


def readings(caps: List[Dict], params0: Dict, views, config: Dict,
             refresh: Dict, dev) -> Dict[str, float]:
    """The program's first steps and first refresh against the
    reference."""
    ref = reference(caps, params0, views, config, dev)
    out = gaps(program_side(caps), ref, params0)
    out.update(grid_checks(refresh, params0, views, config["model"], dev))
    out["nonfinite_steps"] = float(sum(not bool(c["finite"]) for c in caps))
    return out


def _leaf_gap(prog: List[float], ref: List[float],
              target: Optional[float] = None) -> float:
    """The worst leaf's |prog - ref|, or |prog - target| where a target is
    given, over the larger of that leaf's reference and the median leaf's."""
    med = float(np.median(ref))
    return max(abs(p - (r if target is None else target)) / max(r, med)
               for p, r in zip(prog, ref))


def seed_readings(run, views, test, quant, planted: Dict) -> Optional[Dict]:
    """One seed: the first steps, sound and with each fault in `planted`
    (name -> context), against the reference; the control (the reference
    with `quant`) against the reference.  Every rank takes the steps; rank
    0 alone reads them (None on the others)."""
    from perfbench.reference import grid as rg

    def first(fault=None):
        sysm, params0, caps, m = first_block(run, views, test, fault)
        program.fence(m)
        del sysm
        return gather_first(caps, run), params0, caps[0]

    caps, params0, refresh = first()
    fcaps = {name: first(fault)[0] for name, fault in planted.items()}
    if not run.lead:
        return None
    cfg = run.cell.config
    ref = reference(caps, params0, views, cfg, run.dev)
    out = {"program": gaps(program_side(caps), ref, params0)}
    out["program"].update(grid_checks(refresh, params0, views, cfg["model"],
                                      run.dev))
    out["program"]["nonfinite_steps"] = float(
        sum(not bool(c["finite"]) for c in caps))
    refq = reference(caps, params0, views, cfg, run.dev, quant)
    out["control"] = gaps(reference_side(refq), ref, params0)
    pos, inv = refresh["grid_pos"], refresh["grid"].density_grid < 0
    out["control"]["grid_density_gap"] = rg.density_gap(
        rg.density(params0, pos, cfg["model"], quant),
        rg.density(params0, pos, cfg["model"]), inv.reshape(-1))
    for name, got in fcaps.items():
        out[name] = gaps(program_side(got), ref, params0)
    return out
