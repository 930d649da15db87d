"""The readings that set a cell's correctness limits, for many seeds in one
process: the program's numbers against the reference (the lower reading),
the control's (the reference in the next precision below the one the
configuration states, in the program's place; the upper reading), and the
program with each fault its kind can have planted (`faults` of
`perfbench/kinds/<kind>.py`): a step leaving the state unchanged, a loss
taking the mean over half of the batch, and on several GPUs the ranks'
gradient exchange left out.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 ... \
        [--faults [name ...]]

One JSON line per seed on standard output.  The benchmark's own runs do
not run this; `perfbench/tests/test_perfbench_control.py` runs it at a
size a CPU holds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def state_unchanged(sysm):
    """The optimizer's step returns without touching its state."""
    import torch

    real = sysm.optimizer.step
    sysm.optimizer.step = lambda grads, finite=None: torch.ones(
        (), dtype=torch.bool, device=sysm.dev)
    try:
        yield
    finally:
        sysm.optimizer.step = real


@contextlib.contextmanager
def half_batch(sysm):
    """The loss is the mean over the first half of the batch's rays."""
    from ngp_pl_torch.training import train_step as ts

    real = ts.nerf_loss

    def loss(results, target, **kw):
        d = real(results, target, **kw)
        n = target.shape[0] // 2
        return {k: v[:n] for k, v in d.items()}

    ts.nerf_loss = loss
    try:
        yield
    finally:
        ts.nerf_loss = real


@contextlib.contextmanager
def no_exchange(sysm):
    """Each rank steps on its own shard's gradient: the all-reduce left
    out."""
    from ngp_pl_torch import parallel

    real = parallel.grad_mean
    parallel.grad_mean = lambda grads: list(grads)
    try:
        yield
    finally:
        parallel.grad_mean = real


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
FAULTS_ACROSS = dict(FAULTS, no_exchange=no_exchange)


def readings(cell, seeds, dev, log=print, rank: int = 0, world: int = 1,
             only=None) -> list:
    """Each seed's readings (rank 0's list; empty on the other ranks), with
    the faults the cell's kind can have planted (those named in `only`,
    where it is given)."""
    from perfbench import loops
    from perfbench.reference import field as rf

    kind = loops.kind(cell.traffic["kind"], cell.root)
    planted = {n: FAULTS_ACROSS[n] for n in kind.faults(world)
               if only is None or n in only}
    quant = rf.lower_precision(cell.config["precision"]["control"])
    run = loops.Run(cell, seeds[0], 0.0, False, rank, world, dev,
                    time.perf_counter())
    views, test = run.views()
    out = []
    for seed in seeds:
        run = loops.Run(cell, seed, 0.0, False, rank, world, dev,
                        time.perf_counter())
        got = kind.seed_readings(run, views, test, quant, planted)
        if got is None:
            continue
        rec = dict(seed=seed, **got)
        rec["seconds"] = round(time.perf_counter() - run.t_start, 2)
        log(json.dumps(rec))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="plant only these faults (none with no names)")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cores", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness, program, ranks

    cell = harness.Cell(args.workload)
    world = cell.chips
    rest = ["--workload", args.workload, "--seeds", *map(str, args.seeds)]
    if args.faults is not None:
        rest += ["--faults", *args.faults]
    address, children = ranks.start(
        str(Path(__file__).resolve()), rest, args.rank, world,
        int(cell.traffic["threads_per_rank"]), args.cores, ROOT)
    args.address = address or args.address
    try:
        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        if world > 1:
            program.init_group(args.rank, world, args.address)
        program.build()
        readings(cell, args.seeds, dev, lambda s: print(s, flush=True),
                 args.rank, world, args.faults)
        if world > 1:
            program.destroy_group()
    except BaseException:
        ranks.kill(children)
        raise
    finally:
        bad = ranks.wait(children)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
