"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with as many GPUs as the cell
asks for.  The process loads, warms, measures (or, with --trace 1,
profiles a short window) and checks what the timed path produced against
the plain reference, then prints one JSON line last on standard output:
correct, attempted, failed, metrics, device (with --trace 1 also
breakdown), and the numbers compared with their limits under "checks".
A cell on several GPUs runs one process per GPU, which this process starts
(rank 0 is itself) and waits for; each takes its own equal, disjoint
share of the cores this process may run on and a small intra-op thread
count.  Without the GPUs, or
when JAX or the JAX package was loaded, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cores", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench import harness, loops, ranks

    cell = harness.Cell(args.workload)
    world = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"the cell needs {world} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    address, children = ranks.start(
        str(Path(__file__).resolve()),
        ["--workload", args.workload, "--seed", str(args.seed),
         "--seconds", str(args.seconds), "--trace", str(args.trace)],
        args.rank, world, int(cell.traffic["threads_per_rank"]), args.cores,
        ROOT)
    args.address = address or args.address
    try:
        dev = torch.device("cuda", args.rank)
        torch.cuda.set_device(dev)
        from perfbench import program
        import ngp_pl_torch.training.system  # noqa: F401
        run = loops.Run(cell, args.seed, args.seconds, bool(args.trace),
                        args.rank, world, dev, T_START)
        run.stamp("imports")
        torch.zeros((), device=dev)
        if world > 1:
            program.init_group(args.rank, world, args.address)
        run.stamp("cuda_init")
        program.build()
        run.stamp("kernels")
        line = loops.main_rank(run)
        if world > 1:
            program.destroy_group()
    except BaseException:
        ranks.kill(children)
        raise
    finally:
        bad = ranks.wait(children)
    if bad:
        print(f"ranks {bad} failed", file=sys.stderr)
        return 1
    found = harness.banned_loaded()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    if line is not None:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
