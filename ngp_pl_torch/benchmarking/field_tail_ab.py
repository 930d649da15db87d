"""K7 and K8 of two trees of this repository, timed in turns on one card.

    mkdir -p build/parent
    git archive <commit> ngp_pl_torch | tar -x -C build/parent
    python -m ngp_pl_torch.benchmarking.field_tail_ab build/parent .

Each tree runs its own wrappers, `field_tail_cuda` and `field_tail_bwd_cuda`
of its `ngp_pl_torch/ops/field_tail.py`, in a process of its own with the
tree first on sys.path; its kernels build into its own build/kernels/.
The turns are first, second, second, first.  In each, K7 at 1,048,576 and
393,216 samples and K8 at 262,144 and 393,216 run on chip_smoke.py's
inputs (`field_tail_gates.tail_inputs`, the seeded flagship weights) and
are timed on two clocks: the median of 20 CUDA-event-timed calls after 3
warm-ups (the wrapper's host work included), and the device time of every
kernel, copy and fill a call puts on the card, under torch.profiler (mean
of 20 calls).  Each turn also reads its outputs' error against its own
tree's f32 plain version.  One JSON line per kernel and size: both trees'
times, `speedup` (the first tree's time over the second's) and the bound.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SIZES = {"K7": (1048576, 393216), "K8": (262144, 393216)}


def turn() -> dict:
    """One tree's times and errors, in a process whose sys.path starts with
    that tree (PYTHONPATH) after this file's own directory."""
    import torch
    from field_tail_gates import (K7_INPUTS, K8_INPUTS, k7_error, k8_error,
                                  model_weights, tail_inputs)
    from timing import device_ms, time_ms

    from ngp_pl_torch.ops import field_tail as ft

    ws = [w.cuda() for w in model_weights()]
    out = {}
    for key, sizes in SIZES.items():
        for P in sizes:
            if key == "K7":
                inputs = tail_inputs(P, *K7_INPUTS)
                plain, kernel, err = (ft.field_tail_plain, ft.field_tail_cuda,
                                      k7_error)
            else:
                inputs = tail_inputs(P, *K8_INPUTS, grads=True)
                plain, kernel, err = (ft.field_tail_bwd_plain,
                                      ft.field_tail_bwd_cuda, k8_error)
            args = (*(t.cuda() for t in inputs), *ws)
            error = err(kernel(*args), plain(*args))
            call = lambda: kernel(*args)
            out[f"{key}/{P}"] = dict(ms=time_ms(call), device_ms=device_ms(call),
                                     err_vs_f32_plain=error)
            del args
            torch.cuda.empty_cache()
    return out


def run(first: Path, second: Path, emit=print) -> list:
    from ngp_pl_torch.benchmarking.roofline import bound

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    trees = (first.resolve(), second.resolve())
    turns = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn"], cwd=tree, env=env, text=True,
                              capture_output=True)
        if proc.returncode:
            raise RuntimeError(f"the turn of {tree} failed:\n{proc.stderr}")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    # bytes and multiply-adds as chip_smoke.py counts them (weights 7,360)
    n_w = 16 * 64 + 32 * 64 + 64 * 64 + 64 * 3
    records = []
    for key, sizes in SIZES.items():
        for P in sizes:
            t = [r[f"{key}/{P}"] for r in turns]
            if key == "K7":
                nbytes, macs = P * (64 * 4 + 16 * 4 + 16) + 4 * n_w, n_w
            else:
                nbytes = P * (64 + 16 + 1 + 3 + 64) * 4 + 8 * n_w
                macs = 2 * n_w + 192 + 4096 + 2048
            bound_ms, bound_by = bound(nbytes, 2.0 * P * macs, 0.0)
            rec = dict(kernel=key, n=P, card=card, first=str(trees[0]),
                       second=str(trees[1]),
                       **{f"{which}{clock}": [t[i][clock] for i in idx]
                          for which, idx in (("first_", (0, 3)),
                                             ("second_", (1, 2)))
                          for clock in ("ms", "device_ms")},
                       speedup=((t[0]["ms"] + t[3]["ms"])
                                / (t[1]["ms"] + t[2]["ms"])),
                       device_speedup=((t[0]["device_ms"] + t[3]["device_ms"])
                                       / (t[1]["device_ms"]
                                          + t[2]["device_ms"])),
                       err_vs_f32_plain=[r["err_vs_f32_plain"] for r in t],
                       bound_ms=bound_ms, bound_by=bound_by)
            records.append(rec)
            emit(json.dumps(rec))
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first", type=Path, nargs="?",
                    help="root of the tree timed first and last")
    ap.add_argument("second", type=Path, nargs="?",
                    help="root of the tree timed in the middle turns")
    ap.add_argument("--turn", action="store_true",
                    help="time the tree on sys.path (internal)")
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn()), flush=True)
        return []
    if args.first is None or args.second is None:
        ap.error("give the roots of two trees")
    return run(args.first, args.second)


if __name__ == "__main__":
    main()
