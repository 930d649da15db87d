"""A data-parallel training cell (`train_recipe_b16384_ddp4`, added to a
copy of the checkout as a later PR would add it: a `workloads` entry and a
limit file) run on two gloo ranks on the CPU, at a small size: sound, rank
0's line is correct; with the ranks' gradient exchange left out (each rank
steps on its own shard's gradient), `correct` comes out false.  And the
ranks' cores: rank 0 hands each rank its own disjoint slice."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
import torch.multiprocessing as mp

from perfbench import harness

WORLD = 2
CELL = "train-l16f2-synthetic-ddp4"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with the four-GPU cell added, its limits
    those of the one-GPU train cell."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "ngp-l16f2-synthetic",
                              "traffic": "train_recipe_b16384_ddp4",
                              "chips": 4, "why": "four ranks"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "perfbench" / "limits" / "train-l16f2-synthetic.json",
                root / "perfbench" / "limits" / f"{CELL}.json")
    return root


def rank_body(rank: int, store: str, out: str, fault: bool,
              root: str) -> None:
    from pathlib import Path

    from ngp_pl_torch import parallel
    from perfbench import control, loops
    from perfbench.tests.test_perfbench_faults import SEED, tiny

    torch.set_num_threads(1)
    parallel.init_distributed(rank, WORLD, "file://" + store, device="cpu")
    try:
        cell = tiny(CELL, Path(root))
        r = loops.Run(cell, SEED, 0.3, False, rank, WORLD,
                      torch.device("cpu"), time.perf_counter(),
                      faults={"step": control.no_exchange} if fault
                      else None)
        line = loops.main_rank(r)
        if rank == 0:
            with open(out, "w") as f:
                f.write(line)
    finally:
        parallel.destroy()


def _line(tmp_path, root, fault: bool) -> dict:
    out = str(tmp_path / f"line{int(fault)}.json")
    mp.start_processes(rank_body, args=(str(tmp_path / f"store{int(fault)}"),
                                        out, fault, str(root)),
                       nprocs=WORLD, join=True, start_method="spawn")
    assert os.path.exists(out)
    line = json.loads(open(out).read())
    assert line["device"]["count"] == WORLD
    return line


def test_ddp_cell_on_gloo_ranks(tmp_path, checkout):
    """At this size the sound run's statistical numbers are noisier than
    the cell's (whose limits are set at 16,384 rays a rank), so the sound
    run is held to its exact checks, and the fault to reading far above
    it where it moves the numbers and to `correct` false."""
    sound = {k: c["value"]
             for k, c in _line(tmp_path, checkout, False)["checks"]
             .items()}
    assert sound["grid_invisible_miss"] == sound["grid_occupied_miss"] == 0
    assert sound["nonfinite_steps"] == 0
    broken = _line(tmp_path, checkout, True)
    assert not broken["correct"], broken["checks"]
    for k in ("grad_norm_gap", "grad_diff"):
        assert broken["checks"][k]["value"] >= 3.0 * sound[k]


RANK_SCRIPT = """
import argparse, json, os, sys
sys.path.insert(0, %r)
from perfbench import ranks
ap = argparse.ArgumentParser()
for a in ("--out", "--address", "--cores"):
    ap.add_argument(a)
ap.add_argument("--rank", type=int, default=0)
args = ap.parse_args()
_, children = ranks.start(__file__, ["--out", args.out], args.rank, 2, 1,
                          args.cores, os.getcwd())
with open(f"{args.out}.{args.rank}", "w") as f:
    json.dump(sorted(os.sched_getaffinity(0)), f)
sys.exit(1 if ranks.wait(children) else 0)
"""


def test_each_rank_gets_its_own_cores(tmp_path):
    """Two ranks started as a run starts them: their core sets are
    disjoint, equal and together the cores the first process was given."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        pytest.skip("needs two cores")
    script = tmp_path / "ranks_probe.py"
    script.write_text(RANK_SCRIPT % str(harness.ROOT))
    out = str(tmp_path / "aff")
    subprocess.run([sys.executable, str(script), "--out", out],
                   cwd=tmp_path, check=True, timeout=300)
    got = [set(json.loads(open(f"{out}.{r}").read())) for r in range(2)]
    assert not got[0] & got[1]
    assert len(got[0]) == len(got[1]) == len(cores) // 2
    assert got[0] | got[1] == set(cores[:2 * (len(cores) // 2)])
