"""What every traffic generator shares: one process's run (its cell, seed,
rank, card and set-up clock), the ranks' collectives, the traced window
and what the per-layer readers read from it.  A traffic mix's `kind`
names its generator, `perfbench/kinds/<kind>.py`, loaded by path: each
reads its parameters from the traffic file, sets the system up, warms
every shape it will use, measures a window (or, with `--trace 1`, profiles
a short one early in the process), then checks what the timed path
produced against the plain reference.  A new kind of traffic is a new file
there; nothing here changes for it."""
from __future__ import annotations

import gc
import importlib.util
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench import harness, program, scene, trace, weights, yardstick
from perfbench.reference import field as rf

CACHE = harness.ROOT / "build" / "perfbench"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """One process's part of a run: the cell, the arguments, its rank, the
    card, and the set-up clock (seconds since the process started, by
    phase)."""

    def __init__(self, cell, seed: int, seconds: float, traced: bool,
                 rank: int, world: int, dev, t_start: float,
                 faults: Optional[Dict[str, Callable]] = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.rank, self.world, self.dev = (traced, rank, world,
                                                        dev)
        self.t_start = t_start
        self.t_last = t_start
        self.setup: Dict[str, float] = {}
        self.faults = faults or {}
        self.lead = rank == 0

    def stamp(self, phase: str) -> None:
        now = time.perf_counter()
        self.setup[phase] = round(now - self.t_last, 4)
        self.t_last = now

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start

    def views(self):
        """The train views (with their store on the card) and the orbit's
        poses, both at the configuration's size."""
        sc = self.cell.config["scene"]
        size = sc["img_size"]
        poses = scene.train_poses(sc["views"])
        store = scene.cached_views(poses, size, self.dev, CACHE,
                                   "spheres") if self.dev.type == "cuda" \
            else scene.views(poses, size, self.dev)
        dirs = scene.directions(size)
        K = scene.intrinsics(size)
        orbit = self.cell.traffic.get("orbit", {"poses": 8,
                                                "elevation_deg": 30.0})
        test = program.Views(scene.orbit_poses(orbit["poses"],
                                               orbit["elevation_deg"]),
                             dirs, K, size)
        return program.Views(poses, dirs, K, size, store), test

    def system(self, train_views, test_views, seed: Optional[int] = None):
        """The program's system with its weights made from `seed` (the
        run's own where it is None)."""
        seed = self.seed if seed is None else seed
        tcfg = program.train_config(self.cell.config, self.world, seed)
        sysm = program.system(tcfg, train_views, test_views, self.dev)
        self.stamp("system")
        params0 = weights.make(self.cell.config["model"], seed, self.dev)
        program.load_params(sysm, params0)
        self.stamp("weights")
        return sysm, params0

    def release(self) -> None:
        """Frees what the program's state held on the card, once the
        caller has dropped it."""
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.dev)) \
            if self.dev.type == "cuda" else 0

    def device(self, peak: int, busy_s=None, window_s=None) -> Dict:
        d = {"platform": "gpu" if self.dev.type == "cuda" else "cpu",
             "kind": (torch.cuda.get_device_name(self.dev)
                      if self.dev.type == "cuda" else "cpu"),
             "count": self.world, "memory_peak_bytes": peak}
        if busy_s is not None:
            d["busy_s"], d["window_s"] = busy_s, window_s
        return d


def gather(values: List[float], run: Run) -> List[List[float]]:
    """Every rank's `values` (a process group collective), rank by rank."""
    if run.world == 1:
        return [values]
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64, device=run.dev)
    out = [torch.empty_like(t) for _ in range(run.world)]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def barrier(run: Run) -> None:
    if run.world > 1:
        import torch.distributed as dist
        dist.barrier()


def traced(run: Run, body: Callable[[], None]) -> Dict:
    """`body` under the profiler with the hand kernels' inputs recorded;
    the profile's hand-kernel launches are held against the wrappers' own
    counters."""
    inputs: List = []
    before = program.launches()
    with program.kernel_inputs(inputs):
        prof, window_s = trace.profile(body)
    counted = program.launches() - before
    tr = trace.read(prof)
    seen = len([op for op in trace.ops_matching(tr["device_ops"],
                                                program.HAND_KERNELS)
                if "field_tail_bwd_reduce" not in op[0]])
    tr.update(window_s=window_s, inputs=inputs, counted=counted, seen=seen)
    return tr


def _bound_s(inputs: List, model: Dict) -> float:
    """The summed roofline bound of the recorded hand-kernel launches."""
    g = rf.grid(model)
    shapes = [s for v in rf.mlp_shapes(model).values() for s in v][1:]
    total = 0.0
    for kind, x, table_bytes, feats in inputs:
        if kind == "encode_fwd":
            total += yardstick.encode_fwd_bound(
                x.shape[0], yardstick.table_points(x, g), g, table_bytes,
                feats)
        elif kind == "encode_bwd":
            total += yardstick.encode_bwd_bound(
                x.shape[0], yardstick.table_points(x, g), g)
        elif kind == "tail_fwd":
            total += yardstick.tail_fwd_bound(x, shapes)
        else:
            total += yardstick.tail_bwd_bound(x, shapes)
    return total


def trace_ctx(run: Run, tr: Dict, units: int, samples: float,
               train: bool) -> Dict:
    """What the per-layer readers read from a traced window of `units`
    steps or frames."""
    busy = [tr["busy_us"] * 1e-6, tr["window_s"]]
    every = gather(busy, run)
    return {
        "units": units, "window_s": tr["window_s"],
        "busy_s": sum(b for b, _ in every) / len(every),
        "chips": run.world, "device_ops": tr["device_ops"],
        "launches": tr["launches"], "hand": program.HAND_KERNELS,
        "comm": ("nccl",), "bound_s": _bound_s(tr["inputs"],
                                               run.cell.config["model"]),
        "samples": samples, "rays": units * run.cell.config["recipe"][
            "batch_size"] * run.world if train else None,
        "flops": samples * yardstick.sample_flops(run.cell.config["model"],
                                                  train),
        "rounds": tr.get("rounds"), "pixels": tr.get("pixels")}


def kind(name: str, root=harness.ROOT):
    """The generator module of traffic kind `name`."""
    path = root / "perfbench" / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_kind_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main_rank(run: Run) -> Optional[str]:
    """The cell's run on this rank: rank 0's result line, None on the
    others."""
    return kind(run.cell.traffic["kind"], run.cell.root).measure(run)
