"""Data parallelism over processes, one per GPU (counterpart of
ngp_pl_tpu/parallel/mesh.py; reference train.py:271-272, Lightning DDP).

The JAX package shards each ray batch over a one-axis mesh and replicates
the parameters and the occupancy grid; GSPMD then inserts the gradient
all-reduce.  Here each rank is a process with its own card and the same
program:
- every rank draws the *global* batch from identically seeded generators
  and keeps its rows (`shard`, the counterpart of `shard_batch`), so the
  generators stay in step and the grid refresh draws the same cells;
- rank 0's state is broadcast once (`broadcast_`, the counterpart of
  `replicate`), after which every rank applies the same update;
- the gradients are averaged in one all-reduce (`grad_mean`), and the
  step's metrics are those of the global batch (`reduce_scalars`,
  `gather_counts`); a partial sum that the step rounds (the bf16 weight
  gradients of the PyTorch tail) is reduced before its rounding
  (`mean_partial`).

World size 1 with no process group is the one-process path: every helper
is then the identity.  A process group of any size, world size 1 too,
runs the collectives.  CUDA ranks use NCCL, CPU ranks gloo (which also
takes CUDA tensors: ranks that share one card, where NCCL refuses).

`launch` spawns the ranks of one host (`torch.multiprocessing`, spawn),
each of which sets its card before anything else and meets the others
through a file store in a temporary directory; `init_from_env` joins a
group started by an outside launcher (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`, as `python -m torch.distributed.run` sets
them), the counterpart of `init_distributed`.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def active() -> bool:
    """True inside a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def resolve_world(num_devices: int, device: str) -> int:
    """The number of ranks for `num_devices` (TrainConfig.num_devices): 0
    means every visible GPU, as the JAX package's `jax.device_count()`; a
    count above the visible GPUs raises.  On the CPU, 0 means one rank and
    any other count is taken as given (gloo ranks)."""
    if num_devices < 0:
        raise ValueError(f"num_devices must be >= 0, got {num_devices}")
    if torch.device(device).type == "cpu":
        return max(num_devices, 1)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "gloo ranks on the CPU")
    if num_devices > visible:
        raise ValueError(f"num_devices={num_devices}, but {visible} GPU(s) "
                         f"are visible")
    return num_devices or visible


def init_distributed(rank: int, world: int, init_method: str,
                     device: str = "cuda", local_rank: int = None,
                     backend: str = None) -> None:
    """Join the group of `world` ranks as `rank`: a CUDA rank first sets
    its card (the index in `device`, else `local_rank`, by default `rank`)
    and uses NCCL, a CPU rank gloo; `backend` overrides (gloo ranks sharing
    one card, which NCCL refuses).  `init_method` is a `file://` or
    `tcp://` address."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else rank if local_rank is None else local_rank)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)


def init_from_env(device: str = "cuda") -> int:
    """Join a group from the launcher's environment variables; returns
    this process's rank."""
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs {', '.join(ENV_KEYS)} in the "
                           f"environment; missing {', '.join(missing)}")
    r = int(os.environ["RANK"])
    init_distributed(
        r, int(os.environ["WORLD_SIZE"]),
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        device, local_rank=int(os.environ["LOCAL_RANK"]))
    return r


def _worker(r: int, world: int, init_method: str, device: str,
            backend: str, fn: Callable, args: tuple) -> None:
    if torch.device(device).type == "cpu":   # OMP_NUM_THREADS, else shared
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS") or 0)
                              or max(1, (os.cpu_count() or 1) // world))
    init_distributed(r, world, init_method, device, backend=backend)
    try:
        fn(*args)
        barrier()
    finally:
        destroy()


def launch(fn: Callable, world: int, args: tuple = (), device: str = "cuda",
           store_dir: str = None, backend: str = None) -> None:
    """Run `fn(*args)` in `world` spawned ranks of this host and wait for
    all of them; a rank that fails fails the call.  `fn` must be importable
    by name (spawned processes import it afresh).  `device` and `backend`
    are `init_distributed`'s: "cuda" gives rank r card r.  The ranks meet
    through a file store in `store_dir`, a fresh temporary directory by
    default."""
    import torch.multiprocessing as mp

    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="ngp_dist_") if own else store_dir
    try:
        init = "file://" + os.path.join(os.path.abspath(store_dir), "store")
        mp.start_processes(_worker,
                           args=(world, init, device, backend, fn, args),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)


# -- collectives: the identity without a process group ----------------------

def shard(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows [r B/n, (r+1) B/n) of a global batch (B, ...)."""
    n = world_size()
    if n == 1:
        return t
    b = t.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} ranks")
    r = rank()
    return t[r * b // n:(r + 1) * b // n]


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place."""
    if not active():
        return
    with torch.no_grad():
        for t in tensors:
            if t is not None:
                dist.broadcast(t, src)


def grad_mean(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of every rank's gradients, in one all-reduce of a flat
    buffer on the current stream (no host sync under NCCL)."""
    grads = list(grads)
    if not active():
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world_size())
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return out


def mean_partial(t: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of a partial gradient that is rounded after it is
    summed (a bf16 weight gradient of `mlp_apply`): rounding the global
    sum, as the one-rank step does, and not each rank's part.  The later
    `grad_mean` of equal values then leaves it as it is."""
    if not active():
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t)
    return t.div_(world_size())


def sum_floats(values: Sequence[float]) -> List[float]:
    """The sums over ranks of host numbers, in float64 (on the card under
    NCCL, on the host under gloo)."""
    if not active():
        return list(values)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return t.tolist()


def gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in rank order: for a
    batch's shards, the global batch's."""
    if not active():
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim)


def gather_scalars(v: torch.Tensor) -> torch.Tensor:
    """(world, k): every rank's vector of k scalars."""
    return gather_rows(v.reshape(1, -1))


def gather_counts(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`gather_rows` of integer vectors of one length, in one all-gather:
    for a batch's per-ray counts, the global batch's, each in its dtype."""
    ts = list(ts)
    if not active():
        return ts
    rows = gather_rows(torch.stack([t.to(torch.int64) for t in ts]), dim=1)
    return [r.to(t.dtype) for r, t in zip(rows, ts)]


def reduce_scalars(sums: Dict[str, torch.Tensor],
                   means: Dict[str, torch.Tensor],
                   maxes: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch's scalar metrics from each rank's shard: `sums`
    summed, `means` (each over an equal share of the batch) averaged,
    `maxes` maximised over the ranks, in one all-gather of float64; each
    comes back in its own dtype.  Without a process group, the values as
    given."""
    if not active():
        return {**sums, **means, **maxes}
    given = {**sums, **means, **maxes}
    s = gather_scalars(torch.stack(
        [v.to(torch.float64).reshape(()) for v in given.values()]))
    a, b = len(sums), len(sums) + len(means)
    red = torch.cat([s[:, :a].sum(dim=0), s[:, a:b].mean(dim=0),
                     s[:, b:].amax(dim=0)])
    return {k: red[i].to(v.dtype) for i, (k, v) in enumerate(given.items())}


def barrier() -> None:
    if active():
        dist.barrier()


def destroy() -> None:
    """Leave the process group."""
    dist.destroy_process_group()
