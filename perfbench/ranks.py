"""One process a GPU: rank 0 is the process that was started, which starts
the others (the same script with `--address tcp://localhost:p --cores
c,c,... --rank r`) and waits for them.  Rank 0 splits the cores it may
run on into one disjoint, equal slice a rank before it pins itself, and
hands each other rank its slice; each process takes its slice and a small
intra-op thread count."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

CHILD_WAIT_S = 120      # after rank 0 is done, for the other ranks to end


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def slices(world: int) -> List[List[int]]:
    """This process's cores split into `world` disjoint, equal slices (the
    remainder left out; every rank shares all of them where there are
    fewer cores than ranks)."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // world
    if per == 0:
        return [cores] * world
    return [cores[r * per:(r + 1) * per] for r in range(world)]


def pin(cores: Sequence[int], threads: int) -> None:
    """This process on `cores`, with `threads` intra-op threads."""
    import torch

    os.sched_setaffinity(0, cores)
    torch.set_num_threads(threads)


def start(script: str, argv: List[str], rank: int, world: int,
          threads: int, cores: Optional[str], cwd
          ) -> Tuple[Optional[str], list]:
    """On rank 0: the slices of its cores worked out, ranks 1 .. world - 1
    of `script` with `argv` started, each given its slice, and this process
    pinned to the first; returns the group's address and the children.  On
    another rank: this process pinned to `cores` (as rank 0 gave them);
    returns (None, [])."""
    if rank:
        pin([int(c) for c in cores.split(",")], threads)
        return None, []
    every = slices(world)
    address, children = None, []
    if world > 1:
        address = f"tcp://localhost:{free_port()}"
        children = [subprocess.Popen(
            [sys.executable, script, *argv, "--address", address,
             "--cores", ",".join(map(str, every[r])), "--rank", str(r)],
            cwd=str(cwd)) for r in range(1, world)]
    pin(every[0], threads)
    return address, children


def kill(children) -> None:
    for p in children:
        p.kill()


def wait(children) -> List[str]:
    """Waits for every child; returns the ranks that failed or had to be
    killed."""
    bad = []
    for p in children:
        try:
            if p.wait(timeout=CHILD_WAIT_S):
                bad.append(p.args[-1])
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            bad.append(p.args[-1])
    return bad
