"""Reading a torch.profiler trace of the card (CPU and CUDA activities)
into what the per-layer readers take: the device's busy time (the union of
its kernels, copies and fills), its operations by name, the idle gaps
between them with what the host was doing then, and the runtime's kernel
launches.  The profiling pattern is the port's
`ngp_pl_torch/benchmarking/timing.py`'s (a fence before and after, device
records of the window only), frozen here; nothing here imports the
program."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
NO_HOST_OP = "_no_host_operation_"
GAPS_NAMED = 10
ANNOTATED = ("nccl:",)      # device-side ranges, not operations


def profile(fn):
    """`fn()` between two fences under torch.profiler (CPU and CUDA);
    returns (the profile, the fenced seconds of the window)."""
    import time

    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        seconds = time.perf_counter() - t0
    return prof, seconds


def _union(intervals: List[Tuple[float, float]]):
    """Merged (start, end) intervals, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof) -> Dict:
    """The profile's device operations [(name, start_us, end_us)], host
    operations [(name, start_us, end_us)], runtime launches, busy
    microseconds and the GAPS_NAMED longest idle gaps [(host operation,
    microseconds)], longest first."""
    from torch.autograd import DeviceType

    dev, host, launches = [], [], 0
    for e in prof.events():
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a range annotated on the device's timeline (as NCCL's
            # "nccl:all_reduce") spans operations listed on their own
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(ANNOTATED)):
                dev.append(r)
        elif e.device_type == DeviceType.CPU:
            if e.name in LAUNCH_CALLS:
                launches += 1
            else:
                host.append(r)
    busy = _union([(a, b) for _, a, b in dev])
    gaps = sorted(((end, start) for (_, end), (start, _)
                   in zip(busy[:-1], busy[1:]) if start > end),
                  key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    gaps = [(_host_at(host, a, b), b - a) for a, b in gaps]
    return {"device_ops": dev, "host_ops": host, "launches": launches,
            "busy_us": sum(b - a for a, b in busy), "gaps": gaps}


def _host_at(host: Sequence, start: float, end: float) -> str:
    """The innermost host operation running through the middle of a gap."""
    mid = 0.5 * (start + end)
    best, best_start = NO_HOST_OP, None
    for name, a, b in host:
        if a <= mid <= b and (best_start is None or a > best_start):
            best, best_start = name, a
    return best


def by_name(ops: Sequence) -> List[Tuple[str, float]]:
    """Device seconds by operation name, largest first."""
    tot: Dict[str, float] = {}
    for name, a, b in ops:
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])


def ops_matching(ops: Sequence, parts: Sequence[str]) -> List:
    return [op for op in ops if any(p in op[0] for p in parts)]


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The line's `breakdown`: the device operations that took most time
    and the longest idle gaps by host operation, in seconds."""
    return {"device_ops": [[n, s] for n, s in by_name(tr["device_ops"])[:top]],
            "idle_gaps": [[n, us * 1e-6] for n, us in tr["gaps"][:top]]}
