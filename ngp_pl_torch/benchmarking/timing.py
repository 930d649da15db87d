"""Two clocks for a kernel on the card: the CUDA-event time of one call of
its wrapper (the host's work in the wrapper included), and the device time
of its kernels alone, from torch.profiler."""
from __future__ import annotations

import statistics

import torch


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median over `runs` of the CUDA-event time of one call, after
    `warmup` calls.  Inputs stay warm in L2 between calls, as the table
    does on the render path, where every round reads it again."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, names=None, runs: int = 20) -> float:
    """Mean device time per call of the kernels whose names contain one of
    `names` (every kernel, copy and fill on the card if None), over `runs`
    calls under torch.profiler after one warm-up.  Raises if no such
    kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = [ev.self_device_time_total for ev in prof.key_averages()
          if (ev.device_type == DeviceType.CUDA if names is None
              else any(n in ev.key for n in names))]
    if not us:
        raise RuntimeError(f"the profile holds no kernel named {names}")
    return sum(us) / 1e3 / runs
