"""Two clocks for a kernel on the card: the CUDA-event time of one call of
its wrapper (the host's work in the wrapper included), and the device time
of its kernels alone, from torch.profiler."""
from __future__ import annotations

import statistics
from typing import Tuple

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


def _device_us(fn, runs: int) -> dict:
    """Device microseconds of each kernel, copy and fill, by name, summed
    over `runs` calls under torch.profiler after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def _named_ms(us: dict, names, runs: int) -> float:
    got = [t for key, t in us.items()
           if names is None or any(n in key for n in names)]
    if not got:
        raise RuntimeError(f"the profile holds no kernel named {names}")
    return sum(got) / 1e3 / runs


def _profile(fn, names, runs: int, tries: int = 3) -> dict:
    """`_device_us`, profiled again (up to `tries` times in all) when it
    holds no kernel named in `names`: the profiler has been seen to drop
    a window's kernel records on the card."""
    for _ in range(tries - 1):
        us = _device_us(fn, runs)
        if any(names is None or any(n in key for n in names) for key in us):
            return us
    return _device_us(fn, runs)


def device_ms(fn, names=None, runs: int = 20) -> float:
    """Mean device time per call of the kernels whose names contain one of
    `names` (every kernel, copy and fill on the card if None), over `runs`
    calls under torch.profiler after one warm-up.  Raises if no such
    kernel ran."""
    return _named_ms(_profile(fn, names, runs), names, runs)


def device_split_ms(fn, names, runs: int = 20) -> Tuple[float, float]:
    """From one profile as `device_ms`'s: the mean device time per call of
    the kernels named in `names`, and of all the call's device work."""
    us = _profile(fn, names, runs)
    return _named_ms(us, names, runs), _named_ms(us, None, runs)
