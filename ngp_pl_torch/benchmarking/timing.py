"""Two clocks for a kernel on the card: the CUDA-event time of one call of
its wrapper (the host's work in the wrapper included), and the device time
of its kernels alone, from torch.profiler.  Inputs stay warm in L2 between
calls unless `flush` is set: then every call finds the L2 cold, as a caller
does whose inputs were written long before, and a bound at the memory's
rate holds."""
from __future__ import annotations

import statistics
from typing import Tuple

import torch

FLUSH_BYTES = 256 << 20        # written before each call: 5x the H100's L2
FLUSH_KERNEL = "bitwise_not"   # the flush's kernel, left out of the times


def _flusher(flush: bool):
    """A call that overwrites FLUSH_BYTES on the card, evicting the L2, or
    one that does nothing."""
    if not flush:
        return lambda: None
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    return lambda: torch.bitwise_not(buf, out=buf)


def time_ms(fn, runs: int = 20, warmup: int = 3, flush: bool = False) -> float:
    """Median over `runs` of the CUDA-event time of one call, after
    `warmup` calls.  Inputs stay warm in L2 between calls, as the table
    does on the render path, where every round reads it again; with
    `flush` the L2 is overwritten before each call, outside the events."""
    pre = _flusher(flush)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        pre()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_us(fn, runs: int, flush: bool = False) -> dict:
    """Device microseconds of each kernel, copy and fill, by name, summed
    over `runs` calls under torch.profiler after one warm-up; with `flush`
    each call after an L2 flush, whose kernel is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pre = _flusher(flush)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            pre()
            fn()
        torch.cuda.synchronize()
    us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
          if ev.device_type == DeviceType.CUDA}
    flushed = [k for k in us if FLUSH_KERNEL in k]
    if flush and not flushed:
        raise RuntimeError("the profile holds no L2 flush")
    return {k: t for k, t in us.items() if k not in flushed}


def _named_ms(us: dict, names, runs: int) -> float:
    got = [t for key, t in us.items()
           if names is None or any(n in key for n in names)]
    if not got:
        raise RuntimeError(f"the profile holds no kernel named {names}")
    return sum(got) / 1e3 / runs


def _profile(fn, names, runs: int, flush: bool, tries: int = 3) -> dict:
    """`_device_us`, profiled again (up to `tries` times in all) when it
    holds no kernel named in `names`: the profiler has been seen to drop
    a window's kernel records on the card."""
    for _ in range(tries - 1):
        us = _device_us(fn, runs, flush)
        if any(names is None or any(n in key for n in names) for key in us):
            return us
    return _device_us(fn, runs, flush)


def device_ms(fn, names=None, runs: int = 20, flush: bool = False) -> float:
    """Mean device time per call of the kernels whose names contain one of
    `names` (every kernel, copy and fill on the card if None), over `runs`
    calls under torch.profiler after one warm-up, each after an L2 flush
    with `flush`.  Raises if no such kernel ran."""
    return _named_ms(_profile(fn, names, runs, flush), names, runs)


def device_split_ms(fn, names, runs: int = 20,
                    flush: bool = False) -> Tuple[float, float]:
    """From one profile as `device_ms`'s: the mean device time per call of
    the kernels named in `names`, and of all the call's device work."""
    us = _profile(fn, names, runs, flush)
    return _named_ms(us, names, runs), _named_ms(us, None, runs)
