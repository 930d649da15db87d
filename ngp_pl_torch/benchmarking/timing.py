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


def _device_us(fn, runs: int, flush: bool = False):
    """Device microseconds per call of each kernel, copy and fill, by name,
    over `runs` calls under torch.profiler after one warm-up; with `flush`
    each call after an L2 flush, whose kernel is left out.  Also the calls
    the profile holds a flush of (`runs` without `flush`).

    Late in a long process the profiler on the card has been seen to drop a
    tenth to two fifths of a window's records, the same share with or without
    idle time at the window's ends; so a kernel's time per call is the mean
    of the records the profile holds, times its records per call recorded
    (rounded), not its sum over `runs`."""
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
    return per_call_us([(ev.key, ev.count, ev.self_device_time_total)
                        for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA], runs, flush)


def per_call_us(records, runs: int, flush: bool):
    """From a profile's (name, records, device microseconds) of `runs`
    calls: microseconds per call by name, the flush's left out, and the
    calls the profile holds a flush of (`runs` without `flush`).  A name's
    records per call are its records over those calls, rounded: a name
    with fewer records than half the calls is left out."""
    calls = (sum(n for key, n, _ in records if FLUSH_KERNEL in key)
             if flush else runs)
    us = {}
    for key, n, t in records:
        per_call = int(n / calls + 0.5) if calls else 0
        if FLUSH_KERNEL not in key and per_call:
            us[key] = t / n * per_call
    return us, calls


def _named_ms(us: dict, names) -> float:
    got = [t for key, t in us.items()
           if names is None or any(n in key for n in names)]
    if not got:
        raise RuntimeError(f"the profile holds no kernel named {names}")
    return sum(got) / 1e3


def _profile(fn, names, runs: int, flush: bool, tries: int = 3) -> dict:
    """`_device_us`, profiled again (up to `tries` times in all) when it
    holds no kernel named in `names` or the flushes of fewer than half the
    calls.  Raises if every try held too few flushes."""
    for _ in range(tries):
        us, calls = _device_us(fn, runs, flush)
        named = any(names is None or any(n in key for n in names)
                    for key in us)
        if named and 2 * calls >= runs:
            return us
    if 2 * calls < runs:
        raise RuntimeError(f"the profile holds the L2 flushes of fewer than "
                           f"half the {runs} calls in each of {tries} tries")
    return us


def device_ms(fn, names=None, runs: int = 20, flush: bool = False) -> float:
    """Mean device time per call of the kernels whose names contain one of
    `names` (every kernel, copy and fill on the card if None), over `runs`
    calls under torch.profiler after one warm-up, each after an L2 flush
    with `flush`.  Raises if no such kernel ran."""
    return _named_ms(_profile(fn, names, runs, flush), names)


def device_split_ms(fn, names, runs: int = 20,
                    flush: bool = False) -> Tuple[float, float]:
    """From one profile as `device_ms`'s: the mean device time per call of
    the kernels named in `names`, and of all the call's device work."""
    us = _profile(fn, names, runs, flush)
    return _named_ms(us, names), _named_ms(us, None)
