"""What K9-stream's time is made of, on the card: twins of
csrc/encode_ablations.cu with one choice of the stream instance changed,
timed on the bench's inputs beside the PyTorch calls that compute the same
function, and the host time of the wrapper's call beside theirs.

    python -m ngp_pl_torch.benchmarking.encode_ablation_probe

Each twin's source is the kernel's with lines replaced (the probe raises
if a line is gone), built with the port's nvcc flags into build/probe/.
Prints one JSON line per reading, with the card:
- per twin, the stream entry's device time (mean of 20 calls under
  torch.profiler, rows cold: 402.7 MB, past the L2) on f32 U(-2, 2) rows
  at N=196,608, L=8 (`bench_inputs`), and its error against the plain
  version.  Twins: `kernel` (the source as it is); `ldcs`: rows read as
  streaming (evict-first) loads, not through the read-only cache;
  `ft2_wb`, `h1_wb`: ft2's zeros or h1 written with plain (write-back)
  stores, not streaming ones; `levels4`: 4 levels' loads in flight, not
  8;
- `library`: `rows.view(float32).sum(0)` and ft2's `torch.zeros`, device
  time, and the sum's kernel alone;
- `host`: the median host time of one call, before any wait, of the
  wrapper (`CUDA["stream"]`), of its C entry alone with the outputs
  allocated beforehand, and of the library calls (20 calls, each after a
  synchronize);
- `event`: the CUDA-event time (`timing.time_ms`) of the same three, in
  three rounds of turns.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import time

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.benchmarking import bench_inputs as bi
from ngp_pl_torch.benchmarking.timing import (device_ms, device_split_ms,
                                              time_ms)
from ngp_pl_torch.ops import encode_ablations as ea

PROBE_DIR = _build.BUILD_DIR.parent / "probe" / "encode_ablations"
H1_STORE = ("__stcs(reinterpret_cast<float4*>(h1) + u, acc);",
            "reinterpret_cast<float4*>(h1)[u] = acc;")
FT2_STORE = ("__stcs(reinterpret_cast<float4*>(ft2) + u,\n"
             "             make_float4(0.f, 0.f, 0.f, 0.f));",
             "reinterpret_cast<float4*>(ft2)[u] = make_float4(0.f, 0.f, "
             "0.f, 0.f);")
TWINS = {
    "kernel": (),
    "ldcs": (("q[k] = __ldg(rows", "q[k] = __ldcs(rows"),),
    "ft2_wb": (FT2_STORE,),
    "h1_wb": (H1_STORE,),
    "levels4": (("constexpr int kStreamLevels = 8;",
                 "constexpr int kStreamLevels = 4;"),),
}


def twin_sources() -> dict:
    src = (_build.CSRC / "encode_ablations.cu").read_text()
    out = {}
    for name, edits in TWINS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"twin {name}: {old!r} is not in "
                                   f"csrc/encode_ablations.cu")
            text = text.replace(old, new)
        out[f"encode_ablations_{name}"] = text
    return out


def _host_ms(fn, runs: int = 20) -> float:
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> list:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = _build.compile_sources(twin_sources(), PROBE_DIR)
    (rows, meta_T, w1big), _ = bi.k9_inputs(bi.K9_N, "cuda")
    rows = bi.k9_f32_rows(rows.shape, "cuda")
    L, N = rows.shape[:2]
    h1 = torch.empty((N, ea.H), device="cuda")
    ft2 = torch.empty((L, ea.F, N), device="cuda")
    ref = ea.encode_ablation_plain("stream", rows, meta_T, w1big)
    records = []

    def emit(rec):
        rec["card"] = card
        records.append(rec)
        print(json.dumps(rec), flush=True)

    entries = {}
    for name, (lib, _) in libs.items():
        fn = lib.encode_ablation_stream
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        entries[name] = fn

        def call(fn=fn, name=name):
            _build.check(fn(rows.data_ptr(), meta_T.data_ptr(),
                            w1big.data_ptr(), None, h1.data_ptr(),
                            ft2.data_ptr(), N, L, 0,
                            torch.cuda.current_stream().cuda_stream), name)

        call()
        err = max(float((h1 - ref[0]).abs().max()),
                  float(ft2.abs().max()))
        emit(dict(twin=name.removeprefix("encode_ablations_"),
                  device_ms=device_ms(call, ("encode_ablation",)),
                  max_abs_err=err))
    shape = (L, ea.F, N)
    lib_call = lambda: (rows.view(torch.float32).sum(0),
                        torch.zeros(shape, device="cuda"))
    sum_ms, lib_ms = device_split_ms(lib_call, ("reduce",))
    emit(dict(twin="library", device_ms=lib_ms, sum_device_ms=sum_ms))
    fn = entries["encode_ablations_kernel"]
    entry = lambda: fn(rows.data_ptr(), meta_T.data_ptr(), w1big.data_ptr(),
                       None, h1.data_ptr(), ft2.data_ptr(), N, L, 0,
                       torch.cuda.current_stream().cuda_stream)
    wrapper = lambda: ea.CUDA["stream"](rows, meta_T, w1big)
    emit(dict(twin="host", wrapper_ms=_host_ms(wrapper),
              entry_ms=_host_ms(entry), library_ms=_host_ms(lib_call)))
    # the CUDA-event time of each, three rounds in turns
    events = {"wrapper": [], "entry": [], "library": []}
    for _ in range(3):
        for name, fn_ in (("wrapper", wrapper), ("entry", entry),
                          ("library", lib_call)):
            events[name].append(time_ms(fn_))
    emit(dict(twin="event", **{f"{k}_ms": v for k, v in events.items()}))
    return records


if __name__ == "__main__":
    main()
