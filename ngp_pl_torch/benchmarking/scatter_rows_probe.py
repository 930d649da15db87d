"""What K6's time is made of, on the card: twins of csrc/scatter_rows.cu
with one choice of its design changed, timed on its two inputs
(`bench_inputs.k6_uniform`, `k6_runs`), the readings behind the design in
PERF.md.

    python -m ngp_pl_torch.benchmarking.scatter_rows_probe

Each twin's source is the kernel's with one line replaced (the probe raises
if the line is gone), built with the port's nvcc flags into build/probe/.
Prints one JSON line per twin and input: the kernel's device time alone
(the output zeroed outside the timed kernel; mean of 20 calls under
torch.profiler), the registers ptxas gave the float4 instance, and the
card.  Twins:
- `kernel`: the source as it is;
- `scalar`: scalar loads and reductions for every width;
- `batch8`, `batch16`: a lane loads 8 or 16 rows at once, not 4;
- `seg32`, `seg16`, `seg4`: a warp takes 32, 16 or 4 consecutive rows,
  not 8;
- `ldg`: rows read through the read-only cache, not as streaming loads;
- `regs64`: `__launch_bounds__` for 4 blocks of 256 threads an SM;
- `no_red`: the float4 reductions compiled out (a test the data never
  passes), what the reads alone cost; `no_load`: the rows not read (zeros
  reduced instead, so its error is ~1), what the reductions alone cost.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.benchmarking import bench_inputs as bi
from ngp_pl_torch.benchmarking.timing import device_ms

PROBE_DIR = _build.BUILD_DIR.parent / "probe" / "scatter_rows"
TWINS = {
    "kernel": (),
    "scalar": (("const bool vec = w % 4 == 0 &&", "const bool vec = false &&"),),
    "batch8": (("constexpr int kBatch = 4;", "constexpr int kBatch = 8;"),),
    "batch16": (("constexpr int kBatch = 4;", "constexpr int kBatch = 16;"),),
    "seg32": (("constexpr int kSeg = 8;", "constexpr int kSeg = 32;"),),
    "seg16": (("constexpr int kSeg = 8;", "constexpr int kSeg = 16;"),),
    "seg4": (("constexpr int kSeg = 8;", "constexpr int kSeg = 4;"),),
    "ldg": (("v[i] = __ldcs(rows", "v[i] = __ldg(rows"),),
    "no_red": (("  atomicAdd(p, v);   // RED.E.ADD.F32x4",
                "  if (v.x == -1.2345e30f) atomicAdd(p, v);   //"),),
    "no_load": (("if (active) v[i] = __ldcs(rows + (size_t)p * units + c);",
                 "if (active) v[i] = zero_of(V());"),),
    "regs64": (("__global__ void __launch_bounds__(kBlock)",
                "__global__ void __launch_bounds__(kBlock, 4)"),),
}
_REGS = re.compile(r"scatter_rows_kernelI6float4.*?Used (\d+) registers",
                   re.S)


def twin_sources() -> dict:
    src = (_build.CSRC / "scatter_rows.cu").read_text()
    out = {}
    for name, edits in TWINS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"twin {name}: {old!r} is not in "
                                   f"csrc/scatter_rows.cu")
            text = text.replace(old, new)
        out[f"scatter_rows_{name}"] = text
    return out


def main() -> list:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = _build.compile_sources(twin_sources(), PROBE_DIR)
    inputs = {"uniform": bi.k6_uniform("cuda"), "runs": bi.k6_runs("cuda")}
    records = []
    for name, (lib, log) in libs.items():
        fn = lib.scatter_rows
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        regs = _REGS.search(log)
        for inp, (rows, idx, R) in inputs.items():
            out = torch.zeros((R, rows.shape[1]), device="cuda")

            def call():
                out.zero_()
                _build.check(fn(rows.data_ptr(), idx.data_ptr(),
                                out.data_ptr(), rows.shape[0], rows.shape[1],
                                R, torch.cuda.current_stream().cuda_stream),
                             name)

            call()
            ref = torch.zeros_like(out).index_add_(0, idx, rows)
            err = float((out - ref).abs().max() / ref.abs().max())
            rec = dict(twin=name.removeprefix("scatter_rows_"), input=inp,
                       device_ms=device_ms(call, ("scatter_rows_kernel",)),
                       rel_err=err, registers=int(regs.group(1))
                       if regs else None, card=card)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
