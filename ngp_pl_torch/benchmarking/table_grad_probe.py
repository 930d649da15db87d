"""What the table-gradient kernels' time is made of, on the card: the
readings behind the design of csrc/hash_encode_bwd.cu, kept so that
PERF.md's "Why this design" can be measured again after a change.

    python -m ngp_pl_torch.benchmarking.table_grad_probe

Prints one JSON line per reading:
- `reduction_rates`: how fast the L2 resolves f32 reductions into device
  memory, by pattern: 32 lanes to random 16-byte slots (v4), to random
  4-byte and 8-byte slots (scalar, v2), and lanes of one instruction that
  share a 32-byte sector, 64 bytes, or a 128-byte line; 16.8M reductions
  into 32 MB (held in the 50 MB L2) and 128 MB (not held);
- for K2+K5 and K4 (csrc/hash_encode_bwd.cu) at 262,144 random points and
  on a train step's input after a 512-step fit
  (`table_grad_inputs`), the kernel's device time with the merge of lanes
  by cell on the levels up to 0 (none), 128, 256 (the kernel's own
  `kMergeMaxRes`), 512 cells per axis and on every level; and the kernel
  with its reductions compiled out (the rest of its work).  Beside them
  the reductions per sample that the design issues, as `design_reductions`
  counts them from the inputs: a model of the kernel's issue rule, not a
  reading of the card.
Builds its libraries from the kernel's source, each with the constant or
the reductions replaced, with the port's nvcc flags into build/probe/.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from typing import Optional, Tuple

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.benchmarking import table_grad_inputs as tgi
from ngp_pl_torch.benchmarking.train_setup import train_config
from ngp_pl_torch.benchmarking.timing import device_ms
from ngp_pl_torch.ops import hash_encoding as he

PROBE_DIR = _build.BUILD_DIR.parent / "probe"
MERGE_LINE = re.compile(r"constexpr int kMergeMaxRes = (\d+);")
# the merge thresholds timed beside the kernel's own: none, 128, 512, all
MERGE_SWEEP = {"merge_none": 0, "merge_le128": 128, "merge_le512": 512,
               "merge_all": 2 ** 30}

RED_RATES_CU = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}
// lanes in groups of `group` share one random block of `group * width`
// floats; each lane adds `width` floats (1, 2 or 4) at its own offset in it
__global__ void red_rates(float* buf, uint32_t n_blocks, int group,
                          int width, int iters) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const float v = 1e-7f;
  for (int it = 0; it < iters; ++it) {
    const uint32_t r = mix((t / group) * 977u + it * 0x9e3779b9u);
    float* p = buf + ((size_t)(r % n_blocks) * group + t % group) * width;
    if (width == 4) atomicAdd((float4*)p, make_float4(v, v, v, v));
    else if (width == 2) atomicAdd((float2*)p, make_float2(v, v));
    else atomicAdd(p, v);
  }
}
extern "C" int red_rates_run(void* buf, unsigned n_blocks, int group,
                             int width, int threads, int iters,
                             void* stream) {
  red_rates<<<threads / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)buf, n_blocks, group, width, iters);
  return (int)cudaGetLastError();
}
'''
# the reductions of csrc/hash_encode_bwd.cu, and what replaces them in the
# twin without them: a test the data never passes, so nothing else changes
_RED_BODIES = (
    ("atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));",
     "if (a + b + c + d == -1.2345e30f) atomicAdd(p, a);"),
    ("atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));",
     "if (a + b == -1.2345e30f) atomicAdd(p, a);"))
# (lanes per block, floats per lane) of each pattern
PATTERNS = {"v4_random": (1, 4), "v4_2_per_sector": (2, 4),
            "v4_4_per_64B": (4, 4), "v4_8_per_line": (8, 4),
            "f32_random": (1, 1), "f32_8_per_sector": (8, 1),
            "v2_random": (1, 2), "v2_2_per_16B": (2, 2)}


def _kernel_source() -> str:
    return (_build.CSRC / "hash_encode_bwd.cu").read_text()


def merge_max_res(src: Optional[str] = None) -> int:
    """The kernel's `kMergeMaxRes`: the levels with at most this many cells
    per axis merge the lanes of a warp by cell."""
    m = MERGE_LINE.search(src or _kernel_source())
    if m is None:
        raise RuntimeError("csrc/hash_encode_bwd.cu no longer sets "
                           "kMergeMaxRes")
    return int(m.group(1))


def merged_levels(spec, max_res: Optional[int] = None) -> Tuple[bool, ...]:
    """The levels on which the kernel merges by cell."""
    max_res = merge_max_res() if max_res is None else max_res
    return tuple(r <= max_res for r in spec.resolutions)


def design_reductions(x: torch.Tensor, g: torch.Tensor, spec,
                      max_res: Optional[int] = None) -> int:
    """The reductions into device memory that the kernel's issue rule
    gives for these inputs: per level and cell, 8 at F=4 (one v4 per
    corner) and 6 at F=2 (two aligned z-pairs as v4, four v2), once per
    nonzero-gradient sample, or, on the merged levels, once per distinct
    cell among the nonzero samples of each warp (32 consecutive
    samples)."""
    per_cell = 8 if spec.n_features == 4 else 6
    active = (g != 0).any(dim=1)
    slot, local, _ = he.slots_local_frac_lm(x.clamp(0.0, 1.0), spec)
    key = slot * 8 + ((local[..., 0] * 2 + local[..., 1]) * 2
                      + local[..., 2])
    key = torch.where(active, key, -1)
    key = torch.nn.functional.pad(key, (0, -x.shape[0] % 32), value=-1)
    total = 0
    for l, merged in enumerate(merged_levels(spec, max_res)):
        warps = key[l].reshape(-1, 32)
        if merged:
            s = warps.sort(dim=1).values
            n = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum() + (
                s[:, 0] >= 0).sum()
        else:
            n = (warps >= 0).sum()
        total += int(n) * per_cell
    return total


def _build_probe() -> dict:
    """Compiles the rate kernel, the table-gradient kernel at each merge
    threshold of MERGE_SWEEP and, at its own, without its reductions, into
    PROBE_DIR; returns the loaded libraries by name."""
    src = _kernel_source()
    own = MERGE_LINE.search(src).group(0)
    nored = src
    for old, new in _RED_BODIES:
        if old not in nored:
            raise RuntimeError(f"csrc/hash_encode_bwd.cu no longer has {old}")
        nored = nored.replace(old, new)
    sources = {"red_rates": RED_RATES_CU, "hash_encode_bwd_nored": nored}
    for label, r in MERGE_SWEEP.items():
        sources[label] = src.replace(
            own, f"constexpr int kMergeMaxRes = {r};")
    return {name: lib for name, (lib, _) in
            _build.compile_sources(sources, PROBE_DIR).items()}


def reduction_rates(lib, emit) -> None:
    fn = lib.red_rates_run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    threads, iters = 262144, 64
    for mb in (32, 128):
        buf = torch.zeros(mb * 2 ** 20 // 4, device="cuda")
        for name, (group, width) in PATTERNS.items():
            n_blocks = buf.numel() // (group * width)

            def call():
                _build.check(fn(buf.data_ptr(), n_blocks, group, width,
                                threads, iters,
                                torch.cuda.current_stream().cuda_stream),
                             "red_rates")

            ms = device_ms(call, ("red_rates",))
            reds = threads * iters
            emit({"reading": "reduction_rates", "buffer_MB": mb,
                  "pattern": name, "ms": ms,
                  "G_reductions_per_s": reds / ms / 1e6,
                  "G_bytes_per_s": reds * width * 4 / ms / 1e6})
        del buf


def _call(lib, x, g, w1, spec):
    """The C entry of the table-gradient kernel in `lib`, as the wrapper
    calls it."""
    F = spec.n_features
    fn = getattr(lib, "hash_encode_bwd" if F == 4 else "hash_encode_bwd_f2")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    d = torch.zeros((spec.total_rows, 32 * F), device=x.device)
    _build.check(fn(x.data_ptr(), g.data_ptr(), w1.data_ptr(), d.data_ptr(),
                    x.shape[0], *he._level_args(spec),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "hash_encode_bwd")
    return d


def kernel_parts(libs, emit) -> None:
    from ngp_pl_torch.models.ngp import NGP

    own = f"merge_le{merge_max_res()}"
    timed = dict(libs, **{own: _build.library("hash_encode_bwd")})
    order = ("merge_none", "merge_le128", own, "merge_le512", "merge_all",
             "hash_encode_bwd_nored")
    for geometry, kw in (("l8f4", {}), ("l16f2", dict(n_levels=16,
                                                      n_features=2))):
        tcfg = train_config(**kw)
        model = NGP(tcfg.ngp_config(), seed=tcfg.seed, device="cuda")
        x, g = tgi.random_input()
        inputs = {"random": (x, g, model.sigma_mlp[0].detach(), model.spec)}
        del model
        inputs["train_step"] = tgi.fitted_train_input(tcfg)
        for name, (x, g, w1, spec) in inputs.items():
            rec = {"reading": "kernel_parts", "geometry": geometry,
                   "input": name, "n": x.shape[0],
                   "nonzero_rows": int((g != 0).any(dim=1).sum()),
                   "design_reductions_per_sample":
                   design_reductions(x, g, spec) / x.shape[0]}
            for label in order:
                lib = timed[label]
                rec["no_reductions" if label == "hash_encode_bwd_nored"
                    else label] = device_ms(
                    lambda: _call(lib, x, g, w1, spec),
                    ("hash_encode_bwd_kernel",))
            emit(rec)
            torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("table_grad_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()

    def emit(rec):
        print(json.dumps({"card": card, **rec}), flush=True)

    libs = _build_probe()
    reduction_rates(libs.pop("red_rates"), emit)
    kernel_parts(libs, emit)


if __name__ == "__main__":
    main()
