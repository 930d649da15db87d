"""What the encode forward's time is made of, on the card: the readings
behind the design of csrc/hash_encode_fwd.cu (K1 at F=4, K3 at F=2), kept
so that PERF.md's account of it can be measured again after a change.

    python -m ngp_pl_torch.benchmarking.encode_fwd_probe

Prints one JSON line per kernel and input: the kernel's device time at
262,144 random points (`table_grad_inputs.random_x`, the seeded model's
table and w1), without feats and with them, for the kernel as it is and
for twins built from its source with one part of the work taken out:
- `no_table_reads`: the corner points come from their addresses instead of
  the table (no table traffic; the arithmetic and the stores stay);
- `no_mma`: each mma.sync replaced by four f32 adds of its operands (the
  gather and the stores stay);
- `min_6_blocks`: `__launch_bounds__` asks for 6 blocks of 128 threads per
  SM (fewer registers, more warps in flight).
K3 also runs on the L16F2 grid with 2^12 brick slots per hashed level
(`l2_resident_table`): the same kernel and points with a 15 MB table that
the 50 MB L2 holds, where the model's 56.5 MB table does not.  Beside each
time: the table sectors (32 bytes) that the gather requests, four per
sample and level, over the time.
Builds the twins from the kernel's source with the port's nvcc flags into
build/probe/; raises if a replaced line is gone.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ngp_pl_torch import _build
from ngp_pl_torch.benchmarking import table_grad_inputs as tgi
from ngp_pl_torch.benchmarking.timing import device_ms
from ngp_pl_torch.benchmarking.train_setup import train_config
from ngp_pl_torch.ops import hash_encoding as he

PROBE_DIR = _build.BUILD_DIR.parent / "probe"
_LOAD = "return __ldg(reinterpret_cast<const uint2*>(p));"
_MMA = """  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
_BOUNDS = "__global__ void __launch_bounds__(kBlock)\n"
# (line of the kernel's source, what replaces it) of each twin
TWINS = {
    "no_table_reads": ((_LOAD, "return make_uint2((uint32_t)(size_t)p & "
                        "0x03ff03ffu, 0u);"),),
    "no_mma": ((_MMA, "  c[0] += __uint_as_float(a[0] & b0); "
                "c[1] += __uint_as_float(a[1] & b1);\n"
                "  c[2] += __uint_as_float(a[2]); "
                "c[3] += __uint_as_float(a[3]);"),),
    "min_6_blocks": ((_BOUNDS, "__global__ void __launch_bounds__(kBlock, "
                      "6)\n"),),
}


def _build_twins():
    """The kernel and its twins, compiled into PROBE_DIR; the loaded
    libraries and the ptxas lines (registers, spills) by name."""
    src = (_build.CSRC / "hash_encode_fwd.cu").read_text()
    sources = {"encode_fwd_kernel": src}
    for name, edits in TWINS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"csrc/hash_encode_fwd.cu no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        sources[f"encode_fwd_{name}"] = text
    built = _build.compile_sources(sources, PROBE_DIR)
    libs = {name[len("encode_fwd_"):]: lib for name, (lib, _) in built.items()}
    ptxas = {name[len("encode_fwd_"):]: [
        ln.strip() for ln in out.splitlines()
        if "registers" in ln or "spill" in ln]
        for name, (_, out) in built.items()}
    return libs, ptxas


def _call(lib, x, table, w1, spec, feats):
    """The C entry in `lib`, as the wrapper calls it; h1."""
    fn = getattr(lib, "hash_encode_fwd" if spec.n_features == 4
                 else "hash_encode_fwd_f2")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 5
    h1 = torch.empty((x.shape[0], 64), device=x.device)
    _build.check(fn(x.data_ptr(), table.data_ptr(), w1.data_ptr(),
                    h1.data_ptr(), feats.data_ptr() if feats is not None
                    else None, x.shape[0], *he._level_args(spec),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "hash_encode_fwd")
    return h1


def _inputs():
    """(kernel, input) -> (x, table, w1, spec): K1 and K3 at the random
    points with the seeded model's table, and K3 with an L2-resident
    table."""
    from ngp_pl_torch.models.ngp import NGP

    x = tgi.random_x()
    out = {}
    for key, kw in (("K1", {}), ("K3", dict(n_levels=16, n_features=2))):
        tcfg = train_config(**kw)
        model = NGP(tcfg.ngp_config(), seed=tcfg.seed, device="cuda")
        w1 = model.sigma_mlp[0].detach()
        out[key, "random"] = (x, model.encode_table(), w1, model.spec)
        if key == "K3":
            spec = he.make_grid_spec(
                model.spec.n_levels, 2, 19,
                model.spec.resolutions[0],
                tcfg.ngp_config().per_level_scale, log2_bricks=12)
            g = torch.Generator().manual_seed(0)
            out[key, "l2_resident_table"] = (
                x, he.init_hash_table(spec, g).cuda(), w1, spec)
        del model
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("encode_fwd_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs, ptxas = _build_twins()
    print(json.dumps({"card": card, "reading": "ptxas", **ptxas}),
          flush=True)
    for (key, inp), (x, table, w1, spec) in _inputs().items():
        sectors = 4 * x.shape[0] * spec.n_levels
        for with_feats in (False, True):
            feats = (torch.empty((x.shape[0], spec.out_dim), device="cuda")
                     if with_feats else None)
            rec = {"card": card, "kernel": key, "input": inp,
                   "n": x.shape[0], "with_feats": with_feats,
                   "table_MB": table.numel() * table.element_size() / 2 ** 20,
                   "sectors": sectors}
            for name, lib in libs.items():
                if inp != "random" and name != "kernel":
                    continue
                ms = device_ms(lambda: _call(lib, x, table, w1, spec, feats),
                               ("hash_encode_fwd_kernel",))
                rec[f"{name}_ms"] = ms
                rec[f"{name}_G_sectors_per_s"] = sectors / ms / 1e6
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
