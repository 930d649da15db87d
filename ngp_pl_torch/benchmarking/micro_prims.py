"""What the JAX repository's six primitive micros share in the port
(`micro`, `micro_r2`, `micro_r2b`, `micro_r2c`, `micro_r4`,
`micro_scatter`): the torch forms of the JAX expressions that have no
one-call torch form, the timing of a script's labels, the check of a
`port: ` label against its primitive, and the command line.

Each script times each label's call as the JAX script's `timeit` does: 3
warm-up calls, then 20 calls between two fences (`profile_step.timeit`),
and on the card the device ms of the call's kernels (`timing.device_ms`).
The JAX scripts end each timed function in a `.sum()`, which fences their
host read; here a synchronize fences, so the calls return their result
whole (XLA fuses such a sum into the gather or scatter before it, and
PyTorch writes the result out).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

# what a label runs where the JAX expression has no one-call torch form
DROP_NOTE = ('mode="drop": a scatter into one extra sink row that takes '
             'the out-of-range indices, sliced off after')
SEGMENT_SUM_NOTE = "jax.ops.segment_sum: index_add_ into zeros"
BF16_MM_NOTE = ("a bf16 matmul with f32 output (torch.mm(out_dtype=float32) "
                "on the card; on the CPU, which has no such mm, the f32 "
                "matmul of the bf16 values: exact products, f32 sums)")
ONE_HOT_NOTE = ("jax.nn.one_hot @: F.one_hot(...).to(bf16) and "
                + BF16_MM_NOTE)


def unique(labels) -> tuple:
    """The labels as record keys: where a JAX script prints one label for
    two timings (two dtypes and widths of one byte count), its k-th
    repeat takes " (k)"."""
    seen, out = {}, []
    for label in labels:
        seen[label] = seen.get(label, 0) + 1
        out.append(label if seen[label] == 1 else f"{label} ({seen[label]})")
    return tuple(out)


class KeyDraws:
    """The JAX scripts draw every normal array from one jax.random key, so
    that two arrays of one size hold one draw (in their own dtype).  Here
    each size is one `standard_normal` float32 draw from the script's
    numpy generator, made where the JAX script first draws that size and
    reused (reshaped) for the others; the caller casts it."""

    def __init__(self, rng):
        self.rng, self.drawn = rng, {}

    def normal(self, shape):
        n = int(np.prod(shape))
        if n not in self.drawn:
            self.drawn[n] = self.rng.standard_normal(n, np.float32)
        return self.drawn[n].reshape(shape)


def tensor(a, dtype=None, device="cpu"):
    """A numpy array on `device`, cast to `dtype` when given."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


def scatter_add(n_rows: int, idx, rows, dtype=None, drop: bool = False):
    """`jnp.zeros((n_rows, W), dtype).at[idx].add(rows)`: rows cast to
    `dtype` (rows' own by default) and added into zeros by `index_add_`.
    With `drop`, the JAX scatter's `mode="drop"` (DROP_NOTE)."""
    dtype = dtype or rows.dtype
    extra = int(drop)
    if drop:
        idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.zeros((n_rows + extra,) + tuple(rows.shape[1:]), dtype=dtype,
                      device=rows.device)
    out.index_add_(0, idx, rows.to(dtype))
    return out[:n_rows] if drop else out


def segment_sum(data, seg, num_segments: int):
    """`jax.ops.segment_sum(data, seg, num_segments)` with every id in
    range (SEGMENT_SUM_NOTE)."""
    return scatter_add(num_segments, seg, data)


def mm_f32_out(a, b):
    """a @ b of bf16 operands with an f32 result, as `dot_general(...,
    preferred_element_type=f32)` (ONE_HOT_NOTE)."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def one_hot_scatter(idx, n_rows: int, rows):
    """`dot_general(jax.nn.one_hot(idx, n_rows, bf16), rows, contracting
    dim 0, f32 out)`: (n_rows, W) sums (ONE_HOT_NOTE)."""
    oh = F.one_hot(idx, n_rows).to(torch.bfloat16)
    return mm_f32_out(oh.t(), rows)


def k6_scatter(n_rows: int, idx, rows):
    """K6 (`scatter_rows`) in `scatter_add`'s argument order."""
    from ngp_pl_torch.ops.scatter_rows import scatter_rows

    return scatter_rows(rows, idx, n_rows)


def flat(result):
    """A label's result (a tensor, or a tuple or list of them) as one flat
    float64 tensor, for comparisons."""
    if isinstance(result, torch.Tensor):
        return result.detach().reshape(-1).to(torch.float64)
    return torch.cat([flat(r) for r in result])


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over the flattened results."""
    g, w = flat(got), flat(want)
    scale = float(w.abs().max()) if w.numel() else 0.0
    return float((g - w).abs().max()) / (scale or 1.0)


def time_labels(fns: dict, device, runs: int = 20, warmup: int = 3,
                log=sys.stderr, width: int = 52, derived=None) -> dict:
    """Every label's call timed (`profile_step.timeit`): {label:
    {"wall_ms", "device_ms"}} in order, its line on `log`.  `derived`
    maps a label to (unit, per-ms function): the rate is read from the
    device ms where there is one, else from the wall ms, kept under the
    unit's name and printed on a line of its own, as the JAX script's
    "->" lines."""
    from ngp_pl_torch.benchmarking.profile_step import timeit

    out = {}
    for label, fn in fns.items():
        rec = timeit(fn, device, runs=runs, warmup=warmup)
        dev_ms = rec["device_ms"]
        if log is not None:
            print(f"{label:{width}s} {rec['wall_ms']:8.3f} ms"
                  + (f"  device {dev_ms:8.3f} ms" if dev_ms is not None
                     else ""), file=log, flush=True)
        if derived and label in derived:
            unit, per_ms = derived[label]
            rec[unit] = per_ms(dev_ms if dev_ms is not None
                               else rec["wall_ms"])
            if log is not None:
                print(f"   -> {rec[unit]:.2f} {unit.replace('_per_', '/')}",
                      file=log, flush=True)
        out[label] = rec
    return out


def port_errors(fns: dict, references: dict) -> dict:
    """Each `port: ` label's result against its primitive's on the same
    input: {label: (kernel, max |port - primitive| / max |primitive|)}."""
    return {label: (kernel, rel_err(fns[label](), ref()))
            for label, (kernel, ref) in references.items()}


def main(module, argv=None) -> dict:
    """A script's command line: --device, --runs, --warmup and one
    integer option per entry of `module.SHAPES` (the JAX script's sizes,
    the defaults); the card line and the shapes as a JSON line first, the
    table on stderr, and last {label: {"wall_ms", "device_ms"}} (after
    the rest of a record that holds more, as micro_r4's)."""
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser(description=module.__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    for key, value in module.SHAPES.items():
        ap.add_argument(f"--{key}", type=int, default=value)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    shape = {k: getattr(args, k) for k in module.SHAPES}
    print(json.dumps(dict(card=card_line(args.device), **shape)),
          flush=True)
    rec = module.run(args.device, runs=args.runs, warmup=args.warmup,
                     **shape)
    if "labels" in rec:
        print(json.dumps({k: v for k, v in rec.items() if k != "labels"}),
              flush=True)
    print(json.dumps(rec.get("labels", rec)), flush=True)
    return rec
