"""Hand kernels of two trees of this repository, timed in turns on one card:
the field tail (K7, K8), the table gradient (K2+K5 at F=4, K4 at F=2), the
encode forward (K1 at F=4, K3 at F=2), the encode ablations (K9, six
variants) and the row scatter-add (K6).

    mkdir -p build/parent
    git archive <commit> ngp_pl_torch | tar -x -C build/parent
    python -m ngp_pl_torch.benchmarking.kernel_ab build/parent . \
        [--groups field_tail,encode,k9,k6]

`--groups` picks the kernels (all four groups by default; `encode`, K1-K4,
fits two systems for 512 steps first, the others need no fit).

Each tree runs its own wrappers (`field_tail_cuda` and `field_tail_bwd_cuda`
of its `ops/field_tail.py`, `hash_encode_bwd_cuda`,
`hash_encode_bwd_f2_cuda`, `hash_encode_fwd_cuda` and
`hash_encode_fwd_f2_cuda` of its `ops/hash_encoding.py`) in a process of its
own with the tree first on sys.path; its kernels build into its own
build/kernels/.  The turns are first, second, second, first.  In each:
- K7 at 1,048,576 and 393,216 samples and K8 at 262,144 and 393,216 on
  chip_smoke.py's inputs (`field_tail_gates.tail_inputs`, the seeded
  flagship weights);
- K2+K5 and K4, each on two inputs that this process makes once and hands
  to every turn: 262,144 random points with chip_smoke.py's gradient rows
  and the seeded model's w1 (`table_grad_inputs.random_input`), and the
  (x, g, w1) a train step gives the kernel after a 512-step fit of the
  seeded system on bench.py's scene (`table_grad_inputs.fitted_train_input`,
  fitted with this process's tree), L8F4 and L16F2;
- K1 and K3 on the same two kinds of input: chip_smoke.py's 262,144 random
  points (`table_grad_inputs.random_x`) with the seeded model's table and
  w1, called without feats as the render path calls it, and the train
  step's x with the fitted table and w1, called with feats as the train
  step calls it;
- the six K9 variants on the JAX bench's inputs (`bench_inputs.k9_inputs`,
  N=196,608, L=8, rows cold: 402.7 MB, past the L2; f32 U(-2, 2) bits for
  no_decode and stream, full_il at bn=4,096), and beside K9-stream the
  PyTorch calls that compute its function (the sum over levels of the rows
  as f32, and ft2's zeros);
- K6 on two inputs (`bench_inputs.k6_uniform`, `k6_runs`): 262,144 rows of
  128 at uniform random indices into 16,384, and the JAX scatter bench's
  runs of 74 equal indices, 327,680 rows into 512; beside it
  `Tensor.index_add_` with its zero fill.
Each is timed on two clocks: the median of 20 CUDA-event-timed calls after
3 warm-ups (the wrapper's host work included), and the device time of every
kernel, copy and fill a call puts on the card, under torch.profiler (mean
of 20 calls); for the table gradient also its kernel's device time alone
(without the zero fill), from the same profile.  Each turn also reads its
outputs' error against its own tree's f32 plain version (for K1, K3 and
K9 the larger of their two outputs', each of its max).  One JSON line
per kernel, input and size: both trees' times, `speedup` (the first tree's
time over the second's, event clock) and `device_speedup`, and the bound.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SIZES = {"K7": (1048576, 393216), "K8": (262144, 393216)}
# the table gradient and the encode forward by F, and their kernels' device
# names
BWD_KERNEL = {4: "K2+K5", 2: "K4"}
BWD_DEVICE_NAME = "hash_encode_bwd_kernel"
FWD_KERNEL = {4: "K1", 2: "K3"}
FWD_DEVICE_NAME = "hash_encode_fwd_kernel"
K9_DEVICE_NAME = "encode_ablation"
K6_DEVICE_NAME = "scatter_rows"
GROUPS = ("field_tail", "encode", "k9", "k6")


def make_inputs(path: Path) -> None:
    """Saves the encode kernels' inputs, by name, on the CPU: the table
    gradient's x, g, w1; the forward's x (`fwd_x`) and the table it reads
    (`table`); the grid's parameters (`make_grid_spec` keywords)."""
    import torch

    from ngp_pl_torch.benchmarking import table_grad_inputs as tgi
    from ngp_pl_torch.benchmarking.train_setup import train_config
    from ngp_pl_torch.models.ngp import NGP

    out = {}
    for name, kw in (("l8f4", {}), ("l16f2", dict(n_levels=16,
                                                  n_features=2))):
        tcfg = train_config(**kw)
        c = tcfg.ngp_config()
        grid = dict(n_levels=c.n_levels, n_features=c.n_features_per_level,
                    log2_hashmap_size=c.log2_hashmap_size,
                    base_resolution=c.base_resolution,
                    per_level_scale=c.per_level_scale)
        model = NGP(c, seed=tcfg.seed, device="cuda")
        x, g = tgi.random_input(device="cpu")
        out[f"random/{name}"] = dict(x=x, g=g, grid=grid,
                                     w1=model.sigma_mlp[0].detach().cpu(),
                                     fwd_x=tgi.random_x(device="cpu"),
                                     table=model.encode_table().cpu())
        del model
        system = tgi.fitted_system(tcfg)
        x, g, w1 = tgi.capture(system)
        out[f"train/{name}"] = dict(x=x.cpu(), g=g.cpu(), w1=w1.cpu(),
                                    grid=grid, fwd_x=x.cpu(),
                                    table=system.ngp.encode_table().cpu())
        del system, x, g, w1
        torch.cuda.empty_cache()
    torch.save(out, path)


def _fwd_turn(he, x, table, w1, spec, with_feats) -> dict:
    """The encode forward of one tree on one input: times and the larger
    of h1's and feats' error against the plain version, each of its max."""
    import torch
    from timing import device_split_ms, time_ms

    kernel = (he.hash_encode_fwd_cuda if spec.n_features == 4
              else he.hash_encode_fwd_f2_cuda)
    fk = torch.empty((x.shape[0], spec.out_dim), device="cuda")
    fp = torch.empty_like(fk)
    hk = kernel(x, table, w1, spec, fk)
    hp = he.hash_encode_fwd_plain(x, table, w1, spec, fp)
    error = max(float((hk - hp).abs().max() / hp.abs().max()),
                float((fk - fp).abs().max() / fp.abs().max()))
    del hk, hp, fp
    out = fk if with_feats else None
    call = lambda: kernel(x, table, w1, spec, out)
    kernel_dev, dev = device_split_ms(call, (FWD_DEVICE_NAME,))
    return dict(ms=time_ms(call), device_ms=dev, kernel_device_ms=kernel_dev,
                err_vs_f32_plain=error)


def _k9_turn() -> dict:
    """The six K9 variants of one tree on the bench's inputs, and beside
    K9-stream the PyTorch calls that compute its function."""
    import torch
    from bench_inputs import K9_BN, K9_N, k9_f32_rows, k9_inputs
    from timing import device_split_ms, time_ms

    from ngp_pl_torch.ops import encode_ablations as ea

    (rows, meta_T, w1big), _ = k9_inputs(K9_N, "cuda")
    f32_rows = k9_f32_rows(rows.shape, "cuda")
    out = {}
    for v in ea.VARIANTS:
        r = f32_rows if v in ("no_decode", "stream") else rows
        if v == "full_il":
            r = ea.interleave(r, K9_BN)
        kernel = ea.CUDA[v]
        got = kernel(r, meta_T, w1big, K9_BN)
        ref = ea.encode_ablation_plain(v, r, meta_T, w1big)
        error = max(float((a - b).abs().max() / b.abs().max())
                    if float(b.abs().max()) else float((a - b).abs().max())
                    for a, b in zip(got, ref))
        del got, ref
        call = lambda: kernel(r, meta_T, w1big, K9_BN)
        kernel_dev, dev = device_split_ms(call, (K9_DEVICE_NAME,))
        rec = dict(ms=time_ms(call), device_ms=dev,
                   kernel_device_ms=kernel_dev, err_vs_f32_plain=error)
        if v == "stream":
            shape = (r.shape[0], ea.F, r.shape[1])
            lib = lambda: (r.view(torch.float32).sum(0),
                           torch.zeros(shape, device="cuda"))
            rec.update(library_ms=time_ms(lib),
                       library_device_ms=device_split_ms(lib, None)[1])
        out[f"K9/{v}"] = rec
        del r
        torch.cuda.empty_cache()
    return out


def _k6_turn() -> dict:
    """K6 of one tree on its two inputs, and beside it `index_add_` with its
    zero fill."""
    import torch
    from bench_inputs import k6_runs, k6_uniform
    from timing import device_split_ms, time_ms

    from ngp_pl_torch.ops import scatter_rows as sr

    out = {}
    for name, make in (("uniform", k6_uniform), ("runs", k6_runs)):
        rows, idx, R = make("cuda")
        ref = sr.scatter_rows_plain(rows, idx, R)
        error = float((sr.scatter_rows_cuda(rows, idx, R) - ref).abs().max()
                      / ref.abs().max())
        del ref
        call = lambda: sr.scatter_rows_cuda(rows, idx, R)
        kernel_dev, dev = device_split_ms(call, (K6_DEVICE_NAME,))
        lib = lambda: torch.zeros((R, rows.shape[1]), device="cuda"
                                  ).index_add_(0, idx, rows)
        out[f"K6/{name}"] = dict(
            ms=time_ms(call), device_ms=dev, kernel_device_ms=kernel_dev,
            err_vs_f32_plain=error, library_ms=time_ms(lib),
            library_device_ms=device_split_ms(lib, None)[1])
        del rows, idx
        torch.cuda.empty_cache()
    return out


def turn(inputs_path: str, groups) -> dict:
    """One tree's times and errors, in a process whose sys.path starts with
    that tree (PYTHONPATH) after this file's own directory."""
    import torch
    from field_tail_gates import (K7_INPUTS, K8_INPUTS, k7_error, k8_error,
                                  model_weights, tail_inputs)
    from timing import device_ms, device_split_ms, time_ms

    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    out = {}
    if "k9" in groups:
        out.update(_k9_turn())
    if "k6" in groups:
        out.update(_k6_turn())
    ws = [w.cuda() for w in model_weights()]
    for key, sizes in (SIZES.items() if "field_tail" in groups else ()):
        for P in sizes:
            if key == "K7":
                inputs = tail_inputs(P, *K7_INPUTS)
                plain, kernel, err = (ft.field_tail_plain, ft.field_tail_cuda,
                                      k7_error)
            else:
                inputs = tail_inputs(P, *K8_INPUTS, grads=True)
                plain, kernel, err = (ft.field_tail_bwd_plain,
                                      ft.field_tail_bwd_cuda, k8_error)
            args = (*(t.cuda() for t in inputs), *ws)
            error = err(kernel(*args), plain(*args))
            call = lambda: kernel(*args)
            out[f"{key}/{P}"] = dict(ms=time_ms(call),
                                     device_ms=device_ms(call),
                                     err_vs_f32_plain=error)
            del args
            torch.cuda.empty_cache()
    encode = torch.load(inputs_path) if "encode" in groups else {}
    for name, inp in encode.items():
        spec = he.make_grid_spec(**inp["grid"])
        out[f"{FWD_KERNEL[spec.n_features]}/{name}"] = _fwd_turn(
            he, inp["fwd_x"].cuda(), inp["table"].cuda(), inp["w1"].cuda(),
            spec, with_feats=name.startswith("train/"))
        torch.cuda.empty_cache()
        x, g, w1 = (inp[k].cuda() for k in ("x", "g", "w1"))
        kernel = (he.hash_encode_bwd_cuda if spec.n_features == 4
                  else he.hash_encode_bwd_f2_cuda)
        ref = he.hash_encode_bwd_plain(x, g, w1, spec)
        error = float((kernel(x, g, w1, spec) - ref).abs().max()
                      / ref.abs().max())
        del ref
        call = lambda: kernel(x, g, w1, spec)
        kernel_dev, dev = device_split_ms(call, (BWD_DEVICE_NAME,))
        out[f"{BWD_KERNEL[spec.n_features]}/{name}"] = dict(
            ms=time_ms(call), device_ms=dev, kernel_device_ms=kernel_dev,
            err_vs_f32_plain=error)
        torch.cuda.empty_cache()
    return out


def _work(inputs_path: str, groups) -> dict:
    """Bytes and operations of each input, as chip_smoke.py counts them.
    The table gradient: x and g in, w1, the f32 table gradient out; the
    d_wr contraction in bf16, the corner weights, products and additions
    in f32.  The encode forward: `roofline.k1_work` on its x.  K9:
    `micro_fwd.variant_work`.  K6: rows and indices in, the output written
    once, one f32 addition per input float."""
    import torch

    from ngp_pl_torch.benchmarking import bench_inputs as bi
    from ngp_pl_torch.benchmarking.micro_fwd import variant_work
    from ngp_pl_torch.benchmarking.roofline import k1_work
    from ngp_pl_torch.ops import encode_ablations as ea
    from ngp_pl_torch.ops import hash_encoding as he

    work = {}
    if "k9" in groups:
        for v in ea.VARIANTS:
            work[f"K9/{v}"] = (*variant_work(v, bi.K9_LEVELS, bi.K9_N),
                               bi.K9_N)
    if "k6" in groups:
        for name, (P, W, R) in (("uniform", bi.K6_UNIFORM),
                                ("runs", bi.K6_RUNS[:3])):
            work[f"K6/{name}"] = (P * W * 4 + P * 8 + R * W * 4, 0.0,
                                  float(P * W), P)
    encode = torch.load(inputs_path) if "encode" in groups else {}
    for name, inp in encode.items():
        spec = he.make_grid_spec(**inp["grid"])
        nbytes, contraction, interp, _ = k1_work(
            inp["fwd_x"], spec, inp["table"], inp["w1"],
            feats=name.startswith("train/"))
        work[f"{FWD_KERNEL[spec.n_features]}/{name}"] = (
            nbytes, contraction, interp, inp["fwd_x"].shape[0])
        N = inp["x"].shape[0]
        nbytes = (N * 12 + N * 64 * 4 + inp["w1"].numel() * 4
                  + spec.total_rows * spec.row_width * 4)
        contraction = 2.0 * N * spec.n_levels * spec.n_features * 64
        rest = N * spec.n_levels * (8 * 2 + 8 * spec.n_features * 2)
        work[f"{BWD_KERNEL[spec.n_features]}/{name}"] = (nbytes, contraction,
                                                         float(rest), N)
    return work


def _record(key, t, trees, card, bound_ms, bound_by, **extra) -> dict:
    clocks = [c for c in ("ms", "device_ms", "kernel_device_ms", "library_ms",
                          "library_device_ms") if c in t[0]]
    if "kernel_device_ms" in t[0]:
        extra["kernel_device_speedup"] = (
            (t[0]["kernel_device_ms"] + t[3]["kernel_device_ms"])
            / (t[1]["kernel_device_ms"] + t[2]["kernel_device_ms"]))
    return dict(kernel=key, card=card, first=str(trees[0]),
                second=str(trees[1]), **extra,
                **{f"{which}{clock}": [t[i][clock] for i in idx]
                   for which, idx in (("first_", (0, 3)), ("second_", (1, 2)))
                   for clock in clocks},
                speedup=(t[0]["ms"] + t[3]["ms"]) / (t[1]["ms"] + t[2]["ms"]),
                device_speedup=((t[0]["device_ms"] + t[3]["device_ms"])
                                / (t[1]["device_ms"] + t[2]["device_ms"])),
                err_vs_f32_plain=[r["err_vs_f32_plain"] for r in t],
                bound_ms=bound_ms, bound_by=bound_by,
                **{f"{which}bound_share": [bound_ms / t[i]["device_ms"]
                                           for i in idx]
                   for which, idx in (("first_", (0, 3)),
                                      ("second_", (1, 2)))})


def run(first: Path, second: Path, emit=print, groups=GROUPS) -> list:
    from ngp_pl_torch import _build
    from ngp_pl_torch.benchmarking.roofline import bound

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    trees = (first.resolve(), second.resolve())
    scratch = _build.BUILD_DIR.parent
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        inputs_path = os.path.join(tmp, "encode_inputs.pt")
        if "encode" in groups:
            make_inputs(Path(inputs_path))
        turns = []
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            env = dict(os.environ, PYTHONPATH=str(tree))
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--turn", inputs_path, "--groups",
                                   ",".join(groups)], cwd=tree, env=env,
                                  text=True, capture_output=True)
            if proc.returncode:
                raise RuntimeError(f"the turn of {tree} failed:\n"
                                   f"{proc.stderr}")
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        work = _work(inputs_path, groups)
    # bytes and multiply-adds as chip_smoke.py counts them (weights 7,360)
    n_w = 16 * 64 + 32 * 64 + 64 * 64 + 64 * 3
    records = []
    for key, sizes in (SIZES.items() if "field_tail" in groups else ()):
        for P in sizes:
            t = [r[f"{key}/{P}"] for r in turns]
            if key == "K7":
                nbytes, macs = P * (64 * 4 + 16 * 4 + 16) + 4 * n_w, n_w
            else:
                nbytes = P * (64 + 16 + 1 + 3 + 64) * 4 + 8 * n_w
                macs = 2 * n_w + 192 + 4096 + 2048
            records.append(_record(key, t, trees, card,
                                   *bound(nbytes, 2.0 * P * macs, 0.0), n=P))
    for name, (nbytes, contraction, rest, N) in work.items():
        t = [r[name] for r in turns]
        key, inp = name.split("/", 1)
        records.append(_record(key, t, trees, card,
                               *bound(nbytes, contraction, rest), input=inp,
                               n=N))
    for rec in records:
        emit(json.dumps(rec))
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("first", type=Path, nargs="?",
                    help="root of the tree timed first and last")
    ap.add_argument("second", type=Path, nargs="?",
                    help="root of the tree timed in the middle turns")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help=f"comma-separated, of {', '.join(GROUPS)}")
    ap.add_argument("--turn", metavar="INPUTS",
                    help="time the tree on sys.path on these encode inputs "
                    "(internal)")
    args = ap.parse_args(argv)
    groups = tuple(g for g in args.groups.split(",") if g)
    if not groups or set(groups) - set(GROUPS):
        ap.error(f"--groups: pick from {', '.join(GROUPS)}")
    if args.turn:
        print(json.dumps(turn(args.turn, groups)), flush=True)
        return []
    if args.first is None or args.second is None:
        ap.error("give the roots of two trees")
    return run(args.first, args.second, groups=groups)


if __name__ == "__main__":
    main()
