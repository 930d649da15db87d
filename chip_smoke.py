#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and exits non-zero:
  device   the card, its power limit (nvidia-smi), torch and CUDA versions
  build    nvcc builds every kernel of the port from ngp_pl_torch/csrc
  kernels  each kernel against its plain PyTorch version at the shapes of
           the paths: max error and tolerance, median time over CUDA
           events, the plain version's time and the least time the card
           could take (bytes over 3.35 TB/s or operations over peak rate);
           K1 and K2+K5 at 262,144 random points of the flagship grid, K3
           and K4 at 262,144 of the L16F2 grid (all four also by device
           time, the table gradient's zero fill apart, with the share of
           the bound, and again on the input of a train step after each
           fit, see below), K7 at
           1,048,576 samples,
           K8 at 262,144 (both also against their plain versions with
           float64 sums, and at the train pool's 393,216), K6 at 262,144
           rows of 128 into 16,384 and on the JAX scatter bench's runs of
           74 equal indices (327,680 rows into 512; both by device time,
           the zero fill apart, and against Tensor.index_add_ on both
           clocks), and the six K9 variants at the K9 bench's 196,608
           samples (by device time too, with the share of the bound; the
           plain versions timed there too)
  micro_fwd  the K9 bench's entry point (ngp_pl_torch.benchmarking.micro_fwd,
           interleaved rows too): one line per row with its time, bound and
           launches, K1 at the same N beside them; every variant must launch
  slice    ngp_pl_torch.eval on the synthetic scene at 800x800 with the seeded
           flagship model (L=8, F=4, T=2^19, grid 128^3): occupancy grid from
           the train cameras plus one warmup refresh, two test views through
           the round renderer, PSNR/SSIM, FPS, samples/ray, rounds; K1 and
           K7 must launch during this run
  ckpt     slim checkpoint in the JAX key format, reloaded through the entry
           point: the re-render must be identical
  reference  a crop of rays rendered with the kernels on the card and with
           the plain versions on the CPU must agree
  profile  one more frame under torch.profiler: device time by kernel and
           the device's idle share
  train_reference  one train step of the seeded flagship model on
           bench.py's scene (8 views at 96x96) with the kernels on the card,
           against the CPU's plain path and against the plain versions on
           the card: same pool, loss and gradients agree; beside them each
           kernel alone, the others run as their plain versions
  train    NeRFSystem.fit of that model, batch 8192, 512 steps in 16-step
           blocks: loss finite and falling, skipped steps, rays/s over the
           last 8 blocks, pool and chain; K1, K7, K2+K5 and K8 must all
           launch; then train_reference again from the trained state on
           4 batches, each beside two witnesses against the CPU: the card's
           step with K7, and with every kernel, run as its plain version
  trained_render  test view 0 at 800x800 of the trained field: FPS,
           samples/ray, rounds, PSNR
  profile  one more 16-step block under torch.profiler: K1, K7, K2+K5, K8,
           the PyTorch kernels around them and the device's idle share
  kernels  (input train_step) K1 and K2+K5 on the (x, g, w1) the table
           gradient's wrapper receives in one more train step: the
           393,216-slot pool, ray by ray, zero rows on unused slots; K1 on
           that x with the fitted table, called with feats as the train
           step calls it; checked and timed as at random points
All of the train phases (train_reference, train, train_reference again,
trained_render, profile, kernels) again in the strided layout
(`_strided`: 8192 rays x S slots, the invalid ones at their ray's origin;
K1 and K2+K5 on its train step's input) and in rounds with the distortion
loss at 1e-2 (`_rounds`: four rounds of 8192, 4096, 2048 and 1024 slots
each step, no kernels phase), trained from the seed and each
step held to the CSR path's limits; each fit also logs every 16-step
block: layout, S, chain, the share of the batch left out of the loss,
samples per ray marched and composited, rays alive after the last round
and the rounds' slots.
Then the same for the reference's own geometry, L16F2 (L=16, F=2, T=2^19,
the f32 table read by K3, its gradient by K4): slice_l16f2 (one view; K3
and K7 must launch), ckpt_l16f2, train_reference_l16f2 (seeded; K3 and K4
each alone held to the step's limits, the whole step to STEP_TOL_L16F2),
train_l16f2 (512 steps; K3, K4, K7 and K8 must launch),
train_reference_l16f2 from the trained state on 2 batches,
trained_render_l16f2, a profiled block and K3 and K4 on a train step's
input.
Then the card line, the kernels line (the seven kernels of the paths and
the six K9 variants, with their launches on each path) and, last, the
result line.  Without a CUDA device,
or run outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances of each kernel against its plain version, with the reason.
# K1 and K3 round where the plain version does (bf16 weighted row values,
# bf16 w1, and at F=4 bf16 corner weights); only the f32 summation order
# differs.
K1_TOL = 1e-5                  # max |h1 - plain| / max |plain|, also K3
# K7 and K8 are each held against two plain versions on the same inputs:
# the f32 one (the TPU's numerics, which the CPU tests tie to the JAX
# package) and the same math with float64 sums, which no summation order
# can change.  The tensor cores sum exact bf16 products in another order
# than an f32 chain, so an activation can land on the other side of a bf16
# rounding step: one bf16 ulp (2^-8 relative) of one hidden unit moves rgb
# by ~1e-3.  The f32 plain version's own sums flip such steps too, so its
# miss of its float64 twin is what a correct kernel may read against it.
# Each limit lies above that miss and below what wrong kernels read: the
# plain math with one fault each, on these inputs (CPU readings of
# ngp_pl_torch/benchmarking/field_tail_gates.py, in PERF.md).
# K7: the f32 plain version misses float64 sums by 3.52e-3 at 1,048,576
# samples; an f16-rounded r2 reads 5.6e-3, an unrounded h 1.1e-2.
K7_TOL = 4e-3                  # max |rgb - plain| and max |log sigma - plain|,
#                                against both plain versions
# The table-gradient kernels (K2 + K5, K4) round where their plain version
# does (bf16 g and w1, bf16 products, and at F=4 bf16 corner weights); the
# f32 atomics add in another order, and a feature gradient that differs in
# its last bit can round one product to the other bf16 neighbour (2^-8 of
# one term).
K2_TOL = 1e-5                  # max |d_table - plain| / max |plain|, also K4
# K8, per output, of its largest magnitude.  The f32 plain version misses
# float64 sums by 4.47e-3 of max |dWr2| at 262,144 samples (the 64 rows of
# h1 x20 put |h| in the hundreds and flip bf16(h)), and by 4.2e-5 at
# 393,216.  Against it the limit catches a skipped tile of 128 samples
# (3.6e-2), an unrounded h (6.3e-2), a missing mask or TruncExp term
# (>= 0.94); the subtler faults, one sample skipped (4.8e-3) or an
# unrounded d_z3 (4.9e-3), only the float64 gate catches (an f32-pipe
# kernel read 8.5e-5 against the f32 plain version).
K8_TOL = 1e-3                  # per output: max |x - plain| / max |plain|
K8_F32_TOL = 1e-2              # the same against the f32 plain version
K6_TOL = 1e-5                  # f32 atomics in another order, relative
# K9 rounds where its plain version does (bf16 weighted row values, bf16
# w1); the tensor cores sum the exact bf16 products in f32 in another order
# than the plain matmuls.
K9_TOL = 1e-5                  # max |x - plain| / max |plain|, h1 and ft2
# One train step with the kernels on the card, against the CPU's plain path
# and against the plain versions run on the card; each limit is (loss
# relative, gradient per parameter of its largest).  From the seeded state:
# the tolerances of tests/test_torch_train.py::
# test_one_train_step_matches_jax for both.  From the trained state the
# card's step with no kernel at all disagrees with the CPU as much as the
# kernels' step does (up to 1.1e-4 / 9.9e-3 on the H100; its PyTorch ops
# sum in another order, and the small gradients of a fitted field cancel
# over many samples), so that limit is ~3-5x the largest reading of the
# kernels' step (1.04e-4 / 1.01e-2); against the plain versions on the card
# it is ~5x the largest (1.5e-5 / 9.2e-4); the readings are in PERF.md.
STEP_TOL = (1e-5, 2e-3)
TRAINED_CPU_TOL = (5e-4, 3e-2)
TRAINED_KERNEL_TOL = (1e-4, 5e-3)
# L16F2 from the seeded state: K8 alone (K3, K4 and K7 run as their plain
# versions) moves the table gradient by 3.7e-3 of its max against the plain
# versions on the card, as much as all four kernels do, while K3 alone and
# K4 alone move it by 1.9e-4 each (H100, `alone_vs_plain_on_card`;
# PERF.md).  So the whole step is held to 1e-2 there (2.7x that reading)
# and K3 and K4, each alone, to STEP_TOL.
STEP_TOL_L16F2 = (1e-5, 1e-2)
# The strided and rounds steps from the seeded state, against the CPU: in
# grid warmup they leave ~90% of the batch out of the loss, and the rest
# are rays through empty space, whose opacity 1 - exp(-sigma delta) (sigma
# delta ~1e-3) cancels; the card's exp differs from the CPU's in the last
# bit, so the loss (~8e-6) moves by ~2e-5 of itself with every hand kernel
# replaced by its plain version (the H100, `witness_all_plain_vs_cpu`;
# PERF.md).  So that comparison takes the trained-state limit; the
# kernels are held to STEP_TOL against the plain versions on the card.
SEEDED_MASKED_CPU_TOL = TRAINED_CPU_TOL
# ROUNDS_NOTE: from the seed the rounds layout does not train on bench.py's
# scene (~85% of each batch is out of the loss, PERF.md), so after its fit
# the loss is ~1e-10, made of rays through empty space; there the card's
# step with no hand kernel misses the CPU's by ~50% of the loss (H100), and
# `train_reference` holds that state by `cpu_floor_by_witness`.
TRAINED_BATCHES = (7, 8, 9, 10)   # seeds of the trained-state batches
TRAINED_BATCHES_L16F2 = (7, 8)
TRAINED_BATCHES_LAYOUTS = (7,)     # the strided and rounds paths
TRAIN_STEPS = 512              # 32 blocks: 16 warmup refreshes, then phases
K7_N = 1048576                 # K7's samples in the kernels phase
K8_N = 262144                  # K8's
POOL_N = 8192 * 48             # the train pool at x48, both kernels again


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_fwd(torch, ngp, key):
    """K1 (F=4) or K3 (F=2), by `key`, at 262,144 random points of the
    model's grid, reading the table the encode reads; timed without feats,
    as the render path calls it."""
    from ngp_pl_torch.benchmarking.table_grad_inputs import random_x

    return _fwd_record(torch, key, random_x(), ngp.encode_table(),
                       ngp.sigma_mlp[0].detach(), ngp.spec, with_feats=False)


def _fwd_record(torch, key, x, table, w1, spec, with_feats):
    """The encode kernel `key` on (x, table, w1) against its plain version
    on the same inputs, h1 and feats each within K1_TOL of their max; the
    wrapper's event time and the kernel's device time, called with feats
    (as `HashEncodeMLP.forward` calls it) when `with_feats`, the plain
    version's time and the bound (`roofline.k1_work` on this x)."""
    from ngp_pl_torch.benchmarking.roofline import bound, k1_work
    from ngp_pl_torch.benchmarking.timing import device_ms, time_ms
    from ngp_pl_torch.ops import hash_encoding as he

    wrapper = _counters()[key]
    N = x.shape[0]
    feats_k = torch.empty((N, spec.out_dim), device="cuda")
    feats_p = torch.empty((N, spec.out_dim), device="cuda")
    h_k = wrapper(x, table, w1, spec, feats_k)
    torch.cuda.synchronize()
    h_p = he.hash_encode_fwd_plain(x, table, w1, spec, feats_p)
    scale = float(h_p.abs().max())
    err = float((h_k - h_p).abs().max())
    feat_scale = float(feats_p.abs().max())
    feat_err = float((feats_k - feats_p).abs().max())
    if not (err <= K1_TOL * scale and feat_err <= K1_TOL * feat_scale):
        raise AssertionError(f"{key} disagrees: {err} (scale {scale}), "
                             f"feats {feat_err} (scale {feat_scale})")
    del h_k, h_p, feats_p
    out = feats_k if with_feats else None
    call = lambda: wrapper(x, table, w1, spec, out)
    ms = time_ms(call)
    dev_ms = device_ms(call, (KERNEL_NAMES[key],))
    plain_ms = time_ms(lambda: he.hash_encode_fwd_plain(x, table, w1, spec,
                                                        out))
    # bytes: x in, h1 (and feats) out, w1 and the table points read
    nbytes, contraction, interp, points = k1_work(x, spec, table, w1,
                                                  feats=with_feats)
    bound_ms, bound_by = bound(nbytes, contraction, interp)
    rows = int(torch.unique(he.slots_local_frac_lm(x.clamp(0.0, 1.0),
                                                   spec)[0]).numel())
    return dict(max_abs_err=err, max_rel_err=err / scale, tol_rel=K1_TOL,
                feats_max_abs_err=feat_err,
                feats_max_rel_err=feat_err / feat_scale, with_feats=with_feats,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / dev_ms, n=N, table_rows_touched=rows,
                table_points_touched=points,
                table_bytes=table.numel() * table.element_size(),
                bytes=nbytes, flops=contraction + interp)


def check_k7(torch, ngp):
    """K7 at the render chunk's 1,048,576 samples and at the train pool's
    393,216 (batch 8192 x 48): error against both plain versions (f32 sums
    and float64 sums), times (the wrapper's CUDA-event time, and the
    kernel's device time alone) and bound at both."""
    from ngp_pl_torch.benchmarking.field_tail_gates import (K7_INPUTS,
                                                            k7_error,
                                                            tail_inputs)
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_ms, time_ms
    from ngp_pl_torch.ops import field_tail as ft

    ws = [ngp.sigma_mlp[1].detach()] + [w.detach() for w in ngp.rgb_mlp]
    out = {}
    for P in (K7_N, POOL_N):
        h1, sh = (t.cuda() for t in tail_inputs(P, *K7_INPUTS))
        got = ft.field_tail_cuda(h1, sh, *ws)
        torch.cuda.synchronize()
        err = k7_error(got, ft.field_tail_plain(h1, sh, *ws))
        err64 = k7_error(got, ft.field_tail_plain(h1, sh, *ws,
                                                  acc=torch.float64))
        if not (err <= K7_TOL and err64 <= K7_TOL):
            raise AssertionError(f"K7 disagrees at P={P}: {err} against "
                                 f"the f32 plain version, {err64} against "
                                 f"float64 sums")
        del got
        ms = time_ms(lambda: ft.field_tail_cuda(h1, sh, *ws))
        dev_ms = device_ms(lambda: ft.field_tail_cuda(h1, sh, *ws),
                           (KERNEL_NAMES["K7"],))
        plain_ms = time_ms(lambda: ft.field_tail_plain(h1, sh, *ws))
        nbytes = P * (64 * 4 + 16 * 4 + 4 + 12) + sum(w.numel() for w in ws) * 4
        flops = 2.0 * P * sum(w.shape[0] * w.shape[1] for w in ws)
        bound_ms, bound_by = bound(nbytes, flops, 0.0)
        out[P] = dict(max_abs_err=err, tol_abs=K7_TOL,
                      max_abs_err_vs_float64_sums=err64, ms=ms,
                      device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, bound_share=bound_ms / dev_ms, n=P,
                      bytes=nbytes, flops=flops)
        del h1, sh
        torch.cuda.empty_cache()
    return dict(out[K7_N], at_train_pool=out[POOL_N])


def check_bwd(torch, ngp, key):
    """The table-gradient kernel, K2 fused with the K5 scatter (F=4) or K4
    fused with the per-level scatter-add (F=2), by `key`, at 262,144
    random points of the model's grid."""
    from ngp_pl_torch.benchmarking.table_grad_inputs import random_input

    x, gr = random_input()
    return _bwd_record(torch, key, x, gr, ngp.sigma_mlp[0].detach(),
                       ngp.spec)


def _bwd_record(torch, key, x, gr, w1, spec):
    """The table-gradient kernel `key` on (x, gr, w1) against its plain
    version on the same inputs (K2_TOL of max); the wrapper's event time,
    the device time of the whole call and, from the same profile, of the
    kernel and of the gradient's zero fill apart, the plain version's time
    and the bound, whose share is of the whole call: the bound counts the
    gradient written once, which is the fill's write."""
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_split_ms, time_ms
    from ngp_pl_torch.ops import hash_encoding as he

    wrapper = _counters()[key]
    N = x.shape[0]
    d_k = wrapper(x, gr, w1, spec)
    torch.cuda.synchronize()
    d_p = he.hash_encode_bwd_plain(x, gr, w1, spec)
    scale = float(d_p.abs().max())
    err = float((d_k - d_p).abs().max())
    if not err <= K2_TOL * scale:
        raise AssertionError(f"{key} disagrees: {err} (scale {scale})")
    del d_k, d_p
    call = lambda: wrapper(x, gr, w1, spec)
    ms = time_ms(call)
    dev_ms, call_dev_ms = device_split_ms(call, (KERNEL_NAMES[key],))
    plain_ms = time_ms(lambda: he.hash_encode_bwd_plain(x, gr, w1, spec))
    # bytes: x and g in, w1, the f32 table gradient out (every row)
    nbytes = (N * 12 + N * 64 * 4 + w1.numel() * 4
              + spec.total_rows * spec.row_width * 4)
    LF = spec.n_levels * spec.n_features
    contraction = 2.0 * N * LF * 64              # d_wr: bf16 operands
    # per sample and level: 8 corner weights (2 products), 8 x F products
    # and the 8 x F additions into the table
    rest = N * spec.n_levels * (8 * 2 + 8 * spec.n_features * 2)
    bound_ms, bound_by = bound(nbytes, contraction, rest)
    return dict(max_abs_err=err, max_rel_err=err / scale, tol_rel=K2_TOL,
                ms=ms, device_ms=dev_ms, fill_ms=call_dev_ms - dev_ms,
                call_device_ms=call_dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / call_dev_ms, n=N,
                nonzero_rows=int((gr != 0).any(dim=1).sum()),
                bytes=nbytes, flops=contraction + rest)


def check_k8(torch, ngp):
    """K8 at 262,144 samples and at the train pool's 393,216: dh1 and the
    four weight gradients against both plain versions (f32 sums, float64
    sums), times and bound at both."""
    from ngp_pl_torch.benchmarking.field_tail_gates import (K8_INPUTS,
                                                            tail_inputs)
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_ms, time_ms
    from ngp_pl_torch.ops import field_tail as ft

    ws = [ngp.sigma_mlp[1].detach()] + [w.detach() for w in ngp.rgb_mlp]
    names = ("dh1", "dW2", "dWr1", "dWr2", "dWr3")
    out = {}
    for P in (K8_N, POOL_N):
        args = (*(t.cuda() for t in tail_inputs(P, *K8_INPUTS, grads=True)),
                *ws)
        got = ft.field_tail_bwd_cuda(*args)
        torch.cuda.synchronize()

        def errs(ref):
            return ({n: float((a - b).abs().max())
                     for n, a, b in zip(names, got, ref)},
                    {n: float((a - b).abs().max() / b.abs().max())
                     for n, a, b in zip(names, got, ref)})

        abs_err, rel_err = errs(ft.field_tail_bwd_plain(*args))
        _, rel64 = errs(ft.field_tail_bwd_plain(*args, acc=torch.float64))
        if not (max(rel_err.values()) <= K8_F32_TOL
                and max(rel64.values()) <= K8_TOL):
            raise AssertionError(f"K8 disagrees at P={P}: {rel_err} against "
                                 f"the f32 plain version, {rel64} against "
                                 f"float64 sums")
        del got
        ms = time_ms(lambda: ft.field_tail_bwd_cuda(*args))
        dev_ms = device_ms(lambda: ft.field_tail_bwd_cuda(*args),
                           (KERNEL_NAMES["K8"], "field_tail_bwd_reduce"))
        plain_ms = time_ms(lambda: ft.field_tail_bwd_plain(*args))
        nbytes = (P * (64 + 16 + 1 + 3 + 64) * 4
                  + 2 * sum(w.numel() for w in ws) * 4)
        # multiply-adds per sample: the forward (7,360), the backward
        # through the layers (192 + 4,096 + 1,024 + 1,024) and the weight
        # gradients (7,360), all bf16 operands
        macs = 2 * sum(w.shape[0] * w.shape[1] for w in ws) + 192 + 4096 + 2048
        flops = 2.0 * P * macs
        bound_ms, bound_by = bound(nbytes, flops, 0.0)
        out[P] = dict(max_abs_err=max(abs_err.values()), abs_err=abs_err,
                      max_rel_err=max(rel_err.values()), rel_err=rel_err,
                      tol_rel=K8_F32_TOL,
                      max_rel_err_vs_float64_sums=max(rel64.values()),
                      rel_err_vs_float64_sums=rel64,
                      tol_rel_vs_float64_sums=K8_TOL, ms=ms,
                      device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, bound_share=bound_ms / dev_ms, n=P,
                      bytes=nbytes, flops=flops)
        del args
        torch.cuda.empty_cache()
    return dict(out[K8_N], at_train_pool=out[POOL_N])


def check_k6(torch):
    """K6 on two inputs (`bench_inputs`): 262,144 rows of 128 floats into
    16,384 at uniform random indices, and the JAX scatter bench's
    ray-coherent runs (74 equal indices in a row, 327,680 rows into 512,
    the worst contention).  Each against its plain version; the wrapper's
    event time, the device time of the kernel and of the whole call (the
    output's zero fill included, which the bound's share counts: the bound
    counts the output written once), and `Tensor.index_add_` with its zero
    fill, the one PyTorch call that computes the same function, on both
    clocks.  The uniform input's record, with the runs' under `at_runs`."""
    from ngp_pl_torch.benchmarking import bench_inputs as bi
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_split_ms, time_ms
    from ngp_pl_torch.ops import scatter_rows as sr

    out = {}
    for name, make in (("uniform", bi.k6_uniform), ("runs", bi.k6_runs)):
        rows, idx, R = make("cuda")
        P, W = rows.shape
        out_k = sr.scatter_rows_cuda(rows, idx, R)
        torch.cuda.synchronize()
        out_p = sr.scatter_rows_plain(rows, idx, R)
        scale = float(out_p.abs().max())
        err = float((out_k - out_p).abs().max())
        if not err <= K6_TOL * scale:
            raise AssertionError(f"K6 disagrees on {name}: {err} "
                                 f"(scale {scale})")
        del out_k, out_p
        call = lambda: sr.scatter_rows_cuda(rows, idx, R)
        ms = time_ms(call)
        dev_ms, call_dev_ms = device_split_ms(call, (KERNEL_NAMES["K6"],))
        plain_ms = time_ms(lambda: sr.scatter_rows_plain(rows, idx, R))
        lib = lambda: torch.zeros((R, W), device="cuda").index_add_(0, idx,
                                                                    rows)
        library_ms = time_ms(lib)
        library_device_ms = device_split_ms(lib, None)[1]
        nbytes = P * W * 4 + P * 8 + R * W * 4
        bound_ms, bound_by = bound(nbytes, 0.0, float(P * W))
        out[name] = dict(max_abs_err=err, max_rel_err=err / scale,
                         tol_rel=K6_TOL, ms=ms, device_ms=dev_ms,
                         fill_ms=call_dev_ms - dev_ms,
                         call_device_ms=call_dev_ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         library_device_ms=library_device_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_share=bound_ms / call_dev_ms, n=P, w=W,
                         n_rows=R, runs=int((idx[1:] != idx[:-1]).sum()) + 1,
                         bytes=nbytes)
        del rows, idx
        torch.cuda.empty_cache()
    return dict(out["uniform"], input="uniform", at_runs=out["runs"])


def check_k9(torch):
    """Each K9 variant against its plain version at the bench's N=196,608,
    L=8: the bench's random rows, except for no_decode and stream, which
    read the rows' bits as f32 and would meet the inf and NaN patterns in
    them (u >= 0x7F800000, 1/256 of the words); they get the bits of f32
    U(-2, 2).  Returns, by variant, the errors, the kernels' device time
    (rows cold: 402.7 MB, past the L2) with the bound's share of it, and
    the plain version's time on the same inputs; for stream, which
    contracts nothing, also both times of the PyTorch calls that compute
    its function (the sum over levels of the rows as f32, and ft2's
    zeros)."""
    from ngp_pl_torch.benchmarking import bench_inputs as bi
    from ngp_pl_torch.benchmarking import micro_fwd as mf
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_split_ms, time_ms
    from ngp_pl_torch.ops import encode_ablations as ea

    n = mf.N_BENCH
    (rows, meta_T, w1big), _ = bi.k9_inputs(n, "cuda", mf.L)
    f32_rows = bi.k9_f32_rows(rows.shape, "cuda")
    out = {}
    for v in ea.VARIANTS:
        r = f32_rows if v in ("no_decode", "stream") else rows
        if v == "full_il":
            r = ea.interleave(r, mf.BN)
        got = ea.CUDA[v](r, meta_T, w1big, mf.BN)
        torch.cuda.synchronize()
        ref = ea.encode_ablation_plain(v, r, meta_T, w1big)
        err = {name: float((a - b).abs().max())
               for name, a, b in zip(("h1", "ft2"), got, ref)}
        scale = {name: float(b.abs().max())
                 for name, b in zip(("h1", "ft2"), ref)}
        if not all(math.isfinite(e) and e <= K9_TOL * scale[k]
                   for k, e in err.items()):
            raise AssertionError(f"K9 {v} disagrees: {err} (scale {scale})")
        del got, ref
        dev_ms, call_dev_ms = device_split_ms(
            lambda: ea.CUDA[v](r, meta_T, w1big, mf.BN),
            (KERNEL_NAMES["K9"],))
        bound_ms, bound_by = bound(*mf.variant_work(v, mf.L, n))
        plain_ms = time_ms(lambda: ea.encode_ablation_plain(v, r, meta_T,
                                                            w1big),
                           runs=5, warmup=1)
        out[v] = dict(max_abs_err=max(err.values()), abs_err=err,
                      max_rel_err=max(err[k] / scale[k] if scale[k] else 0.0
                                      for k in err),
                      tol_rel=K9_TOL, device_ms=dev_ms,
                      call_device_ms=call_dev_ms, bound_ms=bound_ms,
                      bound_by=bound_by, bound_share=bound_ms / call_dev_ms,
                      plain_ms=plain_ms, n=n,
                      rows="f32 U(-2, 2) bits" if v in ("no_decode", "stream")
                      else "the bench's random u32")
        if v == "stream":
            ft2_shape = (r.shape[0], ea.F, r.shape[1])
            lib = lambda: (r.view(torch.float32).sum(0),
                           torch.zeros(ft2_shape, device="cuda"))
            out[v]["library_ms"] = time_ms(lib)
            out[v]["library_device_ms"] = device_split_ms(lib, None)[1]
        del r
        torch.cuda.empty_cache()
    return out


def micro_fwd_path(torch, card):
    """The K9 bench's entry point (`micro_fwd.run`, interleaved rows too)
    with the counts from 0 just before and read just after: every variant
    must launch.  Returns its records by row and the launches."""
    from ngp_pl_torch.benchmarking import micro_fwd as mf
    from ngp_pl_torch.ops import encode_ablations as ea

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    records = mf.run(device="cuda", interleaved=True,
                     emit=lambda rec: log({"phase": "micro_fwd", "card": card,
                                           **rec}))
    launches = {k: c.launches for k, c in counters.items()}
    if not all(ea.CUDA[v].launches > 0 for v in ea.VARIANTS):
        raise AssertionError(f"a K9 variant did not launch: {launches}")
    torch.cuda.empty_cache()
    return {r["row"]: r for r in records}, launches


def reference_crop(torch, res, tcfg, n_rays: int = 1024):
    """A crop of view 0 rendered with the kernels and with the plain versions
    on the CPU, same parameters and grid.  Tolerance: each sample's rgb is
    within K7_TOL of the plain one and a ray's weights sum to at most 1, so
    a pixel moves by at most K7_TOL plus the effect of sigma's 1e-5."""
    from ngp_pl_torch.datasets import dataset_dict
    from ngp_pl_torch.models.ngp import NGP
    from ngp_pl_torch.models.rendering import RoundRenderer

    ds = dataset_dict["synthetic"](split="test", downsample=tcfg.downsample,
                                   device="cpu")
    pose = torch.from_numpy(ds.poses[0])
    w = ds.img_wh[0]
    rows = torch.arange(w // 2 - 16, w // 2 + 16)
    pix = (rows[:, None] * w + torch.arange(w // 2 - n_rays // 64,
                                            w // 2 + n_rays // 64)).reshape(-1)
    rd = torch.from_numpy(ds.directions)[pix] @ pose[:, :3].T
    ro = pose[:, 3].expand(rd.shape).contiguous()
    cpu_ngp = NGP(tcfg.ngp_config(), device="cpu")
    cpu_ngp.load_params(res.ngp.params_numpy())
    outs = []
    for model, dev in ((res.ngp, "cuda"), (cpu_ngp, "cpu")):
        r = RoundRenderer(model, tcfg.render_config())
        outs.append(r.render_image(res.occ_grid.to(dev), ro.to(dev),
                                   rd.to(dev)))
    gpu, cpu = outs
    err = {k: float((gpu[k].cpu() - cpu[k]).abs().max())
           for k in ("rgb", "opacity")}
    tol = 5e-3
    if not all(v <= tol for v in err.values()):
        raise AssertionError(f"card vs CPU render disagrees: {err}")
    return dict(rays=int(pix.numel()), max_abs_err=err, tol=tol,
                samples_card=gpu["total_samples"],
                samples_cpu=cpu["total_samples"])


def _device_kernels(prof):
    """(ms, count, name) of each kernel the profiler saw on the device,
    largest first; op rows, which repeat their kernels' time, are left
    out."""
    from torch.autograd import DeviceType

    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key))
    return sorted(kernels, reverse=True)


def profile_frame(torch, res, tcfg, top: int = 12):
    """One more 800x800 frame of view 0 under torch.profiler: device time by
    kernel, grouped into K1, K7 and the PyTorch kernels around them, and the
    device's idle share against the unprofiled frame time (1 / FPS)."""
    from torch.profiler import ProfilerActivity, profile

    from ngp_pl_torch.datasets import dataset_dict
    from ngp_pl_torch.models.rendering import RoundRenderer

    ds = dataset_dict["synthetic"](split="test", downsample=tcfg.downsample,
                                   device="cuda")
    dirs = torch.from_numpy(ds.directions).cuda()
    pose = torch.from_numpy(ds.poses[0]).cuda()
    renderer = RoundRenderer(res.ngp, tcfg.render_config())
    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = renderer.render_pose(res.occ_grid, dirs, pose)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    k1 = sum(k[0] for k in kernels if KERNEL_NAMES["K1"] in k[2])
    k7 = sum(k[0] for k in kernels if KERNEL_NAMES["K7"] in k[2])
    _timed_where_launched(counters, before, {"K1": k1, "K7": k7})
    frame_ms = 1e3 / res.fps
    return dict(
        frame_ms_unprofiled=frame_ms, frame_ms_profiled=wall * 1e3,
        device_busy_ms=busy, idle_share=1.0 - busy / frame_ms,
        k1_ms=k1, k7_ms=k7, other_kernels_ms=busy - k1 - k7,
        rounds=out["rounds"], samples=out["total_samples"],
        top=[{"ms": ms, "count": n, "name": name[:90]}
             for ms, n, name in kernels[:top]])


# The device kernel each hand kernel's wrapper launches, as the profiler
# names it (a part of the name; K1 and K3, K2+K5 and K4 are instances of
# one template each, and a path runs one of them).
KERNEL_NAMES = {"K1": "hash_encode_fwd_kernel", "K3": "hash_encode_fwd_kernel",
                "K7": "field_tail_fwd_mma", "K2+K5": "hash_encode_bwd_kernel",
                "K4": "hash_encode_bwd_kernel", "K8": "field_tail_bwd_mma",
                "K6": "scatter_rows_kernel", "K9": "encode_ablation"}


def _timed_where_launched(counters, before, device_ms) -> None:
    """A profiled window's device time by kernel must be positive for each
    kernel that launched in it: a renamed kernel cannot read 0 ms."""
    for key, ms in device_ms.items():
        launched = counters[key].launches - before[key]
        if launched and not ms > 0.0:
            raise AssertionError(f"{key} launched {launched} times but the "
                                 f"profile matched no device time to "
                                 f"{KERNEL_NAMES[key]!r}")


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _counters():
    from ngp_pl_torch.ops import encode_ablations as ea
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he
    from ngp_pl_torch.ops import scatter_rows as sr

    return {"K1": he.hash_encode_fwd_cuda, "K7": ft.field_tail_cuda,
            "K2+K5": he.hash_encode_bwd_cuda, "K8": ft.field_tail_bwd_cuda,
            "K6": sr.scatter_rows_cuda, "K3": he.hash_encode_fwd_f2_cuda,
            "K4": he.hash_encode_bwd_f2_cuda,
            **{f"K9/{v}": ea.CUDA[v] for v in ea.VARIANTS}}


def path_kernels(cfg):
    """The hand kernels a train step of this model launches: the encode
    forward and its table gradient by F, then the field tail and its
    backward.  A render launches the first and the third."""
    if cfg.n_features_per_level == 2:
        return ("K3", "K4", "K7", "K8")
    return ("K1", "K2+K5", "K7", "K8")


def train_fit(torch, system, steps=TRAIN_STEPS):
    """`NeRFSystem.fit`: 16-step blocks, each after one grid refresh.  The
    fit logs every 128 steps after a fence, so rays/s over the last 8
    blocks is fenced at both ends.  Every kernel of the path must have
    launched and every loss be finite.  In CSR, where every ray is in the
    loss, the loss must fall; the strided and rounds layouts leave rays
    out of it (all of them in grid warmup, where no strided row or rounds
    budget covers a ray), so there the blocks' PSNR over the whole batch
    is reported without a limit."""
    tcfg, dev = system.tcfg, system.dev
    counters = _counters()
    blocks, step_block = [], system.step_block

    def recorded_block():
        """The block, and its layout, budget and chain, kept on the
        device: reading them here would fence every block."""
        layout, S, chain = system.layout, system._pool_mult, \
            system.step_chain()
        m = step_block()
        blocks.append((system._host_step, layout, S, chain,
                       {k: m[k] for k in BLOCK_KEYS}))
        return m

    system.step_block = recorded_block
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        hist = system.fit(max_steps=steps, log_every=128, quiet=True)
    finally:
        del system.step_block
    _sync(torch, dev)
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    first, last = hist[0], hist[-1]
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss: {[h['loss'] for h in hist]}")
    if system.layout == "csr" and not last["loss"] < first["loss"]:
        raise AssertionError(f"loss did not fall: {first['loss']} -> "
                             f"{last['loss']}")
    if torch.device(dev).type == "cuda" and not all(
            launches[k] > 0 for k in path_kernels(system.cfg)):
        raise AssertionError(f"a kernel of the train path did not launch: "
                             f"{launches}")
    tail = [h for h in hist if h["step"] >= steps - 128]
    block_s = (tail[-1]["seconds"] - tail[0]["seconds"]) / (
        (tail[-1]["step"] - tail[0]["step"]) // tcfg.grid_update_interval)
    out = dict(steps=system._host_step, batch=tcfg.batch_size,
               seconds=seconds, skipped=last["skipped_total"],
               loss={h["step"]: h["loss"] for h in hist},
               psnr={h["step"]: h["psnr"] for h in hist},
               rays_per_s_last8=tcfg.batch_size * tcfg.grid_update_interval
               / block_s, block_ms=block_s * 1e3,
               layout=system.layout, pool_mult=system._pool_mult,
               chain_length=system.step_chain(),
               chain_full=system.chain_full,
               rm_samples_per_ray=last["rm_samples"] / tcfg.batch_size,
               occupied=float(system.grid_state.occ_grid.float().mean()),
               launches=launches, layout_log=system.layout_log,
               blocks=[_block_record(tcfg.batch_size, *b) for b in blocks])
    return out


# a block's metrics kept per 16-step block of a fit (the last step's)
BLOCK_KEYS = ("loss", "psnr", "dropped_share", "rm_samples", "vr_samples",
              "rounds_alive_end", "total_slots")


def _block_record(batch, step, layout, S, chain, m):
    """One block of a fit: the layout, budget (the CSR pool's multiple or
    S) and chain it ran with; loss and PSNR; the share of the batch left
    out of the loss; samples per ray marched (rm, the block's largest) and
    composited (vr); rays alive after the last round and the slots of a
    rounds step."""
    v = {k: float(t) for k, t in m.items()}
    return dict(step=step, layout=layout, S=S, chain=chain, loss=v["loss"],
                psnr=v["psnr"], dropped_share=v["dropped_share"],
                rm_per_ray=v["rm_samples"] / batch,
                vr_per_ray=v["vr_samples"] / batch,
                rounds_alive_end=int(v["rounds_alive_end"]),
                total_slots=int(v["total_slots"]))


def tpu_staged_samples(torch, system, rays_o, rays_d, noise) -> int:
    """How many samples of this batch's pool the JAX package's compaction
    holds: it stages only the first pool_size/16 non-empty groups of 32
    chain candidates (ngp_pl_tpu/ops/ray_march.py:790-801) and repeats one
    position in the slots past them, as the port does after it."""
    from ngp_pl_torch.models.rendering import scene_hits
    from ngp_pl_torch.ops import ray_march as trm

    cfg, rcfg = system.cfg, system.rcfg
    N, dt_min = rays_o.shape[0], math.sqrt(3.0) / rcfg.max_samples
    K = -(-system.chain_length // 8) * 8
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    t0 = trm._fma(noise, trm._f32(dt_min), hits[:, 0])
    bits, ts = trm._occ_window_chain(
        rays_o, rays_d, t0, K // 8, system.grid_state.win_rows.to(
            rays_o.device), scale=cfg.scale, grid_size=cfg.grid_size,
        dt_min=dt_min)
    ts = ts.reshape(N, K)
    ok = (bits.reshape(N, K) & (ts >= 0) & (ts < hits[:, 1:2])
          & (hits[:, :1] >= 0))
    if K > rcfg.max_samples:
        ok &= (torch.cumsum(ok.int(), dim=1) - ok.int()) < rcfg.max_samples
    groups = ok.reshape(-1, 32).sum(dim=1)
    groups = groups[groups > 0]
    return int(groups[:2 * (N * system._pool_mult // 32)].sum())


@contextlib.contextmanager
def plain_on_card(*keys):
    """Within the block the named kernels' wrappers run their plain PyTorch
    versions on the card's tensors instead of launching (and counting): the
    witnesses of `train_reference`."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    swaps = {"K1": (he, "hash_encode_fwd_cuda", he.hash_encode_fwd_plain),
             "K3": (he, "hash_encode_fwd_f2_cuda", he.hash_encode_fwd_plain),
             "K7": (ft, "field_tail_cuda", ft.field_tail_plain),
             "K2+K5": (he, "hash_encode_bwd_cuda", he.hash_encode_bwd_plain),
             "K4": (he, "hash_encode_bwd_f2_cuda", he.hash_encode_bwd_plain),
             "K8": (ft, "field_tail_bwd_cuda", ft.field_tail_bwd_plain)}
    saved = [(mod, attr, getattr(mod, attr))
             for mod, attr, _ in (swaps[k] for k in keys)]
    try:
        for k in keys:
            mod, attr, plain = swaps[k]
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# what must be identical in two train steps of one layout from one state:
# the pool, the strided block, or (rounds) what the rounds decided per ray
STEP_POOL = {"csr": ("ts", "ray_idx"), "strided": ("ts", "valid"),
             "rounds": ("rm_counts", "loss_mask")}


def _train_step_on(torch, system, model, dev, batch):
    """Loss, gradients, pool and sample count of one train step of `model`
    on `dev` from the system's grid, layout, budget and chain."""
    from ngp_pl_torch.training.train_step import train_render

    rays_o, rays_d, target, noise = batch
    res, loss_of = train_render(
        model, system.grid_state.win_rows.to(dev), rays_o.to(dev),
        rays_d.to(dev), noise.to(dev), torch.ones(3, device=dev),
        tcfg=system.tcfg, rcfg=system.rcfg, n_samples=system._pool_mult,
        chain_length=system.step_chain(), layout=system.layout)
    loss = loss_of(target.to(dev))
    grads = torch.autograd.grad(loss, [w for _, _, w in model._slots()])
    return dict(loss=float(loss.detach()), grads=[t.cpu() for t in grads],
                pool={k: res[k].cpu() for k in STEP_POOL[system.layout]},
                samples=int(res["rm_samples"]))


def _step_err(torch, names, got, ref):
    """Loss error relative to the reference's; per parameter, the largest
    gradient error over its largest gradient, and the error's L2 norm over
    the gradient's."""
    grad = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(names, got["grads"], ref["grads"])}
    l2 = {n: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
          for n, a, b in zip(names, got["grads"], ref["grads"])}
    return dict(loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_rel_err=grad, grad_rel_err_max=max(grad.values()),
                grad_l2_err_max=max(l2.values()),
                pool_identical=all(torch.equal(got["pool"][k], ref["pool"][k])
                                   for k in ref["pool"]))


def train_reference(torch, system, cpu_tol, card_tol, seeds=(7,),
                    n_rays=2048, alone=(), alone_tol=None,
                    cpu_floor_by_witness=False):
    """One train step's loss and gradients from the system's state on the
    card (kernels), against the same step on the CPU (plain versions) and
    on the card with every kernel replaced by its plain version; same batch,
    march noise, background, pool size and chain; one batch per seed.

    The second comparison isolates the kernels: both sides run the card's
    own PyTorch ops.  Two witnesses, the card's step with K7 alone and with
    every kernel replaced by its plain version, show how far the card's
    summation order moves the step against the CPU with no kernel of ours
    involved.  Each kernel of the path is also run alone, the others as
    their plain versions, against the all-plain step on the card
    (`alone_vs_plain_on_card`), which tells the kernels' shares apart; the
    kernels named in `alone` are held to `alone_tol` there.  `cpu_tol`,
    `card_tol` and `alone_tol` are (loss, gradient) limits.

    With `cpu_floor_by_witness`, a batch whose card step misses the CPU's
    past `cpu_tol` while the card's step with no hand kernel misses it past
    `cpu_tol` too (a loss at the rounding floor: the rounds layout's ~1e-10
    after a fit, see ROUNDS_NOTE) is held by its pool against the CPU and
    by `card_tol` against the plain versions on the card; the record says
    so (`cpu_gate`)."""
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models.ngp import NGP

    ds = system.train_dataset
    cpu_ngp = NGP(system.cfg, device="cpu")
    cpu_ngp.load_params(system.ngp.params_numpy())
    names = [f"{n}" if i is None else f"{n}[{i}]"
             for n, i, _ in system.ngp._slots()]

    def within(err, tol):
        return (err["pool_identical"] and err["loss_rel_err"] <= tol[0]
                and err["grad_rel_err_max"] <= tol[1])

    batches, failed = [], False
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        img = torch.randint(0, len(ds.poses), (n_rays,), generator=g)
        pix = torch.randint(0, ds.directions.shape[0], (n_rays,), generator=g)
        rays_o, rays_d = get_rays(torch.from_numpy(ds.directions)[pix],
                                  torch.from_numpy(ds.poses)[img])
        batch = (rays_o.contiguous(), rays_d.contiguous(),
                 system.rays[img.to(system.dev), pix.to(system.dev)].cpu(),
                 torch.rand((n_rays,), generator=g))
        ref = _train_step_on(torch, system, cpu_ngp, "cpu", batch)
        card = _train_step_on(torch, system, system.ngp, system.dev, batch)
        with plain_on_card("K7"):
            k7_plain = _train_step_on(torch, system, system.ngp, system.dev,
                                      batch)
        path = path_kernels(system.cfg)
        with plain_on_card(*path):
            plain = _train_step_on(torch, system, system.ngp, system.dev,
                                   batch)
        vs_cpu = _step_err(torch, names, card, ref)
        vs_card = _step_err(torch, names, card, plain)
        brief = ("loss_rel_err", "grad_rel_err_max", "grad_l2_err_max")
        vs_alone = {}
        for key in path:
            with plain_on_card(*(k for k in path if k != key)):
                one = _train_step_on(torch, system, system.ngp, system.dev,
                                     batch)
            vs_alone[key] = {k: v for k, v in _step_err(
                torch, names, one, plain).items() if k in brief + (
                    "pool_identical",)}
            if key in alone:
                failed |= not within(vs_alone[key], alone_tol)
        out = dict(seed=seed, samples=card["samples"],
                   loss_card=card["loss"], loss_cpu=ref["loss"],
                   vs_cpu=vs_cpu, vs_plain_on_card=vs_card,
                   alone_vs_plain_on_card=vs_alone,
                   witness_K7_plain_vs_cpu={
                       k: v for k, v in _step_err(torch, names, k7_plain,
                                                  ref).items() if k in brief},
                   witness_all_plain_vs_cpu={
                       k: v for k, v in _step_err(torch, names, plain,
                                                  ref).items() if k in brief})
        if seed == seeds[0] and system.layout == "csr":
            out["tpu_staged_samples"] = tpu_staged_samples(
                torch, system, *batch[:2], batch[3])
        cpu_ok = within(vs_cpu, cpu_tol)
        if (not cpu_ok and cpu_floor_by_witness and vs_cpu["pool_identical"]
                and not within(out["witness_all_plain_vs_cpu"] | {
                    "pool_identical": True}, cpu_tol)):
            out["cpu_gate"] = ("the card's step with no hand kernel misses "
                               "the CPU past the limit too: held by the "
                               "pool and against the plain versions on the "
                               "card")
            cpu_ok = True
        failed |= not (cpu_ok and within(vs_card, card_tol))
        batches.append(out)

    def worst(side, key):
        return max(b[side][key] for b in batches)

    out = dict(rays=n_rays, layout=system.layout,
               pool_mult=system._pool_mult,
               chain_length=system.step_chain(), cpu_tol=cpu_tol,
               card_tol=card_tol, alone=list(alone), alone_tol=alone_tol,
               alone_vs_plain_on_card_max={
                   key: [max(b["alone_vs_plain_on_card"][key][m]
                             for b in batches)
                         for m in ("loss_rel_err", "grad_rel_err_max")]
                   for key in batches[0]["alone_vs_plain_on_card"]},
               vs_cpu_max=[worst("vs_cpu", "loss_rel_err"),
                           worst("vs_cpu", "grad_rel_err_max")],
               vs_plain_on_card_max=[
                   worst("vs_plain_on_card", "loss_rel_err"),
                   worst("vs_plain_on_card", "grad_rel_err_max")],
               witness_all_plain_vs_cpu_max=[
                   worst("witness_all_plain_vs_cpu", "loss_rel_err"),
                   worst("witness_all_plain_vs_cpu", "grad_rel_err_max")],
               batches=batches)
    if failed:
        raise AssertionError(f"card vs CPU train step disagrees: {out}")
    return out


def trained_render(torch, system, downsample=6.25):
    """Test view 0 at 800x800 of the trained field through the round
    renderer: one warm-up frame, then one fenced frame."""
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.models.rendering import RoundRenderer
    from ngp_pl_torch.training.metrics import psnr, ssim

    ds = SyntheticDataset(split="test", downsample=downsample,
                          device=system.dev)
    w, h = ds.img_wh
    dirs = torch.from_numpy(ds.directions).to(system.dev)
    pose = torch.from_numpy(ds.poses[0]).to(system.dev)
    renderer = RoundRenderer(system.ngp, system.rcfg)
    occ = system.grid_state.occ_grid
    counters = _counters()
    with torch.no_grad():
        renderer.render_pose(occ, dirs, pose)
        for c in counters.values():
            c.launches = 0
        _sync(torch, system.dev)
        t0 = time.perf_counter()
        out = renderer.render_pose(occ, dirs, pose)
        _sync(torch, system.dev)
    sec = time.perf_counter() - t0
    pred = out["rgb"].reshape(h, w, 3)
    if not bool(torch.isfinite(pred).all()):
        raise AssertionError("trained render not finite")
    gt = ds.image(0).reshape(h, w, 3)
    return dict(width=w, height=h, fps=1.0 / sec, frame_ms=sec * 1e3,
                samples_per_ray=out["total_samples"] / (w * h),
                rounds=out["rounds"], psnr=float(psnr(pred, gt)),
                ssim=float(ssim(pred, gt)),
                launches={k: c.launches for k, c in counters.items()})


def profile_block(torch, system, block_ms):
    """One more 16-step block under torch.profiler: device time of the
    path's four hand kernels, the PyTorch kernels around them, and the
    device's idle share against the unprofiled block time of the `train`
    phase.  A path runs one instance of each kernel template, so the
    kernel's name tells which of them ran."""
    from torch.profiler import ProfilerActivity, profile

    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = system.step_block()
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    parts = {key: sum(k[0] for k in kernels if KERNEL_NAMES[key] in k[2]
                      or (key == "K8" and "field_tail_bwd_reduce" in k[2]))
             for key in path_kernels(system.cfg)}
    _timed_where_launched(counters, before, parts)
    return dict(block_ms_unprofiled=block_ms, block_ms_profiled=wall * 1e3,
                device_busy_ms=busy, idle_share=1.0 - busy / block_ms,
                kernels_ms=parts, other_kernels_ms=busy - sum(parts.values()),
                launches_device=sum(k[1] for k in kernels),
                top=[{"ms": ms, "count": n, "name": name[:90]}
                     for ms, n, name in kernels[:16]])


def render_slice(torch, tcfg, views):
    """`evaluate` of the seeded model at 800x800: `views` test views, the
    counts from 0 just before, read just after; the path's encode kernel
    and K7 must launch."""
    from ngp_pl_torch.eval import evaluate

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = evaluate(tcfg, device="cuda", max_images=views)
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for img, opa in zip(res.images, res.opacities):
        if img.shape != (800, 800, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError("rendered image not finite (800, 800, 3)")
        if not (bool(torch.isfinite(opa).all()) and float(opa.min()) >= 0.0
                and float(opa.max()) <= 1.0 + 1e-6):
            raise AssertionError("opacity outside [0, 1]")
    fwd, _, tail, _ = path_kernels(tcfg.ngp_config())
    if not (launches[fwd] > 0 and launches[tail] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    return res, {"views": len(res.images), "width": 800, "height": 800,
                 "fps": res.fps, "samples_per_ray": res.samples_per_ray,
                 "rounds_per_frame": res.rounds_per_frame, "psnr": res.psnr,
                 "ssim": res.ssim, "launches": launches, "seconds": seconds,
                 "note": "seeded init weights: rays do not terminate early, "
                 "so this is the march's worst case"}


def ckpt_roundtrip(torch, res, tcfg):
    """Slim checkpoint of `res`'s model and grid, reloaded through the eval
    entry point: the re-render of view 0 must be identical."""
    from ngp_pl_torch import _build
    from ngp_pl_torch.eval import evaluate
    from ngp_pl_torch.training.checkpoint import save_slim_checkpoint

    build_dir = _build.BUILD_DIR.parent
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "slim.npz")
        save_slim_checkpoint(path, params=res.ngp.params_numpy(),
                             occ_grid=res.occ_grid)
        res2 = evaluate(tcfg.replace(weight_path=path), device="cuda",
                        max_images=1)
    same = bool(torch.equal(res.images[0], res2.images[0]))
    if not same:
        raise AssertionError("re-render from the slim checkpoint differs")
    return {"identical": same,
            "hash_table": list(res.ngp.hash_table.shape)}


def train_path(torch, tcfg, card, suffix, trained_batches,
               seeded_tol=STEP_TOL, alone=(), at_step=True,
               seeded_cpu_tol=None):
    """The train path of one geometry: the seeded step against the CPU
    (limit `seeded_cpu_tol`, by default `seeded_tol`) and the plain
    versions (limit `seeded_tol`), `NeRFSystem.fit` (the counts
    from 0 just before, read just after), the trained step on
    `trained_batches`, the trained field's 800x800 render and a profiled
    block.  The kernels named in `alone` are held, each alone, to STEP_TOL
    (seeded) and TRAINED_KERNEL_TOL (trained) against the plain versions
    on the card.  Then, if `at_step`, the encode kernel and the
    table-gradient kernel on the input of one more train step
    (`table_grad_inputs.capture`: the CSR pool's positions and gradients,
    ray by ray, zero rows on its unused slots; in the strided layout the
    (N, S) block's, its invalid slots at their ray's origin with zero
    rows).  Returns the fit's record and the two kernels' records, by
    key."""
    from ngp_pl_torch.benchmarking.table_grad_inputs import capture
    from ngp_pl_torch.benchmarking.train_setup import train_system

    system = train_system(tcfg)                  # seeded, first refresh
    system.on_train_start()
    system._refresh_grid(0)
    log({"phase": "train_reference" + suffix, "state": "seeded",
         **train_reference(torch, system, seeded_cpu_tol or seeded_tol,
                           seeded_tol, alone=alone, alone_tol=STEP_TOL)})
    del system
    torch.cuda.empty_cache()
    system = train_system(tcfg)
    train = train_fit(torch, system)
    log({"phase": "train" + suffix, "card": card, **train})
    log({"phase": "train_reference" + suffix, "state": "trained",
         **train_reference(torch, system, TRAINED_CPU_TOL,
                           TRAINED_KERNEL_TOL, seeds=trained_batches,
                           alone=alone, alone_tol=TRAINED_KERNEL_TOL,
                           cpu_floor_by_witness=system.layout == "rounds")})
    log({"phase": "trained_render" + suffix, "card": card,
         **trained_render(torch, system)})
    log({"phase": "profile", "of": "train_block" + suffix, "card": card,
         "layout": system.layout, "S": system._pool_mult,
         **profile_block(torch, system, train["block_ms"])})
    if not at_step:
        del system
        torch.cuda.empty_cache()
        return train, {}
    x, gr, w1 = capture(system)
    fwd, bwd = path_kernels(system.cfg)[:2]
    at_step = {
        fwd: _fwd_record(torch, fwd, x, system.ngp.encode_table(), w1,
                         system.ngp.spec, with_feats=True),
        bwd: _bwd_record(torch, bwd, x, gr, w1, system.ngp.spec)}
    for key, rec in at_step.items():
        log({"phase": "kernels", "kernel": key, "input": "train_step" + suffix,
             "card": card, **rec})
    del system, x, gr, w1
    torch.cuda.empty_cache()
    return train, at_step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ngp_pl_torch import _build
    from ngp_pl_torch.benchmarking.train_setup import train_config
    from ngp_pl_torch.device import resolve_device
    from ngp_pl_torch.models.ngp import NGP

    t_start = time.perf_counter()
    resolve_device("cuda")
    card = card_line()
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": card, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    seconds = _build.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "seconds_by_kernel": seconds,
         "kernels": list(_build.KERNELS),
         "ptxas": {k: [ln.strip() for ln in
                       (_build.BUILD_DIR / f"{k}.log").read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
                   for k in _build.KERNELS
                   if (_build.BUILD_DIR / f"{k}.log").exists()}})

    # the two geometries: the flagship L8F4 and the reference's L16F2
    tcfgs = {"flagship": train_config(downsample=6.25),
             "l16f2": train_config(downsample=6.25, n_levels=16,
                                   n_features=2)}
    checks = {}
    for path, kernel_checks in (
            ("flagship", (("K1", lambda m: check_fwd(torch, m, "K1")),
                          ("K7", lambda m: check_k7(torch, m)),
                          ("K2+K5", lambda m: check_bwd(torch, m, "K2+K5")),
                          ("K8", lambda m: check_k8(torch, m)),
                          ("K6", lambda m: check_k6(torch)))),
            ("l16f2", (("K3", lambda m: check_fwd(torch, m, "K3")),
                       ("K4", lambda m: check_bwd(torch, m, "K4"))))):
        tcfg = tcfgs[path]
        model = NGP(tcfg.ngp_config(), seed=tcfg.seed, device="cuda")
        for key, check in kernel_checks:
            checks[key] = check(model)
            log({"phase": "kernels", "kernel": key, "geometry": path,
                 **checks[key]})
            torch.cuda.empty_cache()
        del model
    for variant, check in check_k9(torch).items():
        checks[f"K9/{variant}"] = check
        log({"phase": "kernels", "kernel": f"K9/{variant}", **check})

    # the K9 bench: counts from 0 just before, read just after
    launches = {}
    micro, launches["micro_fwd"] = micro_fwd_path(torch, card)

    # the render path: counts from 0 just before, read just after
    tcfg = tcfgs["flagship"]
    res, out = render_slice(torch, tcfg, views=2)
    launches["render"] = out["launches"]
    log({"phase": "slice", "card": card, **out})
    log({"phase": "ckpt", **ckpt_roundtrip(torch, res, tcfg)})
    log({"phase": "reference", **reference_crop(torch, res, tcfg)})
    log({"phase": "profile", "of": "frame", "card": card,
         **profile_frame(torch, res, tcfg)})
    del res
    torch.cuda.empty_cache()
    # the train path: counts from 0 just before fit, read just after
    train, at_step = train_path(torch, train_config(), card, "",
                                TRAINED_BATCHES)
    for key, rec in at_step.items():
        checks[key]["at_train_step"] = rec
    launches["train"] = train["launches"]

    # the flagship in the strided layout and in rounds with the distortion
    # loss, counted the same way
    for layout, lam in (("strided", 0.0), ("rounds", 1e-2)):
        suffix = "_" + layout
        train, at_step = train_path(
            torch, train_config(train_layout=layout, distortion_loss_w=lam),
            card, suffix, TRAINED_BATCHES_LAYOUTS,
            at_step=layout == "strided", seeded_cpu_tol=SEEDED_MASKED_CPU_TOL)
        for key, rec in at_step.items():
            checks[key]["at_train_step" + suffix] = rec
        launches["train" + suffix] = train["launches"]

    # the L16F2 render and train paths, counted the same way
    tcfg = tcfgs["l16f2"]
    res, out = render_slice(torch, tcfg, views=1)
    launches["render_l16f2"] = out["launches"]
    log({"phase": "slice_l16f2", "card": card, **out})
    log({"phase": "ckpt_l16f2", **ckpt_roundtrip(torch, res, tcfg)})
    del res
    torch.cuda.empty_cache()
    train, at_step = train_path(
        torch, train_config(n_levels=16, n_features=2), card, "_l16f2",
        TRAINED_BATCHES_L16F2, seeded_tol=STEP_TOL_L16F2,
        alone=("K3", "K4"))
    for key, rec in at_step.items():
        checks[key]["at_train_step"] = rec
    launches["train_l16f2"] = train["launches"]

    no_library = "no single PyTorch call computes this function"
    rows = (("hash_encode_fwd (K1)", "K1", "hash_encode_fwd.cu",
             "ngp_pl_tpu/ops/hash_encoding_pallas.py:338"),
            ("hash_encode_fwd_f2 (K3)", "K3", "hash_encode_fwd.cu",
             "ngp_pl_tpu/ops/hash_encoding_pallas.py:370"),
            ("field_tail_fwd (K7)", "K7", "field_tail_fwd.cu",
             "ngp_pl_tpu/ops/field_pallas.py:170"),
            ("hash_encode_bwd (K2 fused with K5)", "K2+K5",
             "hash_encode_bwd.cu",
             "ngp_pl_tpu/ops/hash_encoding_pallas.py:413, "
             "ngp_pl_tpu/ops/scatter_accum.py:124"),
            ("hash_encode_bwd_f2 (K4 fused with the scatter-add)", "K4",
             "hash_encode_bwd.cu",
             "ngp_pl_tpu/ops/hash_encoding_pallas.py:428"),
            ("field_tail_bwd (K8)", "K8", "field_tail_bwd.cu",
             "ngp_pl_tpu/ops/field_pallas.py:197"),
            ("scatter_rows (K6)", "K6", "scatter_rows.cu",
             "ngp_pl_tpu/ops/scatter_accum.py:75"))
    entries = []
    for name, key, src, replaces in rows:
        k = checks[key]
        # a kernel's own paths: the L16F2 ones for K3 and K4, the
        # flagship's for the others
        own = "_l16f2" if key in ("K3", "K4") else ""
        entries.append({
            "name": name, "route": "cuda", "source": f"ngp_pl_torch/csrc/{src}",
            "replaces": replaces, "launches": launches["train" + own][key],
            "launches_render": launches["render" + own][key],
            "launches_by_path": {p: v[key] for p, v in launches.items()},
            "max_abs_err": k["max_abs_err"],
            # K7 is held to an absolute limit, the others to a limit
            # relative to the largest magnitude of each output
            **({"tol_abs": k["tol_abs"]} if "tol_abs" in k else
               {"max_rel_err": k["max_rel_err"], "tol_rel": k["tol_rel"]}),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "library_note": ("Tensor.index_add_ with its zero fill"
                             if "library_ms" in k else no_library),
            **{f: k[f] for f in (
                "device_ms", "fill_ms", "call_device_ms", "bound_share",
                "library_device_ms", "input", "at_runs",
                "at_train_pool", "at_train_step",
                "at_train_step_strided",
                "max_abs_err_vs_float64_sums", "max_rel_err_vs_float64_sums",
                "tol_rel_vs_float64_sums") if f in k}})
    # K9 on its own path, the bench: times, bounds and launches from the
    # `micro_fwd` run, errors and plain times from the kernel checks
    bench = "benchmarking/micro_pallas_fwd.py"
    bodies = {"full": "full_kernel :84", "no_decode": "no_decode_kernel :112",
              "no_wrow": "no_wrow_kernel :141", "no_ft": "no_ft_kernel :167",
              "stream": "stream_kernel :190",
              "full_il": "full_kernel_il :295"}
    for v, body in bodies.items():
        k, m, key = checks[f"K9/{v}"], micro[v], f"K9/{v}"
        calls = (f"{bench}:267 (make_variant_interleaved)" if v == "full_il"
                 else f"{bench}:56 (make_variant), :231 (make_variant_bn)")
        entries.append({
            "name": f"encode_ablation_{v} (K9)", "route": "cuda",
            "source": "ngp_pl_torch/csrc/encode_ablations.cu",
            "replaces": f"{calls}; body {body}",
            "launches": launches["micro_fwd"][key],
            "launches_by_path": {p: c[key] for p, c in launches.items()},
            "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
            "tol_rel": k["tol_rel"], "ms": m["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "device_ms": k["device_ms"],
            "call_device_ms": k["call_device_ms"],
            "bound_share": k["bound_share"],
            "micro_fwd_device_ms": m["device_ms"],
            "library_ms": k.get("library_ms"),
            "library_device_ms": k.get("library_device_ms"),
            "library_note": ("Tensor.sum over levels of the rows as f32, "
                             "torch.zeros for ft2" if "library_ms" in k
                             else "the contraction is the kernel's own")})
    print(card, flush=True)
    log({"kernels": entries, "seconds": time.perf_counter() - t_start})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
