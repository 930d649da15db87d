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
           step with K7, and with every kernel, run as its plain version;
           K1 passes with its h1 and feats within K1_TOL of the plain
           ones on every call, and K1 alone within the limit against the
           plain versions' step or against the plain step that takes K1's
           bf16 roundings of h1 (`h1_rounded_as`); K7 passes on
           every call of the step with K1 and K7 with its bf16 hidden
           values, read back through probe weights, within
           K7_ROUNDED_TOL's window of the plain tail that takes them and
           its outputs within K7_ROUNDED_TOL of that tail's
           (`k7_by_rounding`); a step past the limit passes only with K1
           alone so held and the other kernels within the limit against
           K1 alone, or K8 and K2+K5 within it against the step with K1
           and K7; the witness of K1's error (the plain step with every
           bf16 rounding of h1 flipped that K1's error could flip) is
           logged beside and decides nothing
  trained_render  test view 0 at 800x800 of the trained field: FPS,
           samples/ray, rounds, PSNR
  profile  one more 16-step block under torch.profiler: K1, K7, K2+K5, K8,
           the PyTorch kernels around them and the device's idle share
  kernels  (input train_step) K1 and K2+K5 on the (x, g, w1) the table
           gradient's wrapper receives in one more train step: the
           393,216-slot pool, ray by ray, zero rows on unused slots; K1 on
           that x with the fitted table, called with feats as the train
           step calls it; checked and timed as at random points
  resume   the flagship fits 256 steps and saves a full checkpoint; a fresh
           system that has run one step loads it: every tensor of the
           state equal (params, Adam moments, grid fields, count, step),
           one train step on one explicit batch of both within
           TRAINED_KERNEL_TOL with an identical pool, then 256 more steps
           of the loaded system, finite, none skipped
  tensorboard  the loaded system's fit's event file, read with this
           script's own CRC32C and protobuf reader: every record's CRCs,
           the first record's file_version, the four scalars at each
           logged step equal to the fit's history as float32
  validate  that system's validate with image dumps of one test view: both
           PNGs there, signature and IHDR size right, PSNR/SSIM
  mesh     that system's slim checkpoint through `ngp_pl_torch.eval
           --mesh_path` at 256^3 and sigma level 20: the density query's
           and the march's fenced seconds, vertex and face counts, the
           allocator's peak; K1 launched once per 131,072-point call (128),
           counted over the query and march alone; the mesh against the
           CPU's march of the same density grid (faces identical, vertices
           within MESH_VERT_TOL), the grid against the plain versions on
           the card (h1 within K1_TOL on every call, log sigma within each
           cell's bf16 flip bound, level flips counted); K1 checked and
           timed on one chunk of the lattice (`kernels`, input mesh_grid)
  gui      `ngp_pl_torch.show_gui --screenshot` at 800x800 from the same
           checkpoint (128 samples, T 1e-2): the PNG's signature and size,
           K1 and K7 launched, the fenced ms of GUI_FRAMES more frames,
           samples per ray, rounds; a crop of the frame's rays with the
           kernels against the plain versions on the card
  lpips    seeded random LPIPS weights on an 800x800 pair: LPIPS(x, x) = 0,
           the value against the CPU's, seconds; that system's validate
           with --eval_lpips and the weights' npz must score lpips
  interop  Morton codes, bitfields (the trained grid and a four-cascade
           one), packbits and both multi-object intersections on the card,
           bit-equal to the CPU
  ddp      data parallelism on this card: how far 2 and 4 ranks' own CSR
           pools and rounds slots part from the global ones on the seeded
           step; the flagship's 256 steps in a process group of one NCCL
           rank, whose explicit-batch step must equal the same step
           outside any group within TRAINED_KERNEL_TOL; two gloo ranks
           spawned on this card from that state: the step over their
           shards within TRAINED_KERNEL_TOL at a pool with room (read at
           the controller's budget too), the 2-view validate within 1e-6,
           then 64 steps after which the ranks hold equal parameters,
           moments and grids (and the count of those with a full pool);
           each rank launches K1, K2+K5, K7 and K8; the two ranks' step
           at the controller's budget from the state at step 512, read
  bench    ngp_pl_torch.benchmarking.bench in this process, 512 warm-up
           steps and 192 timed ones: its JSON record
  fps      ngp_pl_torch.benchmarking.bench_fps: the flagship fits 1536
           steps, then 5 fenced 800x800 frames of test pose 0 at T 1e-2
           (the JAX script's record, frame ms, K1 and K7 launched in the
           timed frames); a 1024-ray crop of that frame with the kernels
           on the card against the plain versions on the CPU
           (reference_crop's limits); one more frame profiled by kernel
  test_renderer, host_rounds  on fps's trained system and frame at T
           1e-2, the JAX package's two other renderers (`TestRenderer`,
           one pass a chunk: chunk 16,384, pool x64, K1 and K7 on
           1,048,576 samples; `HostRoundRenderer`, its host loop): fenced
           frames, samples per ray, rounds; K1 and K7 must launch; a
           1024-ray crop against the CPU's plain versions within 5e-3
  fps_ablate, debug_fps, fps_sweep, tune_fps, micro_march  the JAX
           repository's serving and march probes on that system and frame
           (`serving_paths`): the full frame against a constant field (K1
           and K7 launch in the first, never in the second), the frame
           round by round (its rounds and samples equal to the round
           renderer's at chunk 65,536), five bucket ladders, four
           schedules and four one-pass configurations, the windowed
           march's stages and the compaction's steps (wall and device ms)
  shard_frame  one frame's rays over ranks, on fps's trained system and
           frame (800x800, T 1e-2), its slim checkpoint under build/:
           (a) a process group of one NCCL rank renders the frame through
           `RoundRenderer(group=...)`, bit-equal to the frame with no
           group (rounds and samples too), with its collectives a frame;
           (b) two gloo ranks spawned on this card each render their share
           of every chunk: rounds and total samples equal to the one-rank
           frame's, rgb, depth and opacity within SHARD_TOL (1e-6); each
           rank launches K1 and K7; the fenced frame ms at one and two
           ranks, read; (c) the same ranks run the eval entry's rank
           function (`eval.run`) on the slim checkpoint, 2 views and
           --fps_frames 5: PSNR/SSIM within VALIDATE_TOL of one rank's,
           its "render:" line parsed as eval_fps's
  profile_rounds, micro_field, ablate_geom  the JAX repository's
           rounds-step, field-stack and geometry probes, in a spawned
           process of their own, each counted from 0 at its start there:
           the rounds layout's parts after ROUNDS_WARM (128) warm steps
           (PROBE_RUNS calls a part, PROBE_BLOCK_RUNS blocks a layout),
           the MLP stack and the field's fwd+bwd bisection at 262,144
           points, L16F2 and L8F4 after ABLATE_STEPS (128) steps (rays/s,
           PSNR, SSIM); every part's device ms > 0 and the kernels of
           each launched
  check_pallas_encode, check_field_tail, check_bwd_parts,
  micro_encode_fwd, micro_encode_geom  the JAX repository's encode and
           field-tail checks in a second spawned child, each counted
           from 0 at its start (`encode_check_paths`): the fused encode with its
           kernels against the plain versions at L16F2 and L8F4 (the JAX
           script's OK line; h1 within K1_TOL, the table gradient within
           K2_TOL), K7 and K8 on the JAX script's inputs (its OK line; K7
           within K7_TOL of both plain tails, K8 within K8_F32_TOL of the
           f32 one), the encode backward's parts and the encode's stages
           at N=262,144 and both geometries' fwd and fwd+bwd, each
           script's encode kernels held on its inputs; every kernel a
           script runs launched
  diag_demand, diag_demand2, nan_hunt, nan_probe, dbg_pose  the JAX
           repository's demand traces, NaN tools and pose-gradient check
           in that child (`train_diag_paths`): the demand vector's
           nine fields finite in every block; a few hunted blocks of
           bench.py's scene, the last one's snapshot replayed from its
           file in a new system (its loss beside the hunt's, logged); the
           probe's every stage finite on both paths, the kernels' h1
           within K1_TOL of the plain path's, their rgb within K7_TOL of
           the plain tail's on the same h1; dR and dT
           gradients finite and nonzero at S=64
  micro, micro_r2, micro_r2b, micro_r2c, micro_scatter, micro_r4,
  train_quick  the JAX repository's primitive micros and its quick-train
           script in two more spawned children (`other_micro_paths`,
           `encode_micro_paths`), each counted
           from 0 at its start: every label's wall ms and device ms
           (MICRO_RUNS calls after MICRO_WARMUP; micro_r2b at N 65,536,
           MICRO_CUTS); each `port: ` call
           (K6, K3, K1, K2+K5) held against its primitive on the same
           input within K6_TOL, K1_TOL or K2_TOL and launched;
           micro_r4's fit (MICRO_R4_STEPS) and train_quick's
           (TRAIN_QUICK_STEPS, 256x256, 24 views, 2 scored) launching K1,
           K2+K5, K7 and K8 with a finite, falling loss
  eval_fps  ngp_pl_torch.eval --fps_frames 5 --max_images 1 from the
           resumed flagship's slim checkpoint: the "render:" line and
           EvalResult.fps_loop
  profile_step  ngp_pl_torch.benchmarking.profile_step of the flagship in
           CSR, then strided, at 8192 rays after 192 steps: each stage's
           fenced wall ms and device ms, the stages that partition a step
           summed against the full step; K1, K2+K5, K7, K8 must launch
  exr      ngp_pl_torch.misc.prepare_rtmv on copies of the committed EXR
           trees (ZIP, RLE, ZIPS; PIZ and PXR24; B44, B44A, DWAA, DWAB,
           tiled, multi-part): their PNGs equal to those the JAX script
           wrote, seconds per frame; where the machine has an EXR reader
           of its own (cv2 with OpenEXR, the OpenEXR module), the PIZ and
           PXR24 frames read by it equal to `read_exr`'s; read_exr against
           OpenEXR's own codec (cv2): a 256x256 RGBA half frame written in
           each of the ten methods (by the test writer where OpenEXR's
           file does not read back), every committed frame and a file of
           DC-only DWA blocks over every half, each read by both, 0 half
           ulps apart (null and why where cv2 has no writer or reader);
           1600x1600 RGBA half frames in PIZ (read back exactly, every
           block compressed), B44A and DWAA, read_exr's seconds beside
           cv2's
All of the train phases (train_reference, train, train_reference again,
trained_render, profile, kernels) again in the strided layout
(`_strided`: 8192 rays x S slots, the invalid ones at their ray's origin;
K1 and K2+K5 on its train step's input) and in rounds with the distortion
loss at 1e-2 (`_rounds`: four rounds of 8192, 4096, 2048 and 1024 slots
each step, no kernels phase), trained from the seed and each
step held to the CSR path's limits, the trained step by the flagship's
gate (K1 and K7 by their own errors; under rounds the CPU comparison also
by the witness rule of ROUNDS_NOTE); each fit also logs every 16-step
block: layout, S, chain, the share of the batch left out of the loss,
samples per ray marched and composited, rays alive after the last round
and the rounds' slots.
Then the multi-cascade scene of ngp_pl_torch.benchmarking.bench_mc (scale
4: four cascades, steps growing by 1/256, hash levels up to 8192; L8F4 at
full width, 8 views of the scene scaled by 8 at 96x96 on black, `auto`):
K1 and K2+K5 at random points of its grid (`kernels`, geometry scale4),
train_reference_mc (seeded), train_mc (512 steps; K1, K2+K5, K7 and K8
must launch; each block with its layout, S, chain, rm per ray, occupied
share per cascade, loss and rays/s from two CUDA events),
train_reference_mc from the trained state on 4 batches
(TRAINED_CPU_TOL_MC, TRAINED_KERNEL_TOL_MC, K1 and K7 by their own
errors as on the flagship, and the witness rule against the CPU),
trained_render_mc (an 800x800 frame of the trained
field: FPS, samples/ray, rounds; the test views' PSNR/SSIM), a profiled
block, then K1 and K2+K5 on a train step's input and K7 and K8 on the
next step's (`kernels`, input train_step_mc).
Then the same for the reference's own geometry, L16F2 (L=16, F=2, T=2^19,
the f32 table read by K3, its gradient by K4): slice_l16f2 (one view; K3
and K7 must launch), ckpt_l16f2, train_reference_l16f2 (seeded; K3 and K4
each alone held to the step's limits, the whole step to STEP_TOL_L16F2),
train_l16f2 (512 steps; K3, K4, K7 and K8 must launch),
train_reference_l16f2 from the trained state on 2 batches (K3 by its
own error and its bf16 roundings of h1 as K1 on the flagship, K7 by its
own error, K4 with K8 inside the gate's second part),
trained_render_l16f2, a profiled block, K3 and K4 on a train step's
input, and mesh_l16f2 (the trained field's mesh at 128^3 as `mesh` does
it, K3 launched 16 times, K3 on a chunk of its lattice).
Then the flagship's two other heads of training, CSR pinned:
train_hdr (`--use_exposure`: the HDR head, its tail PyTorch ops as the
JAX package's XLA tail; the seeded step as train_reference_hdr, once
more on a batch with an exposure column of 0.25-4 per ray drawn from a
seed; 256 steps, each block logged; the trained field's 800x800 frame;
a profiled block; K1 and K2+K5 must launch, K7 and K8 must not) and
train_pose (`--optimize_ext`: the x-grad encode and the tail as PyTorch
ops, no hand kernel, as in the JAX package; the seeded step against the
CPU, dR and dT included; 256 steps with blocks and rays/s; a profiled
block with the x-grad encode's forward and backward device ms; the peak
of torch.cuda's allocator; dR and dT norms; K1, K2+K5, K7 and K8 must
launch 0 times).
Then the flagship on a scene on disk: train_disk writes NeRF-Synthetic's
layout from the procedural scene's ground truth (100 train views at
800x800, 8 test views, RGBA PNGs, Blender poses) and trains it through
`ngp_pl_torch.train.main` (`--dataset_name nerf --root_dir`, CSR pinned,
512 steps, two test views scored and dumped; `ngp_pl_torch.eval` scores
them again from the slim checkpoint): the decoded store on the
card within DISK_STORE_TOL of the ground truth written and bit-equal to
the CPU's decode, the poses within DISK_POSE_TOL, K1, K2+K5, K7 and K8
launched in the fit, no step skipped, load seconds, rays/s, the two test
PSNRs and the allocator's peak; train_reference_disk holds one
explicit-batch step of the trained state as train's; host_batches trains
64 steps of the same scene with the store left on the host (its budget one
byte short), its first 16 batches bit-equal to the host sampler on the
CPU, the four kernels launched, and the host's ms per step drawing and
copying a batch.
Then the card line, the kernels line (the seven kernels of the paths and
the six K9 variants, with their launches on each path, mesh, gui and
mesh_l16f2 among them) and, last, the result line.  Without a CUDA device,
or run outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
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
# K7 on a trained step against the plain tail that takes its bf16
# roundings of h, relu(z1) and relu(z2) (`k7_by_rounding`): each hidden
# value it rounds otherwise than the plain tail lies within this of the
# layer's max |plain| of a rounding midpoint, and its rgb and log sigma lie
# within this of their max of that tail's.  As K1_TOL: exact bf16 products
# summed in f32 in another order, nothing else (<= 2.7e-7 and no value
# outside on the H100, PERF.md).
K7_ROUNDED_TOL = 1e-5
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
# The scale-4 scene after its 512-step fit (chip_smoke's train_mc) is
# fitted harder than the flagship's (loss ~1e-5, ~5 samples per ray on
# black), and there the step's readings are at a rounding floor: over 4
# batches the card's step with no hand kernel misses the CPU's by up to
# 8.6e-4 of the loss and 1.85e-2 of the largest gradient, and the
# kernels' step misses the plain versions on the card by 3.8e-4 / 1.1e-2,
# K1 alone by 4.3e-4 / 1.06e-2 (its other f32 summation order flips bf16
# roundings of h1; 5.6e-7 of max at random points), K7 alone by 3.9e-4 /
# 4.9e-3 (the H100, calls 2-3 of PR 11, PERF.md).  Both limits are ~2x
# the no-kernel witness: the kernels may move the step twice as far as
# the card's own summation order does without them.
TRAINED_CPU_TOL_MC = (2e-3, 4e-2)
# The HDR and pose paths' tail is PyTorch ops that round as the JAX
# package's jitted `_mlp_apply` (`mlp_apply`): hidden activations and the
# weights' gradients in bf16.  Another summation order (cuBLAS against the
# CPU's, K1's against its plain version's) flips a hidden unit's bf16
# rounding and, through the chain, moves weight-gradient entries by steps
# of 2^-8 of themselves: the seeded pose step with no hand kernel read
# 6.4e-3 of the largest rgb_mlp[2] gradient against the CPU (an H100
# 80GB HBM3 at 700 W; PERF.md), its table, w1, dR and dT gradients
# 3.9e-5-1.4e-4.
# Those weight gradients are held to K8's limit against its f32 plain
# version, the same phenomenon there; the others to the step's limit.
TAIL_TOL = K8_F32_TOL
TRAINED_KERNEL_TOL_MC = (2e-3, 4e-2)
TRAINED_BATCHES = (7, 8, 9, 10)   # seeds of the trained-state batches
TRAINED_BATCHES_L16F2 = (7, 8)
TRAINED_BATCHES_LAYOUTS = (7,)     # the strided and rounds paths
TRAINED_BATCHES_MC = (7, 8, 9, 10)
# The gate of each fitted scene's trained state, as `train_reference`'s
# arguments (`trained_gate`).  Every scene's encode kernel (K1, or K3 at
# L16F2) is held by its own error and its bf16 roundings of h1
# (`encode_by_rounding`), and K7 by its own error: the card's fit is not
# bit-reproducible (the table gradient's atomics), so a limit read off the
# fitted state, such as the witness of K1's error, is redrawn with every
# fit.  The witness is logged beside (`witness_reading`) and decides
# nothing.  The rounds and scale-4 states also keep the CPU comparison's
# witness rule (`cpu_floor_by_witness`, ROUNDS_NOTE), which reads the
# other side of the step.  L16F2 keeps K3's and K4's records alone; with
# the rounding gate they decide nothing themselves.
_ROUNDED = dict(encode_by_rounding=True, witness_reading=True)
TRAINED_GATES = {
    "flagship": dict(cpu_tol=TRAINED_CPU_TOL, card_tol=TRAINED_KERNEL_TOL,
                     seeds=TRAINED_BATCHES, **_ROUNDED),
    "strided": dict(cpu_tol=TRAINED_CPU_TOL, card_tol=TRAINED_KERNEL_TOL,
                    seeds=TRAINED_BATCHES_LAYOUTS, **_ROUNDED),
    "rounds": dict(cpu_tol=TRAINED_CPU_TOL, card_tol=TRAINED_KERNEL_TOL,
                   seeds=TRAINED_BATCHES_LAYOUTS, cpu_floor_by_witness=True,
                   **_ROUNDED),
    "l16f2": dict(cpu_tol=TRAINED_CPU_TOL, card_tol=TRAINED_KERNEL_TOL,
                  seeds=TRAINED_BATCHES_L16F2, alone=("K3", "K4"),
                  alone_tol=TRAINED_KERNEL_TOL, **_ROUNDED),
    "mc": dict(cpu_tol=TRAINED_CPU_TOL_MC, card_tol=TRAINED_KERNEL_TOL_MC,
               seeds=TRAINED_BATCHES_MC, cpu_floor_by_witness=True,
               **_ROUNDED),
    "disk": dict(cpu_tol=TRAINED_CPU_TOL, card_tol=TRAINED_KERNEL_TOL,
                 seeds=(7,), encode_by_rounding=True),
}
# each fitted scene's `train_setup.train_config` arguments (scale 4 is
# `bench_mc.bench_mc_system`'s, the disk scene `disk_path`'s)
SCENE_CONFIGS = {"flagship": {},
                 "strided": dict(train_layout="strided",
                                 distortion_loss_w=0.0),
                 "rounds": dict(train_layout="rounds",
                                distortion_loss_w=1e-2),
                 "l16f2": dict(n_levels=16, n_features=2)}
TRAIN_STEPS = 512              # 32 blocks: 16 warmup refreshes, then phases
K7_N = 1048576                 # K7's samples in the kernels phase
K8_N = 262144                  # K8's
POOL_N = 8192 * 48             # the train pool at x48, both kernels again


_T0 = time.perf_counter()


def log(obj) -> None:
    """One JSON line; a phase's line also takes the seconds since this
    process started (`t`)."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - _T0}
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
    version's time and the bound (`roofline.k1_work` on this x).  Every
    timed call finds the L2 flushed (`timing`), as does every record's
    here: inputs small enough to stay in the L2 would otherwise beat the
    memory's rate that the bound assumes."""
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
    ms = time_ms(call, flush=True)
    dev_ms = device_ms(call, (KERNEL_NAMES[key],), flush=True)
    plain_ms = time_ms(lambda: he.hash_encode_fwd_plain(x, table, w1, spec,
                                                        out), flush=True)
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
                                                            tail_inputs)

    ws = [ngp.sigma_mlp[1].detach()] + [w.detach() for w in ngp.rgb_mlp]
    out = {}
    for P in (K7_N, POOL_N):
        h1, sh = (t.cuda() for t in tail_inputs(P, *K7_INPUTS))
        out[P] = _k7_record(torch, (h1, sh, *ws))
        del h1, sh
        torch.cuda.empty_cache()
    return dict(out[K7_N], at_train_pool=out[POOL_N])


def _k7_record(torch, args):
    """K7 on (h1, sh, w2, wr1, wr2, wr3) against both plain versions
    (K7_TOL), its event and device times, the plain version's time and
    the bound; timed with the L2 flushed before each call."""
    from ngp_pl_torch.benchmarking.field_tail_gates import k7_error
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_ms, time_ms
    from ngp_pl_torch.ops import field_tail as ft

    P, ws = args[0].shape[0], args[2:]
    got = ft.field_tail_cuda(*args)
    torch.cuda.synchronize()
    err = k7_error(got, ft.field_tail_plain(*args))
    err64 = k7_error(got, ft.field_tail_plain(*args, acc=torch.float64))
    if not (err <= K7_TOL and err64 <= K7_TOL):
        raise AssertionError(f"K7 disagrees at P={P}: {err} against "
                             f"the f32 plain version, {err64} against "
                             f"float64 sums")
    del got
    ms = time_ms(lambda: ft.field_tail_cuda(*args), flush=True)
    dev_ms = device_ms(lambda: ft.field_tail_cuda(*args),
                       (KERNEL_NAMES["K7"],), flush=True)
    plain_ms = time_ms(lambda: ft.field_tail_plain(*args), flush=True)
    nbytes = P * (64 * 4 + 16 * 4 + 4 + 12) + sum(w.numel() for w in ws) * 4
    flops = 2.0 * P * sum(w.shape[0] * w.shape[1] for w in ws)
    bound_ms, bound_by = bound(nbytes, flops, 0.0)
    return dict(max_abs_err=err, tol_abs=K7_TOL,
                max_abs_err_vs_float64_sums=err64, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / dev_ms, n=P,
                bytes=nbytes, flops=flops)


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
    gradient written once, which is the fill's write.  Every timed call
    finds the L2 flushed."""
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
    ms = time_ms(call, flush=True)
    dev_ms, call_dev_ms = device_split_ms(call, (KERNEL_NAMES[key],),
                                          flush=True)
    plain_ms = time_ms(lambda: he.hash_encode_bwd_plain(x, gr, w1, spec),
                       flush=True)
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

    ws = [ngp.sigma_mlp[1].detach()] + [w.detach() for w in ngp.rgb_mlp]
    out = {}
    for P in (K8_N, POOL_N):
        args = (*(t.cuda() for t in tail_inputs(P, *K8_INPUTS, grads=True)),
                *ws)
        out[P] = _k8_record(torch, args)
        del args
        torch.cuda.empty_cache()
    return dict(out[K8_N], at_train_pool=out[POOL_N])


def _k8_record(torch, args):
    """K8 on (h1, sh, g_sigma, g_rgb, w2, wr1, wr2, wr3) against both plain
    versions (K8_F32_TOL, K8_TOL), times and bound; timed with the L2
    flushed before each call."""
    from ngp_pl_torch.benchmarking.roofline import bound
    from ngp_pl_torch.benchmarking.timing import device_ms, time_ms
    from ngp_pl_torch.ops import field_tail as ft

    P, ws = args[0].shape[0], args[4:]
    names = ("dh1", "dW2", "dWr1", "dWr2", "dWr3")
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
    ms = time_ms(lambda: ft.field_tail_bwd_cuda(*args), flush=True)
    dev_ms = device_ms(lambda: ft.field_tail_bwd_cuda(*args),
                       (KERNEL_NAMES["K8"], "field_tail_bwd_reduce"),
                       flush=True)
    plain_ms = time_ms(lambda: ft.field_tail_bwd_plain(*args), flush=True)
    nbytes = (P * (64 + 16 + 1 + 3 + 64) * 4
              + 2 * sum(w.numel() for w in ws) * 4)
    # multiply-adds per sample: the forward (7,360), the backward through
    # the layers (192 + 4,096 + 1,024 + 1,024) and the weight gradients
    # (7,360), all bf16 operands
    macs = 2 * sum(w.shape[0] * w.shape[1] for w in ws) + 192 + 4096 + 2048
    flops = 2.0 * P * macs
    bound_ms, bound_by = bound(nbytes, flops, 0.0)
    return dict(max_abs_err=max(abs_err.values()), abs_err=abs_err,
                max_rel_err=max(rel_err.values()), rel_err=rel_err,
                tol_rel=K8_F32_TOL,
                max_rel_err_vs_float64_sums=max(rel64.values()),
                rel_err_vs_float64_sums=rel64,
                tol_rel_vs_float64_sums=K8_TOL, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / dev_ms, n=P,
                bytes=nbytes, flops=flops)


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

    ds = dataset_dict["synthetic"](split="test", downsample=tcfg.downsample,
                                   device="cpu")
    return _crop_vs_cpu(torch, res.ngp, res.occ_grid, tcfg.render_config(),
                        ds.directions, ds.poses[0], ds.img_wh[0], n_rays)


def _crop_vs_cpu(torch, ngp, occ_grid, rcfg, directions, pose, w,
                 n_rays: int = 1024, make=None):
    """`n_rays` rays of the frame's centre (32 rows) through the round
    renderer with `rcfg` (or the renderer `make(model)` builds), on the
    card with the kernels and on the CPU with the plain versions, from the
    same parameters and grid: rgb and opacity within 5e-3
    (`reference_crop`'s limit)."""
    from ngp_pl_torch.models.ngp import NGP
    from ngp_pl_torch.models.rendering import RoundRenderer

    pose = torch.from_numpy(pose)
    rows = torch.arange(w // 2 - 16, w // 2 + 16)
    pix = (rows[:, None] * w + torch.arange(w // 2 - n_rays // 64,
                                            w // 2 + n_rays // 64)).reshape(-1)
    rd = torch.from_numpy(directions)[pix] @ pose[:, :3].T
    ro = pose[:, 3].expand(rd.shape).contiguous()
    cpu_ngp = NGP(ngp.cfg, device="cpu")
    cpu_ngp.load_params(ngp.params_numpy())
    make = make or (lambda model: RoundRenderer(model, rcfg))
    outs = []
    for model, dev in ((ngp, "cuda"), (cpu_ngp, "cpu")):
        r = make(model)
        outs.append(r.render_image(occ_grid.to(dev), ro.to(dev),
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

    from ngp_pl_torch.ops.hash_encoding import XGRAD_CALLS

    kernels = []
    for ev in prof.key_averages():
        # a profiler range shows on the device too, spanning its kernels
        if ev.device_type != DeviceType.CUDA or ev.key in XGRAD_CALLS:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key))
    return sorted(kernels, reverse=True)


def profile_frame(torch, res, tcfg, top: int = 12):
    """One more 800x800 frame of view 0 under torch.profiler (again while
    the profile drops a kernel's records): device time by
    kernel, grouped into K1, K7 and the PyTorch kernels around them, and the
    device's idle share against the unprofiled frame time (1 / FPS)."""
    from ngp_pl_torch.datasets import dataset_dict
    from ngp_pl_torch.models.rendering import RoundRenderer

    ds = dataset_dict["synthetic"](split="test", downsample=tcfg.downsample,
                                   device="cuda")
    dirs = torch.from_numpy(ds.directions).cuda()
    pose = torch.from_numpy(ds.poses[0]).cuda()
    renderer = RoundRenderer(res.ngp, tcfg.render_config())
    return _profile_render(
        torch, lambda: renderer.render_pose(res.occ_grid, dirs, pose),
        1e3 / res.fps, top)


def _profile_render(torch, render, frame_ms, top: int = 12):
    """`render()` (one frame) under torch.profiler, again while the profile
    drops a kernel's records: device time by kernel, K1 and K7 apart, and
    the idle share against the unprofiled `frame_ms`."""
    from torch.profiler import ProfilerActivity, profile

    counters = _counters()
    for _ in range(PROFILE_TRIES):
        before = {k: c.launches for k, c in counters.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = render()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = _device_kernels(prof)
        busy = sum(k[0] for k in kernels)
        k1 = sum(k[0] for k in kernels if KERNEL_NAMES["K1"] in k[2])
        k7 = sum(k[0] for k in kernels if KERNEL_NAMES["K7"] in k[2])
        missing = _untimed(counters, before, {"K1": k1, "K7": k7})
        if not missing:
            break
    else:
        _fail_untimed(missing)
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


# A profiled window is taken again, up to PROFILE_TRIES in all, while a
# kernel that launched in it matched no device time: the profiler has been
# seen to drop a window's records on the card.
PROFILE_TRIES = 3


def _untimed(counters, before, device_ms) -> list:
    """The kernels that launched in a profiled window but matched no
    device time in its profile: renamed, or their records dropped."""
    return [key for key, ms in device_ms.items()
            if counters[key].launches - before[key] and not ms > 0.0]


def _fail_untimed(missing) -> None:
    """A renamed kernel cannot read 0 ms: raise once every window missed."""
    raise AssertionError(
        f"{missing} launched, but none of {PROFILE_TRIES} profiles matched "
        f"device time to {[KERNEL_NAMES[k] for k in missing]}")


def sync(dev) -> None:
    """`ngp_pl_torch.device.sync`, imported once the repo is on sys.path."""
    from ngp_pl_torch.device import sync as fence

    fence(dev)


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


def path_kernels(ngp):
    """The hand kernels a train step of this model launches: the encode
    forward and its table gradient by F, then, where the fused tail runs
    (the Sigmoid head), the field tail and its backward; none with the
    position gradient (`--optimize_ext`), as in the JAX package.  A render
    launches the first and, with the fused tail, the third."""
    if ngp.need_x_grad:
        return ()
    enc = ("K3", "K4") if ngp.cfg.n_features_per_level == 2 else (
        "K1", "K2+K5")
    return enc + (("K7", "K8") if ngp.use_fused else ())


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
        """The block, its layout, budget and chain, the grid's occupied
        share per cascade after its refresh and two CUDA events around it,
        kept on the device: reading them here would fence every block."""
        layout, S, chain = system.layout, system._pool_mult, \
            system.step_chain()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = step_block()
        ev[1].record()
        occ = system.grid_state.occ_grid
        blocks.append((system._host_step, layout, S, chain,
                       {k: m[k] for k in BLOCK_KEYS},
                       occ.reshape(occ.shape[0], -1).float().mean(1), ev))
        return m

    system.step_block = recorded_block
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        hist = system.fit(max_steps=steps, log_every=128, quiet=True)
    finally:
        del system.step_block
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    first, last = hist[0], hist[-1]
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss: {[h['loss'] for h in hist]}")
    if system.layout == "csr" and not last["loss"] < first["loss"]:
        raise AssertionError(f"loss did not fall: {first['loss']} -> "
                             f"{last['loss']}")
    if torch.device(dev).type == "cuda" and not all(
            launches[k] > 0 for k in path_kernels(system.ngp)):
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


def _block_record(batch, step, layout, S, chain, m, occupied, ev):
    """One block of a fit: the layout, budget (the CSR pool's multiple or
    S) and chain it ran with; loss and PSNR; the share of the batch left
    out of the loss; samples per ray marched (rm, the block's largest) and
    composited (vr); rays alive after the last round and the slots of a
    rounds step; the grid's occupied share per cascade; the stream's time
    from the block's first launch to its last kernel's end (CUDA events,
    no fence) and the rays/s it makes."""
    v = {k: float(t) for k, t in m.items()}
    ms = ev[0].elapsed_time(ev[1])
    return dict(step=step, layout=layout, S=S, chain=chain,
                occupied_by_cascade=[float(o) for o in occupied],
                stream_ms=ms, rays_per_s=batch * 16 / ms * 1e3,
                loss=v["loss"],
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
    witnesses of `train_reference` (`benchmarking.plain`)."""
    from ngp_pl_torch.benchmarking.plain import plain_versions

    with plain_versions(*keys):
        yield


# The encode kernels miss their plain versions by up to 8.7e-7 of max |h1|
# on a train step's input (K1 at scale 4, call 4 of PR 11; K1 and K3 read
# <= 6.5e-7 elsewhere): the window of `h1_flips`.
H1_FLIP_WINDOW = 1e-6


@contextlib.contextmanager
def h1_flips(torch, window=H1_FLIP_WINDOW):
    """Within the block the plain encode returns h1 with every value that
    lies within `window` of max |h1| of a bf16 rounding midpoint reflected
    about that midpoint, so that the field tail's bf16 rounding of it goes
    the other way: every rounding flip an encode error of that size could
    cause, at once.  Enter it before `plain_on_card`, which takes the plain
    encode as it finds it."""
    from ngp_pl_torch.ops import hash_encoding as he

    real = he.hash_encode_fwd_plain

    def flipped(x, table, w1, spec, feats=None):
        h = real(x, table, w1, spec, feats)
        mid = ((h.view(torch.int32) & -65536) | 32768).view(torch.float32)
        near = (h - mid).abs() <= window * h.abs().max()
        return torch.where(near, 2.0 * mid - h, h)

    he.hash_encode_fwd_plain = flipped
    try:
        yield
    finally:
        he.hash_encode_fwd_plain = real


@contextlib.contextmanager
def h1_rounded_as(torch, key, seen: dict):
    """Within the block the plain encode returns its h1 with the bf16
    roundings of the encode kernel `key` (K1 or K3) on the same inputs:
    where the two round h1 to different bf16 values, the kernel's h1.  The
    kernel runs beside it on every call (counted on a stand-in, not on its
    wrapper); `seen` gathers the largest relative error of the kernel's h1
    and feats against the plain ones over the calls, and the count of
    values rounded differently.  Enter it before `plain_on_card`, which
    takes the plain encode as it finds it."""
    from ngp_pl_torch.ops import hash_encoding as he

    entry, F = {"K1": ("hash_encode_fwd", 4),
                "K3": ("hash_encode_fwd_f2", 2)}[key]
    real = he.hash_encode_fwd_plain

    def stand_in():
        pass

    stand_in.launches = 0
    seen.update(h1_max_rel_err=0.0, feats_max_rel_err=0.0, bf16_flips=0)

    def rounded(x, table, w1, spec, feats=None):
        h = real(x, table, w1, spec, feats)
        fk = None if feats is None else torch.empty_like(feats)
        hk = he._launch_fwd(stand_in, entry, F, x, table, w1, spec, fk)
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa
        seen["h1_max_rel_err"] = max(seen["h1_max_rel_err"], rel(hk, h))
        if feats is not None:
            seen["feats_max_rel_err"] = max(seen["feats_max_rel_err"],
                                            rel(fk, feats))
        flip = hk.to(torch.bfloat16) != h.to(torch.bfloat16)
        seen["bf16_flips"] += int(flip.sum())
        return torch.where(flip, hk, h)

    he.hash_encode_fwd_plain = rounded
    try:
        yield
    finally:
        he.hash_encode_fwd_plain = real


@contextlib.contextmanager
def k7_by_rounding(torch, seen: dict):
    """Within the block the plain field tail returns K7's own sigma and rgb
    (launched uncounted), and `seen` gathers over the calls how they
    compare with the plain tail that takes K7's bf16 roundings of its
    hidden layers (`field_tail_gates.tail_rounded_as`: K7 launched again
    on probe weights): the hidden values K7 rounds outside
    K7_ROUNDED_TOL's window (`out_of_window`), those it rounds to the
    other side (`flips`), those too small to read (`unread`), and the
    largest error of its rgb and log sigma (`max_rel_err`).  Enter it
    before `plain_on_card`, which takes the plain tail as it finds it."""
    from ngp_pl_torch.benchmarking import field_tail_gates as ftg
    from ngp_pl_torch.ops import field_tail as ft

    real = ft.field_tail_plain
    seen.update(out_of_window=0, flips=0, unread=0, max_rel_err=0.0,
                calls=0)

    def k7(h1, sh, w2, wr1, wr2, wr3):
        _, got = ftg.tail_rounded_as(
            lambda *a: ft.launch_k7(*a), h1, sh, w2, wr1, wr2, wr3,
            K7_ROUNDED_TOL)
        for k in ("out_of_window", "flips", "unread"):
            seen[k] += got[k]
        seen["max_rel_err"] = max(seen["max_rel_err"], got["max_rel_err"])
        seen["calls"] += 1
        return ft.launch_k7(h1, sh, w2, wr1, wr2, wr3)

    ft.field_tail_plain = k7
    try:
        yield
    finally:
        ft.field_tail_plain = real


# what must be identical in two train steps of one layout from one state:
# the pool, the strided block, or (rounds) what the rounds decided per ray
STEP_POOL = {"csr": ("ts", "ray_idx"), "strided": ("ts", "valid"),
             "rounds": ("rm_counts", "loss_mask")}


def _train_step_on(torch, system, model, dev, batch, grid_state=None):
    """Loss, gradients, pool and sample count of one train step of `model`
    on `dev` from the system's grid (or `grid_state`; its windows where
    the system marches with them), layout, budget and chain, on white
    under uniform steps and on black under exponential ones.  With the
    batch's exposure column the HDR head reads it; with pose refinement
    the rays come through a copy of the system's dR and dT on `dev`, whose
    gradients follow the parameters'."""
    from ngp_pl_torch.training.train_step import PoseRefinement, train_render

    rays_o, rays_d, target, noise, img, pix, exposure = batch
    extra = []
    if system.pose is not None:
        ds = system.train_dataset
        pose = PoseRefinement(len(ds.poses), system.tcfg.pose_lr, dev)
        with torch.no_grad():
            pose.dR.copy_(system.pose.dR)
            pose.dT.copy_(system.pose.dT)
        rays_o, rays_d = pose.rays(
            torch.from_numpy(ds.directions).to(dev)[pix.to(dev)],
            torch.from_numpy(ds.poses).to(dev), img.to(dev))
        extra = [pose.dR, pose.dT]
    gs = grid_state or system.grid_state
    win_rows = gs.win_rows.to(dev) if system.window_march else None
    bg = torch.full((3,), 1.0 if system.cfg.exp_step_factor == 0 else 0.0,
                    device=dev)
    res, loss_of = train_render(
        model, win_rows, rays_o.to(dev).contiguous(),
        rays_d.to(dev).contiguous(), noise.to(dev), bg,
        tcfg=system.tcfg, rcfg=system.rcfg, n_samples=system._pool_mult,
        chain_length=system.step_chain(), layout=system.layout,
        occ_grid=gs.occ_grid.to(dev),
        exposure=None if exposure is None else exposure.to(dev),
        unit_exposure_rgb=system.unit_exposure_rgb)
    loss = loss_of(target.to(dev))
    grads = torch.autograd.grad(loss, [w for _, _, w in model._slots()]
                                + extra)
    return dict(loss=float(loss.detach()), grads=[t.cpu() for t in grads],
                pool={k: res[k].cpu() for k in STEP_POOL[system.layout]},
                samples=int(res["rm_samples"]))


def _step_err(torch, names, got, ref, stepped=()):
    """Loss error relative to the reference's; per parameter, the largest
    gradient error over its largest gradient, and the error's L2 norm over
    the gradient's.  The parameters named in `stepped` have bf16 gradients
    (the PyTorch tail of the HDR and pose paths rounds them, as the JAX
    package's jitted `_mlp_apply` does): their largest error is read apart
    (`tail_grad_rel_err_max`, held to TAIL_TOL) and left out of
    `grad_rel_err_gate`, the other gradients' largest error."""
    grad = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(names, got["grads"], ref["grads"])}
    l2 = {n: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
          for n, a, b in zip(names, got["grads"], ref["grads"])}
    tail = [v for n, v in grad.items() if n in stepped]
    return dict(loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_rel_err=grad, grad_rel_err_max=max(grad.values()),
                grad_rel_err_gate=max(v for n, v in grad.items()
                                      if n not in stepped),
                tail_grad_rel_err_max=max(tail, default=0.0),
                grad_l2_err_max=max(l2.values()),
                pool_identical=all(torch.equal(got["pool"][k], ref["pool"][k])
                                   for k in ref["pool"]))


def explicit_batch(torch, system, seed, n_rays, exposure=False):
    """(rays_o, rays_d, target, noise, img, pix, exposure) on the host:
    n_rays pixels of the system's train views, the march noise and, with
    `exposure`, an exposure column of 0.25-4 per ray (log-uniform), drawn
    from `seed`; exposure None otherwise."""
    from ngp_pl_torch.datasets.ray_utils import get_rays

    ds = system.train_dataset
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, len(ds.poses), (n_rays,), generator=g)
    pix = torch.randint(0, ds.directions.shape[0], (n_rays,), generator=g)
    rays_o, rays_d = get_rays(torch.from_numpy(ds.directions)[pix],
                              torch.from_numpy(ds.poses)[img])
    noise = torch.rand((n_rays,), generator=g)
    expo = (torch.exp((torch.rand((n_rays, 1), generator=g) * 2.0 - 1.0)
                      * math.log(4.0)) if exposure else None)
    return (rays_o.contiguous(), rays_d.contiguous(),
            system.rays[img.to(system.dev), pix.to(system.dev)][:, :3].cpu(),
            noise, img, pix, expo)


def train_reference(torch, system, cpu_tol, card_tol, seeds=(7,),
                    n_rays=2048, alone=(), alone_tol=None,
                    cpu_floor_by_witness=False, encode_floor_by_witness=False,
                    encode_by_rounding=False, witness_reading=False,
                    exposure=False, check=True):
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
    kernels named in `alone` are held to `alone_tol` there, unless
    `encode_by_rounding` is set: then the encode kernel among them is held
    by its rounding gate and the others inside `card_gate`, as every
    other kernel, and their records alone decide nothing (`alone_held`).
    `cpu_tol`, `card_tol` and `alone_tol` are (loss, gradient) limits.

    With `cpu_floor_by_witness`, a batch whose card step misses the CPU's
    past `cpu_tol` while the card's step with no hand kernel misses it past
    `cpu_tol` too (a loss at the rounding floor: the rounds layout's ~1e-10
    after a fit, see ROUNDS_NOTE) is held by its pool against the CPU and
    by `card_tol` against the plain versions on the card; the record says
    so (`cpu_gate`).  It decides the comparison with the CPU alone, and
    the options below the comparisons on the card alone, so that a state
    takes both: the rounds layout's fitted state is held against the CPU
    by this rule and on the card by `encode_by_rounding`.

    With `encode_floor_by_witness` (a fitted state) the encode kernel
    (K1 or K3) alone is held to the larger of `card_tol` and its own
    witness `witness_h1_flips`: the plain versions' step with every bf16
    rounding of h1 flipped that the encode kernel's measured error could
    flip (`h1_flips`), against the plain versions' own.  At a fitted state
    one such flip can move the table gradient by ~1e-2 of its max (a
    sample that dominates its row).  A step that misses the plain versions
    on the card past `card_tol` is then held as two parts: the encode
    kernel alone, so held, and every other kernel together, the kernels'
    step against the step with the encode kernel alone
    (`vs_encode_alone_on_card`, identical h1 on both sides), to
    `card_tol` itself (`card_gate`).  No other kernel, and no step, is
    held to the witness.

    With `encode_by_rounding` (every fitted scene, TRAINED_GATES, where
    the encode kernel alone has read up to 2.4x its witness) the encode
    kernel's h1 and feats are held within K1_TOL of the plain ones on every
    call of the step with its bf16 roundings of h1 (`h1_rounded_as`), and
    the encode kernel alone to `card_tol` against the plain versions'
    step, or else against that step with its roundings: the kernel then
    moves the step by nothing but bf16 roundings of values that it
    computed within its limit, and a kernel past its limit is refused
    whatever the step reads.  A step past `card_tol` is held as
    two parts as above (`card_gate`).  With K7 on the path, K7 is also
    held by its own error on every call of the step with the encode
    kernel and K7, the backward kernels plain (`k7_by_rounding`,
    `tail_rounded`): its hidden values before rounding and its outputs
    within K7_ROUNDED_TOL of the plain tail that takes its bf16 roundings.
    The other kernels' part of `card_gate` may then instead be held as
    the backward kernels (K8, K2+K5) against that step
    (`vs_encode_and_k7_on_card`) to `card_tol`: at a fitted state the loss
    (~5e-5) reads K7's f32 sums in another order at ~1e-4 of itself.  With
    `witness_reading` the witness `witness_h1_flips` is computed and
    logged beside that gate (with the
    encode kernel alone over it, `alone_over_witness`, and the verdict the
    witness gate would give, `witness_gate_pass`) and decides nothing.

    On the HDR and pose paths the tail's weight gradients are bf16
    (`_step_err`'s `stepped`), and with pose refinement dR and dT are
    gradients of the step too; `exposure` gives each batch an exposure
    column (`explicit_batch`).  With `check` a failed gate raises;
    without, the record says so (`passed`)."""
    from ngp_pl_torch.models.ngp import NGP

    cpu_ngp = NGP(system.cfg, device="cpu",
                  need_x_grad=system.ngp.need_x_grad)
    cpu_ngp.load_params(system.ngp.params_numpy())
    slots = list(system.ngp._slots())
    names = [f"{n}" if i is None else f"{n}[{i}]" for n, i, _ in slots]
    stepped = () if system.ngp.use_fused else tuple(
        name for (n, i, _), name in zip(slots, names)
        if n != "hash_table" and (n, i) != ("sigma_mlp", 0))
    if system.pose is not None:
        names += ["pose.dR", "pose.dT"]
    step_err = lambda *a: _step_err(*a, stepped=stepped)   # noqa: E731

    def within(err, tol):
        return (err["pool_identical"] and err["loss_rel_err"] <= tol[0]
                and err["grad_rel_err_gate"] <= tol[1]
                and err["tail_grad_rel_err_max"] <= max(tol[1], TAIL_TOL))

    batches, failed = [], False
    for seed in seeds:
        batch = explicit_batch(torch, system, seed, n_rays, exposure)
        ref = _train_step_on(torch, system, cpu_ngp, "cpu", batch)
        card = _train_step_on(torch, system, system.ngp, system.dev, batch)
        with plain_on_card("K7"):
            k7_plain = _train_step_on(torch, system, system.ngp, system.dev,
                                      batch)
        path = path_kernels(system.ngp)
        with plain_on_card(*path):
            plain = _train_step_on(torch, system, system.ngp, system.dev,
                                   batch)
        vs_cpu = step_err(torch, names, card, ref)
        vs_card = step_err(torch, names, card, plain)
        brief = ("loss_rel_err", "grad_rel_err_max", "grad_rel_err_gate",
                 "tail_grad_rel_err_max", "grad_l2_err_max")
        encode, flips, rest = (path or (None,))[0], None, None
        rounded = rounding = tail = None
        tail_ok = False
        encode_ok = True
        if encode_by_rounding:
            rounded = {}
            with h1_rounded_as(torch, encode, rounded), plain_on_card(*path):
                attributed = _train_step_on(torch, system, system.ngp,
                                            system.dev, batch)
        if encode_floor_by_witness or witness_reading:
            with h1_flips(torch), plain_on_card(*path):
                flips = {k: v for k, v in step_err(
                    torch, names, _train_step_on(
                        torch, system, system.ngp, system.dev, batch),
                    plain).items() if k in brief}
            encode_tol = (max(card_tol[0], flips["loss_rel_err"]),
                          max(card_tol[1], flips["grad_rel_err_max"]))

        vs_alone = {}
        for key in path:
            with plain_on_card(*(k for k in path if k != key)):
                one = _train_step_on(torch, system, system.ngp, system.dev,
                                     batch)
            vs_alone[key] = {k: v for k, v in step_err(
                torch, names, one, plain).items() if k in brief + (
                    "pool_identical",)}
            if key in alone and not encode_by_rounding:
                failed |= not within(vs_alone[key], alone_tol)
            if key == encode and flips is not None:
                witness_ok = within(vs_alone[key], encode_tol)
                failed |= encode_floor_by_witness and not witness_ok
                encode_ok = witness_ok
                rest = step_err(torch, names, card, one)
            if key == encode and rounded is not None:
                rounding = {k: v for k, v in step_err(
                    torch, names, one, attributed).items()
                    if k in brief + ("pool_identical",)}
                rounding_ok = (rounded["h1_max_rel_err"] <= K1_TOL
                               and rounded["feats_max_rel_err"] <= K1_TOL
                               and (within(vs_alone[key], card_tol)
                                    or within(rounding, card_tol)))
                failed |= not rounding_ok
                encode_ok = rounding_ok
                rest = step_err(torch, names, card, one)
                if "K7" in path:
                    tail = {}
                    with k7_by_rounding(torch, tail), plain_on_card(
                            *(k for k in path if k != key)):
                        fwd = _train_step_on(
                            torch, system, system.ngp, system.dev, batch)
                    rest_tail = {k: v for k, v in step_err(
                        torch, names, card, fwd).items()
                        if k in brief + ("pool_identical",)}
                    k7_ok = (tail["out_of_window"] == 0
                             and tail["max_rel_err"] <= K7_ROUNDED_TOL)
                    failed |= not k7_ok
                    tail_ok = k7_ok and within(rest_tail, card_tol)
        out = dict(seed=seed, samples=card["samples"],
                   loss_card=card["loss"], loss_cpu=ref["loss"],
                   vs_cpu=vs_cpu, vs_plain_on_card=vs_card,
                   alone_vs_plain_on_card=vs_alone,
                   witness_K7_plain_vs_cpu={
                       k: v for k, v in step_err(torch, names, k7_plain,
                                                  ref).items() if k in brief},
                   witness_all_plain_vs_cpu={
                       k: v for k, v in step_err(torch, names, plain,
                                                  ref).items() if k in brief},
                   **({"witness_h1_flips": flips, "encode_tol": encode_tol,
                       "alone_over_witness": (
                           vs_alone[encode]["grad_rel_err_max"]
                           / flips["grad_rel_err_max"]),
                       "witness_gate_pass": witness_ok}
                      if flips else {}),
                   **({"encode_rounded": rounded,
                       "vs_rounded_plain_on_card": rounding,
                       "rounding_gate_pass": rounding_ok}
                      if rounded is not None else {}),
                   **({"tail_rounded": tail, "k7_gate_pass": k7_ok,
                       "vs_encode_and_k7_on_card": rest_tail,
                       "tail_gate_pass": tail_ok}
                      if tail is not None else {}),
                   **({"vs_encode_alone_on_card": {
                       k: v for k, v in rest.items()
                       if k in brief + ("pool_identical",)}}
                      if rest is not None else {}))
        if (seed == seeds[0] and system.layout == "csr"
                and system.cfg.cascades == 1):
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
        card_ok = within(vs_card, card_tol)
        rest_ok = rest is not None and within(rest, card_tol)
        if not card_ok and rest is not None and encode_ok and (
                rest_ok or tail_ok):
            held = ("witness_h1_flips" if rounded is None else
                    "the limit against the plain versions with its bf16 "
                    "roundings of h1")
            against = (f"{encode} alone" if rest_ok else
                       f"{encode} and K7, K7 within K7_ROUNDED_TOL of "
                       f"the plain tail with its bf16 roundings")
            out["card_gate"] = (f"past the limit against the plain versions "
                                f"on the card: {encode} alone within "
                                f"{held}, the other kernels "
                                f"within the limit against {against}")
            card_ok = True
        failed |= not (cpu_ok and card_ok)
        batches.append(out)

    def worst(side, key):
        return max(b[side][key] for b in batches)

    out = dict(rays=n_rays, layout=system.layout,
               pool_mult=system._pool_mult,
               chain_length=system.step_chain(), cpu_tol=cpu_tol,
               card_tol=card_tol, alone=list(alone), alone_tol=alone_tol,
               alone_held=bool(alone) and not encode_by_rounding,
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
                   worst("witness_all_plain_vs_cpu", "grad_rel_err_max")])
    if encode_floor_by_witness or witness_reading:
        out["witness_h1_flips_max"] = [
            worst("witness_h1_flips", "loss_rel_err"),
            worst("witness_h1_flips", "grad_rel_err_max")]
    if encode_by_rounding:
        out.update(vs_rounded_plain_on_card_max=[
            worst("vs_rounded_plain_on_card", "loss_rel_err"),
            worst("vs_rounded_plain_on_card", "grad_rel_err_max")],
            encode_rounded_max={
                k: max(b["encode_rounded"][k] for b in batches)
                for k in batches[0]["encode_rounded"]})
    if encode_floor_by_witness or witness_reading or encode_by_rounding:
        out["vs_encode_alone_on_card_max"] = [
            worst("vs_encode_alone_on_card", "loss_rel_err"),
            worst("vs_encode_alone_on_card", "grad_rel_err_max")]
    if "tail_rounded" in batches[0]:
        out.update(vs_encode_and_k7_on_card_max=[
            worst("vs_encode_and_k7_on_card", "loss_rel_err"),
            worst("vs_encode_and_k7_on_card", "grad_rel_err_max")],
            tail_rounded_max={
                k: max(b["tail_rounded"][k] for b in batches)
                for k in batches[0]["tail_rounded"]})
    out.update(passed=not failed, batches=batches)
    if failed and check:
        raise AssertionError(f"card vs CPU train step disagrees: {out}")
    return out


def trained_gate(torch, system, scene, check=True, **kw):
    """`train_reference` from the fitted state of `scene` (a key of
    TRAINED_GATES) with that scene's gate; `kw` overrides its arguments."""
    return train_reference(torch, system,
                           **{**TRAINED_GATES[scene], **kw}, check=check)


def trained_render(torch, system, downsample=6.25):
    """Test view 0 at 800x800 of the trained field through the system's
    round renderer, on the system's scene (its scale and background): one
    warm-up frame, then one fenced frame."""
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.metrics import psnr, ssim

    scene = system.test_dataset
    ds = SyntheticDataset(split="test", downsample=downsample,
                          world_scale=scene.world_scale, bg=scene.bg,
                          device=system.dev)
    w, h = ds.img_wh
    dirs = torch.from_numpy(ds.directions).to(system.dev)
    pose = torch.from_numpy(ds.poses[0]).to(system.dev)
    renderer = system.renderer()
    occ = system.grid_state.occ_grid
    counters = _counters()
    with torch.no_grad():
        renderer.render_pose(occ, dirs, pose)
        for c in counters.values():
            c.launches = 0
        sync(system.dev)
        t0 = time.perf_counter()
        out = renderer.render_pose(occ, dirs, pose)
        sync(system.dev)
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
    """One more 16-step block under torch.profiler (another while the
    profile drops a kernel's records): device time of the
    path's four hand kernels, the PyTorch kernels around them, and the
    device's idle share against the unprofiled block time of the `train`
    phase.  A path runs one instance of each kernel template, so the
    kernel's name tells which of them ran."""
    from torch.profiler import ProfilerActivity, profile

    counters = _counters()
    for _ in range(PROFILE_TRIES):
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
                          or (key == "K8"
                              and "field_tail_bwd_reduce" in k[2]))
                 for key in path_kernels(system.ngp)}
        missing = _untimed(counters, before, parts)
        if not missing:
            break
    else:
        _fail_untimed(missing)
    return dict(block_ms_unprofiled=block_ms, block_ms_profiled=wall * 1e3,
                device_busy_ms=busy, idle_share=1.0 - busy / block_ms,
                kernels_ms=parts, other_kernels_ms=busy - sum(parts.values()),
                ranges=_range_ms(prof),
                launches_device=sum(k[1] for k in kernels),
                top=[{"ms": ms, "count": n, "name": name[:90]}
                     for ms, n, name in kernels[:16]])


def _range_ms(prof):
    """Calls and device ms of the port's profiler ranges in a profile
    (the x-grad encode's forward and backward, `XGRAD_CALLS`): the device
    time of the kernels launched inside each range."""
    from ngp_pl_torch.ops.hash_encoding import XGRAD_CALLS

    out = {}
    for ev in prof.key_averages():
        if ev.key in XGRAD_CALLS:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            got = out.setdefault(ev.key, {"calls": 0, "device_ms": 0.0})
            got["calls"] = max(got["calls"], ev.count)
            got["device_ms"] = max(got["device_ms"], us / 1e3)
    return out


def render_slice(torch, tcfg, views):
    """`evaluate` of the seeded model at 800x800: `views` test views, the
    counts from 0 just before, read just after; the path's encode kernel
    and K7 must launch."""
    from ngp_pl_torch.eval import evaluate

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = evaluate(tcfg, device="cuda", max_images=views, fps_frames=0)
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for img, opa in zip(res.images, res.opacities):
        if img.shape != (800, 800, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError("rendered image not finite (800, 800, 3)")
        if not (bool(torch.isfinite(opa).all()) and float(opa.min()) >= 0.0
                and float(opa.max()) <= 1.0 + 1e-6):
            raise AssertionError("opacity outside [0, 1]")
    fwd, _, tail, _ = path_kernels(res.ngp)
    if not (launches[fwd] > 0 and launches[tail] > 0):
        raise AssertionError(f"a kernel was not launched: {launches}")
    return res, {"views": len(res.images), "width": 800, "height": 800,
                 "fps": res.fps, "samples_per_ray": res.samples_per_ray,
                 "rounds_per_frame": res.rounds_per_frame, "psnr": res.psnr,
                 "ssim": res.ssim, "launches": launches, "seconds": seconds,
                 "note": "seeded init weights: rays do not terminate early, "
                 "so this is the march's worst case"}


def _build_tmp():
    """A temporary directory under the build directory (gitignored)."""
    from ngp_pl_torch import _build

    build_dir = _build.BUILD_DIR.parent
    build_dir.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=build_dir)


def ckpt_roundtrip(torch, res, tcfg):
    """Slim checkpoint of `res`'s model and grid, reloaded through the eval
    entry point: the re-render of view 0 must be identical."""
    from ngp_pl_torch.eval import evaluate
    from ngp_pl_torch.training.checkpoint import save_slim_checkpoint

    with _build_tmp() as tmp:
        path = os.path.join(tmp, "slim.npz")
        save_slim_checkpoint(path, params=res.ngp.params_numpy(),
                             occ_grid=res.occ_grid)
        res2 = evaluate(tcfg.replace(weight_path=path), device="cuda",
                        max_images=1, fps_frames=0)
    same = bool(torch.equal(res.images[0], res2.images[0]))
    if not same:
        raise AssertionError("re-render from the slim checkpoint differs")
    return {"identical": same,
            "hash_table": list(res.ngp.hash_table.shape)}


def train_path(torch, card, suffix, scene, seeded_tol=STEP_TOL, alone=(),
               at_step=True, seeded_cpu_tol=None, slim_path=None):
    """The train path of one fitted scene (a key of SCENE_CONFIGS): the
    seeded step against the CPU (limit `seeded_cpu_tol`, by default
    `seeded_tol`) and the plain versions (limit `seeded_tol`; the kernels
    named in `alone` each alone to STEP_TOL), `NeRFSystem.fit` (the counts
    from 0 just before, read just after), the trained step held by the
    scene's gate (`trained_gate`: the encode kernel by its own error and
    its bf16 roundings of h1, K7 by its own error, the witness
    `witness_h1_flips` logged beside), the trained field's 800x800 render
    and a profiled block.  Then, if
    `at_step`, the encode kernel and the
    table-gradient kernel on the input of one more train step
    (`table_grad_inputs.capture`: the CSR pool's positions and gradients,
    ray by ray, zero rows on its unused slots; in the strided layout the
    (N, S) block's, its invalid slots at their ray's origin with zero
    rows).  With `slim_path` the trained system's slim checkpoint is
    written there after the fit.  Returns the fit's record and the two
    kernels' records, by key."""
    from ngp_pl_torch.benchmarking.table_grad_inputs import capture
    from ngp_pl_torch.benchmarking.train_setup import (
        train_config,
        train_system,
    )

    tcfg = train_config(**SCENE_CONFIGS[scene])
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
    if slim_path:
        system.save_slim(slim_path)
    log({"phase": "train_reference" + suffix, "state": "trained",
         **trained_gate(torch, system, scene)})
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
    fwd, bwd = path_kernels(system.ngp)[:2]
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


MC_STEPS = 512                 # the scale-4 fit (bench_mc: 4096)


def capture_tail(system):
    """Copies of the arguments K7 and K8 receive in the next
    `system.step()`, which runs as usual.  The wrappers count their
    launches on the module's name, which holds the spy meanwhile: the
    step's launches land on the spy, not on the counts."""
    from ngp_pl_torch.ops import field_tail as ft

    seen = {}
    real = {"K7": ("field_tail_cuda", ft.field_tail_cuda),
            "K8": ("field_tail_bwd_cuda", ft.field_tail_bwd_cuda)}

    def spy(key):
        def call(*args):
            seen.setdefault(key, tuple(a.clone() for a in args))
            return real[key][1](*args)
        call.launches = 0
        return call

    try:
        for key, (attr, _) in real.items():
            setattr(ft, attr, spy(key))
        system.step()
    finally:
        for attr, fn in real.values():
            setattr(ft, attr, fn)
    return seen


def mc_path(torch, card):
    """The multi-cascade path (`bench_mc`'s scene and model: scale 4, four
    cascades, steps growing by 1/256, L8F4 at full width, 8 views of the
    scene scaled by 8 at 96x96 on black, `auto` layout): K1 and K2+K5 at
    random points of the scale-4 grid (finest level 8192); the seeded step
    against the CPU and the plain versions on the card; `fit` of MC_STEPS
    steps from the seed, counted from 0 just before, every block logged
    with the grid's occupied share per cascade and its rays/s; the trained
    step on TRAINED_BATCHES_MC; an 800x800 frame of the trained field and
    the test views' PSNR/SSIM; a profiled block; then K1 and K2+K5 on one
    more train step's input and K7 and K8 on the next one's.  Returns the
    fit's record and the kernels' records."""
    from ngp_pl_torch.benchmarking.bench_mc import bench_mc_system
    from ngp_pl_torch.benchmarking.table_grad_inputs import capture

    system = bench_mc_system("cuda", MC_STEPS)
    recs = {"K1": {"at_scale4": check_fwd(torch, system.ngp, "K1")},
            "K2+K5": {"at_scale4": check_bwd(torch, system.ngp, "K2+K5")}}
    for key, rec in recs.items():
        log({"phase": "kernels", "kernel": key, "geometry": "scale4",
             **rec["at_scale4"]})
    system.on_train_start()
    system._refresh_grid(0)
    log({"phase": "train_reference_mc", "state": "seeded",
         **train_reference(torch, system, STEP_TOL, STEP_TOL,
                           cpu_floor_by_witness=True)})
    del system
    torch.cuda.empty_cache()
    system = bench_mc_system("cuda", MC_STEPS)
    train = train_fit(torch, system, MC_STEPS)
    log({"phase": "train_mc", "card": card, "scale": system.cfg.scale,
         "cascades": system.cfg.cascades,
         "window_march": system.window_march, **train})
    log({"phase": "train_reference_mc", "state": "trained",
         **trained_gate(torch, system, "mc")})
    log({"phase": "trained_render_mc", "card": card,
         **trained_render(torch, system),
         "test_views": system.validate(save_images=False)})
    log({"phase": "profile", "of": "train_block_mc", "card": card,
         "layout": system.layout, "S": system._pool_mult,
         **profile_block(torch, system, train["block_ms"])})
    x, gr, w1 = capture(system)
    recs["K1"]["at_train_step_mc"] = _fwd_record(
        torch, "K1", x, system.ngp.encode_table(), w1, system.ngp.spec,
        with_feats=True)
    recs["K2+K5"]["at_train_step_mc"] = _bwd_record(
        torch, "K2+K5", x, gr, w1, system.ngp.spec)
    del x, gr, w1
    tail = capture_tail(system)
    recs["K7"] = {"at_train_step_mc": _k7_record(torch, tail["K7"])}
    recs["K8"] = {"at_train_step_mc": _k8_record(torch, tail["K8"])}
    for key, rec in recs.items():
        log({"phase": "kernels", "kernel": key, "input": "train_step_mc",
             "card": card, "pool_mult": system._pool_mult,
             "layout": system.layout, **rec["at_train_step_mc"]})
    del system, tail
    torch.cuda.empty_cache()
    return train, recs


HEAD_STEPS = 256               # the HDR and pose fits
FLAGSHIP_KERNELS = ("K1", "K2+K5", "K7", "K8")


def hdr_path(torch, card):
    """`--use_exposure` on the flagship, CSR pinned (`train_config`): the
    seeded step as `train_reference` holds the flagship's (the encode
    kernel held by its own witness, the CPU by the no-kernel witness:
    the tail's bf16 roundings move with the card's summation order), once
    more on a batch with an exposure column; HEAD_STEPS steps of `fit`,
    counted from 0 just before, K1 and K2+K5 launched and K7 and K8 not
    (JAX's fused tail covers the Sigmoid head only); the trained field's
    800x800 frame (K1 only) and a profiled block.  Returns the fit's
    record and the launches."""
    from ngp_pl_torch.benchmarking.train_setup import train_config, train_system

    tcfg = train_config(use_exposure=True)
    system = train_system(tcfg)
    system.on_train_start()
    system._refresh_grid(0)
    for seed, expo in ((7, False), (8, True)):
        log({"phase": "train_reference_hdr", "state": "seeded",
             "exposure_column": expo,
             **train_reference(torch, system, STEP_TOL, STEP_TOL,
                               seeds=(seed,), cpu_floor_by_witness=True,
                               encode_floor_by_witness=True,
                               exposure=expo)})
    del system
    torch.cuda.empty_cache()
    system = train_system(tcfg)
    train = train_fit(torch, system, HEAD_STEPS)
    bad = {k: train["launches"][k] for k in ("K7", "K8")
           if train["launches"][k]}
    if bad:
        raise AssertionError(f"the HDR path launched the fused tail: {bad}")
    log({"phase": "train_hdr", "card": card, **train})
    render = trained_render(torch, system)
    if not (render["launches"]["K1"] > 0 and render["launches"]["K7"] == 0):
        raise AssertionError(f"HDR render launches: {render['launches']}")
    log({"phase": "trained_render_hdr", "card": card, **render})
    log({"phase": "profile", "of": "train_block_hdr", "card": card,
         **profile_block(torch, system, train["block_ms"])})
    del system
    torch.cuda.empty_cache()
    return train


def pose_path(torch, card):
    """`--optimize_ext` on the flagship, CSR pinned: the seeded step on the
    card against the CPU (loss, every net gradient, dR and dT; the path
    has no hand kernel, so the plain versions on the card are the card's
    step itself); HEAD_STEPS steps of `fit`, counted from 0 just before,
    with rays/s and the allocator's peak; K1, K2+K5, K7 and K8 must launch
    0 times, as in the JAX package, where `need_x_grad` takes the XLA
    encode and tail: a launch would mean another function was computed;
    dR and dT norms; a profiled block with the x-grad encode's ranges.
    Returns the fit's record."""
    from ngp_pl_torch.benchmarking.train_setup import train_config, train_system

    tcfg = train_config(optimize_ext=True)
    system = train_system(tcfg)
    system.on_train_start()
    system._refresh_grid(0)
    log({"phase": "train_reference_pose", "state": "seeded",
         **train_reference(torch, system, STEP_TOL, STEP_TOL)})
    del system
    torch.cuda.empty_cache()
    system = train_system(tcfg)
    torch.cuda.reset_peak_memory_stats()
    train = train_fit(torch, system, HEAD_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launched = {k: train["launches"][k] for k in FLAGSHIP_KERNELS
                if train["launches"][k]}
    if launched:
        raise AssertionError(f"the pose path launched hand kernels, which "
                             f"compute another function: {launched}")
    norms = {k: float(torch.linalg.vector_norm(getattr(system.pose,
                                                      k).detach()))
             for k in ("dR", "dT")}
    if not (all(math.isfinite(v) and v > 0 for v in norms.values())):
        raise AssertionError(f"the poses did not move: {norms}")
    log({"phase": "train_pose", "card": card, "peak_allocated_bytes": peak,
         "pose_norms": norms, "pose_count": system.pose.opt.count, **train})
    torch.cuda.reset_peak_memory_stats()
    prof = profile_block(torch, system, train["block_ms"])
    log({"phase": "profile", "of": "train_block_pose", "card": card,
         "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **prof})
    del system
    torch.cuda.empty_cache()
    return train


# The disk scene: NeRF-Synthetic's train split (100 views at 800x800, the
# Blender loader's size), written from the procedural scene's ground truth;
# 8 test views (cut from 200) and 512 steps (cut from 30,000) for time
DISK_TRAIN_VIEWS, DISK_TEST_VIEWS, DISK_SIDE = 100, 8, 800
DISK_STEPS = 512
DISK_REDUCED = {"test_views": "8 of NeRF-Synthetic's 200",
                "steps": "512 of 30,000"}
# every decoded entry against the ground truth written: 8-bit colour and
# alpha (1/255), plus float32 rounding of the blend
DISK_STORE_TOL = 1 / 255 + 2 ** -20
DISK_POSE_TOL = 1e-6           # after the rub -> rdf remap and radius 1.5
HOST_STEPS = 64                # the host-batch fit
HOST_CHECKED_BATCHES = 16      # held bit-equal to the CPU's host sampler


@contextlib.contextmanager
def counts_at_fit_end(store: dict):
    """`NeRFSystem.fit` with the counts read into `store` when it returns,
    so a run through the train entry point tells its fit's launches from
    those of the validation after it."""
    from ngp_pl_torch.training.system import NeRFSystem

    real = NeRFSystem.fit

    def fit(self, *a, **k):
        out = real(self, *a, **k)
        store.update({key: c.launches for key, c in _counters().items()})
        return out

    NeRFSystem.fit = fit
    try:
        yield store
    finally:
        NeRFSystem.fit = real


def disk_path(torch, card, root):
    """`train_disk`: the Blender scene written under `root`, trained through
    `ngp_pl_torch.train.main` (CSR pinned, 512 steps, two test views scored
    and dumped), counts from 0 just before.  Gates: the store on the card
    within DISK_STORE_TOL of the ground truth written and bit-equal to the
    CPU's decode of the same files, the poses within DISK_POSE_TOL of the
    procedural ones, K1, K2+K5, K7 and K8 launched in the fit, every loss
    finite with no step skipped, both views' dumps written, and
    `ngp_pl_torch.eval.main` from the slim checkpoint scoring the two views
    (the trained step is held by `train_reference` after this).  Returns
    the system and the phase's record."""
    import numpy as np

    from ngp_pl_torch import eval as teval
    from ngp_pl_torch import train as ttrain
    from ngp_pl_torch.benchmarking.disk_scene import write_blender_scene
    from ngp_pl_torch.datasets.nerf import NeRFDataset
    from ngp_pl_torch.training.metrics import psnr

    scene = write_blender_scene(root, DISK_TRAIN_VIEWS, DISK_TEST_VIEWS,
                                DISK_SIDE, device="cuda")
    t0 = time.perf_counter()
    cpu = NeRFDataset(root, "train", 1.0, device="cpu")
    load_s = time.perf_counter() - t0
    for c in _counters().values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fit_counts = {}
    t0 = time.perf_counter()
    with _build_tmp() as tmp, contextlib.chdir(tmp), \
            counts_at_fit_end(fit_counts):
        system, scores = ttrain.main([
            "--dataset_name", "nerf", "--root_dir", root,
            "--train_layout", "csr", "--num_epochs", "1",
            "--iters_per_epoch", str(DISK_STEPS), "--max_images", "2",
            "--exp_name", "disk", "--num_devices", "1"])
        dumps = sorted(os.listdir(os.path.join("results", "nerf", "disk")))
        seconds = time.perf_counter() - t0
        served = teval.main([
            "--dataset_name", "nerf", "--root_dir", root, "--max_images",
            "2", "--weight_path", os.path.join(
                "ckpts", "nerf", "disk", "epoch=1_slim.npz")])
    peak = torch.cuda.max_memory_allocated()
    ds = system.train_dataset
    store_err = float((system.rays - scene["train_gt"]).abs().max())
    same_as_cpu = bool(torch.equal(system.rays.cpu(),
                                   torch.from_numpy(cpu.rays)))
    pose_err = float(np.abs(ds.poses - scene["train_poses"]).max())
    write_s = scene["seconds"]
    del scene, cpu
    hist = system.history
    failed = []
    if not store_err <= DISK_STORE_TOL:
        failed.append(f"store vs ground truth {store_err}")
    if not same_as_cpu:
        failed.append("the store differs from the CPU's decode")
    if not pose_err <= DISK_POSE_TOL:
        failed.append(f"poses {pose_err}")
    if not all(fit_counts[k] > 0 for k in FLAGSHIP_KERNELS):
        failed.append(f"launches {fit_counts}")
    if not (all(math.isfinite(h["loss"]) for h in hist)
            and hist[-1]["skipped_total"] == 0):
        failed.append(f"losses {[h['loss'] for h in hist]}, skipped "
                      f"{hist[-1]['skipped_total']}")
    if dumps != ["000.png", "000_d.png", "001.png", "001_d.png"]:
        failed.append(f"dumps {dumps}")
    if not (len(served.images) == 2 and math.isfinite(served.psnr)):
        failed.append(f"eval from the slim checkpoint: {served.psnr}")
    if failed:
        raise AssertionError(f"train_disk: {failed}")
    renderer = system.renderer()
    dirs = torch.from_numpy(system.test_dataset.directions).cuda()
    view_psnr = []
    for idx in range(2):
        item = system.test_dataset.test_item(idx)
        out = renderer.render_pose(system.grid_state.occ_grid, dirs,
                                   torch.from_numpy(item["pose"]).cuda())
        view_psnr.append(float(psnr(out["rgb"], item["rgb"])))
    rec = dict(
        card=card, train_views=DISK_TRAIN_VIEWS, test_views=DISK_TEST_VIEWS,
        side=DISK_SIDE, reduced=DISK_REDUCED,
        store_bytes=system.rays.numel() * 4, load_seconds=load_s,
        write_seconds=write_s, entry_point_seconds=seconds,
        rays_per_s=hist[-1]["rays_per_s"], loss={h["step"]: h["loss"]
                                                  for h in hist},
        skipped=hist[-1]["skipped_total"], layout=system.layout,
        pool_mult=system._pool_mult, chain_length=system.step_chain(),
        test_psnr=view_psnr, scores=scores, dumps=dumps,
        eval_from_slim={"psnr": served.psnr, "ssim": served.ssim,
                        "fps": served.fps,
                        "samples_per_ray": served.samples_per_ray},
        peak_allocated_bytes=peak, store_max_abs_err=store_err,
        store_tol=DISK_STORE_TOL, store_equals_cpu_decode=same_as_cpu,
        pose_max_abs_err=pose_err, pose_tol=DISK_POSE_TOL,
        launches=fit_counts)
    return system, rec


def host_batch_path(torch, card, tcfg, train_ds, test_ds):
    """`host_batches`: the disk scene's datasets in a new system of `tcfg`
    whose `device_dataset_max_bytes` is one byte short of the store, so the
    store stays on the host and each batch is drawn there and copied.
    HOST_STEPS steps of `fit`, counted from 0 just before; the first
    HOST_CHECKED_BATCHES batches on the card bit-equal to the dataset's
    host sampler run on the CPU from the same seed; the four kernels
    launched; the losses finite, none skipped; the host's seconds per
    step drawing and copying a batch."""
    import numpy as np

    from ngp_pl_torch.training.system import NeRFSystem

    store_bytes = train_ds.rays.nbytes
    tcfg = tcfg.replace(device_dataset_max_bytes=store_bytes - 1)
    hs = NeRFSystem(tcfg, device="cuda", train_dataset=train_ds,
                    test_dataset=test_ds)
    if hs.rays is not None:
        raise AssertionError("host_batches: the store went to the card")
    seen, host_s = [], []
    real = hs.sample_batch

    def spy():
        t0 = time.perf_counter()
        out = real()
        host_s.append(time.perf_counter() - t0)
        if len(seen) < HOST_CHECKED_BATCHES:
            seen.append([t.clone() for t in out])
        return out

    hs.sample_batch = spy
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    hist = hs.fit(max_steps=HOST_STEPS, log_every=16, quiet=True)
    sync("cuda")
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    rng = np.random.default_rng(tcfg.seed)
    sample_s, equal = [], []
    for img, pix, payload in seen:
        t0 = time.perf_counter()
        b = train_ds.sample_batch(rng)
        sample_s.append(time.perf_counter() - t0)
        equal.append(bool(
            np.array_equal(img.cpu().numpy(), b["img_idxs"])
            and np.array_equal(pix.cpu().numpy(), b["pix_idxs"])
            and np.array_equal(payload.cpu().numpy(), b["rgb"])))
    failed = []
    if len(seen) != HOST_CHECKED_BATCHES or not all(equal):
        failed.append(f"batches equal {equal}")
    if not all(launches[k] > 0 for k in FLAGSHIP_KERNELS):
        failed.append(f"launches {launches}")
    if not (all(math.isfinite(h["loss"]) for h in hist)
            and hist[-1]["skipped_total"] == 0):
        failed.append(f"losses {[h['loss'] for h in hist]}")
    if failed:
        raise AssertionError(f"host_batches: {failed}")
    rec = dict(card=card, steps=hs._host_step, batch=tcfg.batch_size,
               store_bytes=store_bytes,
               device_dataset_max_bytes=tcfg.device_dataset_max_bytes,
               batches_checked=len(equal), batches_equal=all(equal),
               host_ms_per_step=1e3 * float(np.mean(host_s[1:])),
               host_ms_first_step=1e3 * host_s[0],
               sample_ms_per_batch_cpu=1e3 * float(np.mean(sample_s)),
               seconds=seconds, rays_per_s=hist[-1]["rays_per_s"],
               loss={h["step"]: h["loss"] for h in hist},
               skipped=hist[-1]["skipped_total"], launches=launches)
    del hs
    torch.cuda.empty_cache()
    return rec


RESUME_STEPS = 256             # fitted before the save, and again after
BENCH_WARM_STEPS = 512         # the bench's warm-up here (its default: 2048)
BENCH_STEPS = 192
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _state_equal(torch, a, b):
    """Per part of the full train state, whether two systems hold equal
    tensors (params, Adam moments, each grid field) and counts."""
    out = {"params": all(torch.equal(x, y) for x, y in zip(
        a.optimizer.params, b.optimizer.params)),
           "mu": all(torch.equal(x, y) for x, y in zip(a.optimizer.mu,
                                                       b.optimizer.mu)),
           "nu": all(torch.equal(x, y) for x, y in zip(a.optimizer.nu,
                                                       b.optimizer.nu)),
           "count": a.optimizer.count == b.optimizer.count,
           "step": a._host_step == b._host_step}
    for name in ("density_grid", "count_grid", "occ_grid", "mean_density",
                 "win_rows"):
        out[name] = bool(torch.equal(getattr(a.grid_state, name),
                                     getattr(b.grid_state, name)))
    return out


def resume_path(torch):
    """The flagship fits RESUME_STEPS steps and saves a full checkpoint; a
    fresh system, which has run one step first (so that the encode's f16
    table copy and the field tail's packed weights are cached), loads it.
    Every tensor of the state must be equal; one train step on one
    explicit batch, with the saved system's layout, budget and chain, must
    agree between the two within TRAINED_KERNEL_TOL (K2+K5's reductions
    are not order-deterministic) with an identical pool; the loaded system
    then fits RESUME_STEPS more steps, finite, with no skipped step and
    every kernel of the path launched.  Returns (the loaded system, the
    `tensorboard` phase's record of that fit's event file, its record);
    the counts run from 0 at the start of the phase."""
    from ngp_pl_torch.benchmarking.train_setup import train_config, train_system

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    saved = train_system(train_config())
    saved.fit(max_steps=RESUME_STEPS, log_every=128, quiet=True)
    loaded = train_system(train_config())
    loaded.on_train_start()
    loaded.step()
    with _build_tmp() as tmp:
        path = os.path.join(tmp, "full.npz")
        saved.save(path)
        size = os.path.getsize(path)
        loaded.load(path)
    equal = _state_equal(torch, saved, loaded)
    if not all(equal.values()):
        raise AssertionError(f"the loaded state differs: {equal}")
    names = [n if i is None else f"{n}[{i}]"
             for n, i, _ in saved.ngp._slots()]
    batch = explicit_batch(torch, saved, 11, 2048)
    step_err = _step_err(
        torch, names,
        _train_step_on(torch, saved, loaded.ngp, saved.dev, batch,
                       grid_state=loaded.grid_state),
        _train_step_on(torch, saved, saved.ngp, saved.dev, batch))
    if not (step_err["pool_identical"]
            and step_err["loss_rel_err"] <= TRAINED_KERNEL_TOL[0]
            and step_err["grad_rel_err_max"] <= TRAINED_KERNEL_TOL[1]):
        raise AssertionError(f"the loaded system's step differs: {step_err}")
    restart = dict(layout=loaded.layout, pool_mult=loaded._pool_mult,
                   chain_length=loaded.chain_length)
    # the fit's TensorBoard record goes to logs/<dataset>/<exp> under a
    # directory of its own, and is read back by `tensorboard_record`
    with _build_tmp() as tmp, contextlib.chdir(tmp):
        hist = loaded.fit(max_steps=RESUME_STEPS, log_every=128, quiet=True)
        sync(loaded.dev)
        loaded._writer.close()
        tb = tensorboard_record(os.path.join(
            "logs", loaded.tcfg.dataset_name, loaded.tcfg.exp_name), hist,
            loaded.tcfg.batch_size)
    launches = {k: c.launches for k, c in counters.items()}
    last = hist[-1]
    if not (all(math.isfinite(h["loss"]) for h in hist)
            and last["skipped_total"] == 0
            and loaded._host_step == 2 * RESUME_STEPS
            and all(launches[k] > 0 for k in path_kernels(loaded.ngp))):
        raise AssertionError(f"the resumed fit failed: {hist}, {launches}")
    del saved
    torch.cuda.empty_cache()
    return loaded, tb, dict(
        steps_saved=RESUME_STEPS, checkpoint_bytes=size, equal=equal,
        step_vs_saved=step_err, tol=TRAINED_KERNEL_TOL,
        controller_after_load=restart,
        loss={h["step"]: h["loss"] for h in hist},
        psnr={h["step"]: h["psnr"] for h in hist},
        skipped=last["skipped_total"], steps=loaded._host_step,
        seconds=time.perf_counter() - t0, launches=launches)


# The event file of a fit (ngp_pl_torch/utils/events.py), read here with a
# CRC32C of this script's own (bit by bit, the Castagnoli polynomial) and a
# protobuf reader of the fields the writer uses.
TB_TAGS = ("train/loss", "train/psnr", "train/rm_s", "train/vr_s")


def _crc32c_bits(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
    return c ^ 0xFFFFFFFF


def _masked(c: int) -> int:
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(buf: bytes, i: int):
    v, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def _proto_fields(buf: bytes) -> dict:
    """field -> its values in a protobuf message: varints as ints, fixed64
    and fixed32 and length-delimited fields as bytes."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _varint(buf, i)
        wire = key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, i = buf[i:i + n], i + n
        elif wire == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise AssertionError(f"wire type {wire} in an event record")
        out.setdefault(key >> 3, []).append(v)
    if i != len(buf):
        raise AssertionError("a field runs past its message")
    return out


def tensorboard_record(logdir, hist, batch_size):
    """The one event file in `logdir`: every record's length and data
    CRCs, the first record's file_version, and the four scalars of each
    logged step, equal to `hist` as float32."""
    import struct

    import numpy as np

    files = os.listdir(logdir)
    if len(files) != 1 or not files[0].startswith("events.out.tfevents."):
        raise AssertionError(f"{logdir}: {files}")
    with open(os.path.join(logdir, files[0]), "rb") as f:
        data = f.read()
    records, at = [], 0
    while at < len(data):
        head = data[at:at + 8]
        (n,) = struct.unpack("<Q", head)
        (crc_len,) = struct.unpack("<I", data[at + 8:at + 12])
        body = data[at + 12:at + 12 + n]
        (crc_body,) = struct.unpack("<I", data[at + 12 + n:at + 16 + n])
        if (crc_len != _masked(_crc32c_bits(head)) or len(body) != n
                or crc_body != _masked(_crc32c_bits(body))):
            raise AssertionError(f"record {len(records)}: a CRC or length "
                                 f"is wrong")
        records.append(_proto_fields(body))
        at += 16 + n
    if records[0].get(3) != [b"brain.Event:2"]:
        raise AssertionError(f"first record: {records[0]}")
    got = {}
    for ev in records[1:]:
        for value in _proto_fields(ev[5][0])[1]:
            val = _proto_fields(value)
            got.setdefault(val[1][0].decode(), []).append(
                (ev.get(2, [0])[0], struct.unpack("<f", val[2][0])[0]))
    want = {"train/loss": [h["loss"] for h in hist],
            "train/psnr": [h["psnr"] for h in hist],
            "train/rm_s": [h["rm_samples"] / batch_size for h in hist],
            "train/vr_s": [h["vr_samples"] / batch_size for h in hist]}
    steps = [h["step"] for h in hist]
    if sorted(got) != sorted(TB_TAGS):
        raise AssertionError(f"tags {sorted(got)}")
    for tag in TB_TAGS:
        if ([s for s, _ in got[tag]] != steps
                or not np.array_equal(np.float32([v for _, v in got[tag]]),
                                      np.float32(want[tag]))):
            raise AssertionError(f"{tag}: {got[tag]} against {want[tag]} "
                                 f"at {steps}")
    return dict(file=files[0], bytes=len(data), records=len(records),
                tags=sorted(got), steps=steps,
                values={t: [v for _, v in got[t]] for t in TB_TAGS})


# Data parallelism on one card: a group of one NCCL rank in this process,
# then two gloo ranks spawned on this card (NCCL refuses two ranks on one
# device; gloo takes the CUDA tensors of every collective the port uses).
DDP_STEPS = 256                # the one-rank group's fit
DDP_ADAPTED_STEPS = 512        # its fit on, past grid warmup: the later state
DDP_PAIR_STEPS = 64            # the two ranks' steps after their check
DDP_RAYS = 8192                # the explicit global batch of the checks
DDP_SEED = 11
VALIDATE_TOL = 1e-6            # two ranks' validate means against one's


def ddp_path(torch, card, dev="cuda"):
    """(a) a process group of world size 1 over NCCL: the flagship fits
    DDP_STEPS steps through the data-parallel code (the gradient
    all-reduce, the gathered metrics), then one step's loss and gradients
    on an explicit global batch; a system outside any group loads its
    state and takes the same step: within TRAINED_KERNEL_TOL.  (b) two
    gloo ranks on this card load the same state: the same step over their
    two shards at a CSR pool with room (`scaling.ROOM_MULT`: the two
    ranks' pools then hold the one-rank pool's samples) within
    TRAINED_KERNEL_TOL of the one-rank step, and at the controller's own
    budget, where each rank's pool and staging budget bind on its own
    shard (ROADMAP §4), read and not held; their 2-view validate within
    VALIDATE_TOL of its means, then DDP_PAIR_STEPS
    more steps, after which parameters, moments and grids are torch.equal
    across the ranks, with the count of those steps on which a rank's pool
    was full; each rank launches K1, K2+K5, K7 and K8.  Then the same
    step at the controller's budget from the state that (a)'s fit reaches
    at DDP_ADAPTED_STEPS, after the controller has left the warmup
    budget: read against the no-group step, not held.  The
    path's launches are those of (a)'s fit, counted from 0 just before it,
    and of both ranks, counted from 0 at their start.  First, with no
    group, `scaling.pool_split`: how far 2 and 4 ranks' own budgets part
    from the global one on the seeded flagship's first step (ROADMAP §4).
    `dev="cpu"` rehearses it on the CPU (gloo, the plain versions: no
    launches)."""
    import torch.distributed as dist

    from ngp_pl_torch import parallel
    from ngp_pl_torch.benchmarking import scaling
    from ngp_pl_torch.benchmarking.train_setup import (
        train_config,
        train_system,
    )

    t0 = time.perf_counter()
    split = scaling.pool_split(dev=dev)
    counters = _counters()
    with _build_tmp() as tmp:
        path = os.path.join(tmp, "state.npz")
        path_b = os.path.join(tmp, "state_adapted.npz")
        dist.init_process_group(
            "nccl" if dev == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "store"), rank=0,
            world_size=1)
        try:
            system = train_system(train_config(), dev=dev)
            for c in counters.values():
                c.launches = 0
            hist = list(system.fit(max_steps=DDP_STEPS, log_every=128,
                                   quiet=True))
            sync(system.dev)
            fit_launches = {k: c.launches for k, c in counters.items()}
            step_a = scaling.explicit_grads(system, DDP_RAYS, DDP_SEED)
            ctl = step_a[2]
            system.save(path)
            system.fit(max_steps=DDP_ADAPTED_STEPS - DDP_STEPS,
                       log_every=128, quiet=True)
            step_b = scaling.explicit_grads(system, DDP_RAYS, DDP_SEED)
            ctl_b = step_b[2]
            system.save(path_b)
            names = [n if i is None else f"{n}[{i}]"
                     for n, i, _ in system.ngp._slots()]
            del system
        finally:
            dist.destroy_process_group()
        if not (all(math.isfinite(h["loss"]) for h in hist)
                and hist[-1]["skipped_total"] == 0 and all(
                    fit_launches[k] > 0 for k in FLAGSHIP_KERNELS)):
            raise AssertionError(f"ddp: the one-rank group's fit: {hist}, "
                                 f"{fit_launches}")
        plain = scaling.pair_system(dev)
        scaling.load_state(plain, path, ctl)
        plain_steps = {m: scaling.explicit_grads(plain, DDP_RAYS, DDP_SEED,
                                                 pool_mult=m)
                       for m in (None, scaling.ROOM_MULT)}
        scores = plain.validate(save_images=False)
        scaling.load_state(plain, path_b, ctl_b)
        plain_b = scaling.explicit_grads(plain, DDP_RAYS, DDP_SEED)
        del plain
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        parallel.launch(scaling.pair_run, 2,
                        (tmp, path, ctl, DDP_RAYS, DDP_PAIR_STEPS,
                         (path_b, ctl_b), dev),
                        device="cuda:0" if dev == "cuda" else "cpu",
                        backend="gloo", store_dir=tmp)
        pair = torch.load(os.path.join(tmp, "pair.pt"), weights_only=False)
    def err(got, ref):
        return dict(_step_err(torch, names,
                              dict(loss=got[0], grads=got[1], pool={}),
                              dict(loss=ref[0], grads=ref[1], pool={})),
                    samples=got[2]["samples"], slots=got[2]["slots"],
                    pool_mult=got[2]["pool_mult"])

    one = err(step_a, plain_steps[None])
    two = err(pair["steps"][scaling.ROOM_MULT],
              plain_steps[scaling.ROOM_MULT])
    two_own = err(pair["steps"][None], plain_steps[None])
    two_adapted = err(pair["adapted"], plain_b)
    val_err = {k: abs(pair["validate"][k] - v) / abs(v)
               for k, v in scores.items()}
    launches = {k: fit_launches[k] + sum(int(r.get(k, 0))
                                         for r in pair["launches"])
                for k in fit_launches}
    for name, err in (("one NCCL rank", one), ("two gloo ranks", two)):
        if not (err["loss_rel_err"] <= TRAINED_KERNEL_TOL[0]
                and err["grad_rel_err_max"] <= TRAINED_KERNEL_TOL[1]):
            raise AssertionError(f"ddp: {name} against no group: {err}")
    if not (pair["ranks_equal"] and pair["finite"]
            and set(val_err) == {"psnr", "ssim"}
            and max(val_err.values()) <= VALIDATE_TOL
            and all(r[k] > 0 for r in pair["launches"]
                    for k in FLAGSHIP_KERNELS)):
        raise AssertionError(f"ddp: two ranks: {pair}, {val_err}")
    return dict(
        card=card, per_rank_budgets_vs_global=split,
        steps_one_rank_group=DDP_STEPS,
        loss_one_rank_group={h["step"]: h["loss"] for h in hist},
        controller=ctl, rays=DDP_RAYS, tol=TRAINED_KERNEL_TOL,
        one_nccl_rank_vs_no_group=one, two_gloo_ranks_vs_no_group=two,
        two_gloo_ranks_vs_no_group_own_budget=two_own,
        adapted_steps=DDP_ADAPTED_STEPS, controller_adapted=ctl_b,
        two_gloo_ranks_vs_no_group_own_budget_adapted=two_adapted,
        pair_full_pool_steps=pair["full_pool_steps"],
        pair_csr_steps=pair["csr_steps"],
        pair_device=pair["device"], pair_steps=DDP_PAIR_STEPS,
        pair_ranks_equal=pair["ranks_equal"],
        pair_seconds=pair["seconds"], validate_no_group=scores,
        validate_two_ranks=pair["validate"], validate_rel_err=val_err,
        validate_tol=VALIDATE_TOL, launches_one_rank_group=fit_launches,
        launches_per_rank=pair["launches"], launches=launches,
        seconds_one_rank=t1 - t0, seconds=time.perf_counter() - t0)


def validate_dumps(torch, system):
    """`validate(save_images=True, max_images=1)` in a temporary working
    directory: both PNGs of view 0 exist, start with the PNG signature and
    carry the view's width and height in IHDR."""
    import struct

    w, h = system.test_dataset.img_wh
    t0 = time.perf_counter()
    with _build_tmp() as tmp, contextlib.chdir(tmp):
        scores = system.validate(save_images=True, max_images=1)
        seconds = time.perf_counter() - t0
        val_dir = os.path.join("results", system.tcfg.dataset_name,
                               system.tcfg.exp_name)
        files = sorted(os.listdir(val_dir))
        heads = {}
        for name in ("000.png", "000_d.png"):
            with open(os.path.join(val_dir, name), "rb") as f:
                heads[name] = f.read(24)
    for name, head in heads.items():
        if not (head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR"
                and struct.unpack(">II", head[16:24]) == (w, h)):
            raise AssertionError(f"{name} is not a {w}x{h} PNG: {head!r}")
    if files != ["000.png", "000_d.png"] or not all(
            math.isfinite(v) for v in scores.values()):
        raise AssertionError(f"validate: {files}, {scores}")
    return dict(width=w, height=h, files=files, seconds=seconds, **scores)


def bench_path(torch):
    """`ngp_pl_torch.benchmarking.bench` in this process with a shorter
    warm-up; the counts run from 0 just before."""
    from ngp_pl_torch.benchmarking import bench

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rec = bench.run(bench.bench_system("cuda", 8192, 0.5), BENCH_WARM_STEPS,
                    BENCH_STEPS)
    launches = {k: c.launches for k, c in counters.items()}
    if not (rec["value"] > 0 and all(
            launches[k] > 0 for k in ("K1", "K2+K5", "K7", "K8"))):
        raise AssertionError(f"bench: {rec}, {launches}")
    torch.cuda.empty_cache()
    return dict(rec, warm_steps=BENCH_WARM_STEPS, steps=BENCH_STEPS,
                seconds=time.perf_counter() - t0, launches=launches)


# The applications on a trained field (the flagship after `resume`'s 512
# steps, L16F2 after its fit): mesh extraction through the eval entry
# point, the viewer's screenshot, LPIPS and the reference-layout grid ops.
MESH_RES = 256                 # the eval CLI's default lattice
MESH_RES_L16F2 = 128
MESH_LEVEL = 20.0              # the eval CLI's default sigma level
MESH_CHUNK = 2 ** 17           # the density query's points per call
# The card's march of a density grid against the CPU's march of the same
# grid: the same f32 operations, divisions by tensors (IEEE on both), so
# faces identical and vertices within one ulp of 0.5 (world units).
MESH_VERT_TOL = 2.0 ** -24
# The density grid with the encode kernel against the plain versions on
# the card.  The kernel's h1 is held to K1_TOL of each call's max |h1| on
# every chunk of the lattice.  The sigma layer then reads relu(h1) in
# bf16, and an h1 one f32 ulp away from the plain one can round to the
# other bf16 neighbour, 2^-7 of itself away: so each cell's log sigma may
# move by up to 2^-7 sum_i |relu(h1_i) w_i0| (every input flipped), its
# `flip_bound`, and no further; cells whose side of the level flips lie
# within that bound of it.
MESH_FLIP_STEP = 2.0 ** -7
GUI_FRAMES = 4                 # timed viewer frames after the screenshot
GUI_CROP = 32                  # the crop held against the plain versions
LPIPS_SEED = 0
# LPIPS on the card against the CPU on the same inputs and seeded weights:
# TF32 is off (`device.resolve_device`), so only the convolutions'
# summation orders differ, as between XLA and oneDNN on the CPU, where the
# port reads within 2.8e-6 of JAX (tests/test_torch_lpips.py, limit 1e-4).
LPIPS_RTOL = 1e-4
INTEROP_RAYS = 65536


def mesh_path(torch, card, slim, geometry, resolution, key, dev="cuda"):
    """`ngp_pl_torch.eval.main` from the slim checkpoint with --mesh_path
    at `resolution` and MESH_LEVEL (one 128x128 view scored first).  The
    counts run from 0 at the start of `write_mesh` (the density query and
    the march) and are read at its end, beside the allocator's peak there.
    The card's mesh is held against the CPU's march of the same density
    grid (faces identical, vertices within MESH_VERT_TOL) and the grid
    against the plain versions on the card (h1 within K1_TOL on every
    chunk, log sigma within each cell's `flip_bound`); the encode kernel
    `key` is checked and
    timed on one MESH_CHUNK-point chunk of the lattice (`at_mesh_grid`).
    Returns the phase's record and the kernel's."""
    from ngp_pl_torch import eval as ev
    from ngp_pl_torch.utils import mesh as um

    counters = _counters()
    seen = {}
    write_mesh = ev.write_mesh

    def counted(ngp, path, res, level):
        for c in counters.values():
            c.launches = 0
        sync(dev)
        seen["allocated_before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = write_mesh(ngp, path, res, level)
        sync(dev)
        seen["peak_allocated"] = torch.cuda.max_memory_allocated()
        seen["launches"] = {k: c.launches for k, c in counters.items()}
        return out

    ev.write_mesh = counted
    try:
        with _build_tmp() as tmp:
            path = os.path.join(tmp, "mesh.ply")
            t0 = time.perf_counter()
            res = ev.main(["--weight_path", slim, "--mesh_path", path,
                           "--mesh_resolution", str(resolution),
                           "--mesh_threshold", str(MESH_LEVEL),
                           "--max_images", "1", "--device", str(dev),
                           *geometry])
            seconds = time.perf_counter() - t0
            file_bytes = os.path.getsize(path)
            with open(path) as f:
                head = [next(f).strip() for _ in range(6)]
    finally:
        ev.write_mesh = write_mesh
    m, ngp = res.mesh, res.ngp
    scale = ngp.cfg.scale
    values, verts, faces = m["values"], m["verts"], m["faces"]
    cpu_v, cpu_f = um.marching_tetrahedra(values.cpu(), MESH_LEVEL)
    cpu_v = um.to_world(cpu_v, resolution, scale)
    faces_equal = bool(torch.equal(faces.cpu(), cpu_f))
    vert_err = (float((verts.cpu() - cpu_v).abs().max())
                if faces_equal and len(cpu_v) else math.inf)
    pts = um.lattice(resolution, scale, dev)
    plain = torch.empty_like(values).reshape(-1)
    bound = torch.empty_like(plain)
    w0 = ngp.sigma_mlp[1][:, 0].detach().abs()
    h1_rel = 0.0
    with torch.no_grad():
        for i in range(0, len(pts), MESH_CHUNK):
            p = pts[i:i + MESH_CHUNK]
            h_k = ngp._h1(p)
            with plain_on_card(key):
                h_p = ngp._h1(p)
                plain[i:i + MESH_CHUNK] = ngp.density(p)
            h1_rel = max(h1_rel, float((h_k - h_p).abs().max()
                                       / h_p.abs().max()))
            bound[i:i + MESH_CHUNK] = MESH_FLIP_STEP * (
                torch.relu(h_p) * w0).sum(1)
    plain = plain.reshape(values.shape)
    bound = bound.reshape(values.shape)
    dlog = (torch.log(values) - torch.log(plain)).abs()
    rel = (values - plain).abs() / plain
    flips = (values > MESH_LEVEL) != (plain > MESH_LEVEL)
    past_bound = int((dlog > bound + 1e-6).sum())
    n_calls = -(-resolution ** 3 // MESH_CHUNK)
    launches = seen["launches"]
    mid = (n_calls // 2) * MESH_CHUNK
    kernel = _fwd_record(torch, key, ngp._xn(pts[mid:mid + MESH_CHUNK]),
                         ngp.encode_table(), ngp.sigma_mlp[0].detach(),
                         ngp.spec, with_feats=False)
    kernel["chunk"] = [mid, mid + MESH_CHUNK]
    rec = dict(
        card=card, resolution=resolution, level=MESH_LEVEL,
        verts=len(verts), faces=len(faces), query_s=m["query_s"],
        march_s=m["march_s"], seconds=seconds, file_bytes=file_bytes,
        ply_head=head, allocated_before=seen["allocated_before"],
        peak_allocated=seen["peak_allocated"],
        peak_over_before=seen["peak_allocated"] - seen["allocated_before"],
        vs_cpu_march=dict(faces_identical=faces_equal,
                          verts_max_abs_err=vert_err, tol=MESH_VERT_TOL),
        vs_plain_on_card=dict(
            h1_max_rel_err=h1_rel, h1_tol_rel=K1_TOL,
            sigma_max_rel_err=float(rel.max()),
            sigma_cells_rel_err_over_1e_5=int((rel > 1e-5).sum()),
            log_sigma_max_abs_err=float(dlog.max()),
            flip_bound_max=float(bound.max()),
            cells_past_flip_bound=past_bound,
            level_flips=int(flips.sum())),
        density_calls=n_calls, launches=launches)
    failed = []
    if not (faces_equal and vert_err <= MESH_VERT_TOL and len(faces) > 0):
        failed.append("the card's mesh differs from the CPU's march")
    if not (h1_rel <= K1_TOL and past_bound == 0):
        failed.append("the density grid differs from the plain versions")
    if launches[key] != n_calls or not bool(torch.isfinite(values).all()):
        failed.append(f"{key} launched {launches[key]} times, want "
                      f"{n_calls}, or the grid is not finite")
    if failed:
        raise AssertionError(f"mesh: {failed}: {rec}")
    del res, values, plain, bound, dlog, rel, flips, pts
    torch.cuda.empty_cache()
    return rec, kernel


def gui_path(torch, card, slim, dev="cuda"):
    """`ngp_pl_torch.show_gui.main --screenshot` at 800x800 from the slim
    checkpoint, the counts from 0 just before and read just after; then
    GUI_FRAMES more frames of `render_cam`, each fenced (`dt`); a
    GUI_CROP^2 crop of the frame's rays rendered by the viewer's renderer
    with the kernels and with the plain versions on the card, within
    reference_crop's limit."""
    import struct

    from ngp_pl_torch import show_gui
    from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    with _build_tmp() as tmp:
        png = os.path.join(tmp, "frame.png")
        gui = show_gui.main(["--ckpt_path", slim, "--downsample", "6.25",
                             "--screenshot", png, "--device", str(dev)])
        launches = {k: c.launches for k, c in counters.items()}
        with open(png, "rb") as f:
            head = f.read(24)
        png_bytes = os.path.getsize(png)
    w, h = gui.W, gui.H
    first_ms = gui.dt * 1e3
    frame_ms = []
    for _ in range(GUI_FRAMES):
        rgb = gui.render_cam(gui.cam)
        frame_ms.append(gui.dt * 1e3)
    rows = torch.arange(h // 2 - GUI_CROP // 2, h // 2 + GUI_CROP // 2)
    cols = torch.arange(w // 2 - GUI_CROP // 2, w // 2 + GUI_CROP // 2)
    pix = (rows[:, None] * w + cols).reshape(-1).to(dev)
    pose = torch.from_numpy(gui.cam.pose).to(dev)
    rd = gui._dirs[pix] @ pose[:, :3].T
    ro = pose[:, 3].expand(rd.shape).contiguous()
    outs = [gui.renderer.render_image(gui.occ_grid, ro, rd)]
    with plain_on_card("K1", "K7"):
        outs.append(gui.renderer.render_image(gui.occ_grid, ro, rd))
    err = {k: float((outs[0][k] - outs[1][k]).abs().max())
           for k in ("rgb", "opacity")}
    tol = 5e-3
    rec = dict(
        card=card, width=w, height=h, max_samples=128,
        t_threshold=gui.renderer.rcfg.test_t_threshold,
        chunk=gui.renderer.chunk, buckets=gui.renderer.buckets,
        window_rule=bool(segment_march_dmax_ok(
            gui._dirs.cpu().numpy(), grid_size=gui.ngp.cfg.grid_size,
            max_samples=128, scale=gui.ngp.cfg.scale)),
        screenshot_ms=first_ms, frame_ms=frame_ms,
        frame_ms_mean=sum(frame_ms) / len(frame_ms),
        samples_per_ray=gui.mean_samples, rounds=gui.rounds,
        png_bytes=png_bytes, png_signature_ok=head[:8] == PNG_SIGNATURE,
        png_size=list(struct.unpack(">II", head[16:24])),
        crop=dict(rays=int(pix.numel()), max_abs_err=err, tol=tol,
                  samples_kernels=outs[0]["total_samples"],
                  samples_plain=outs[1]["total_samples"]),
        launches=launches)
    if not (rec["png_signature_ok"] and rec["png_size"] == [w, h]
            and (w, h) == (800, 800) and launches["K1"] > 0
            and launches["K7"] > 0 and all(v <= tol for v in err.values())
            and bool(torch.isfinite(torch.from_numpy(rgb)).all())):
        raise AssertionError(f"gui: {rec}")
    del gui, outs
    torch.cuda.empty_cache()
    return rec


def lpips_path(torch, card, system, dev="cuda"):
    """LPIPS with seeded random weights (`init_random_weights`) on an
    800x800 pair made from a numpy seed, on the card: LPIPS(x, x) exactly
    0, the pair's value within LPIPS_RTOL of the CPU's on the same inputs,
    the fenced seconds of a first and a second call; then the trained
    system's `validate` with `eval_lpips` and those weights found through
    NGP_PL_TORCH_LPIPS_NPZ must return `lpips`."""
    import numpy as np

    from ngp_pl_torch.training import lpips as lp
    from ngp_pl_torch.training.metrics import LPIPS_ENV, LPIPSHook

    params = lp.init_random_weights(LPIPS_SEED, device=dev)
    rng = np.random.default_rng(LPIPS_SEED)
    a = rng.random((800, 800, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    x, y = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    secs = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        value = float(lp.lpips(params, x, y))
        secs.append(time.perf_counter() - t0)
    same = float(lp.lpips(params, x, x))
    t0 = time.perf_counter()
    cpu = float(lp.lpips({k: v.cpu() for k, v in params.items()},
                         x.cpu(), y.cpu()))
    cpu_s = time.perf_counter() - t0
    rel = abs(value - cpu) / abs(cpu)
    saved = os.environ.get(LPIPS_ENV)
    tcfg, hook = system.tcfg, system.lpips
    with _build_tmp() as tmp:
        path = os.path.join(tmp, "lpips.npz")
        lp.save_weights_npz(path, params)
        os.environ[LPIPS_ENV] = path
        try:
            system.tcfg = tcfg.replace(eval_lpips=True)
            system.lpips = LPIPSHook(system.dev)
            scores = system.validate(save_images=False)
        finally:
            system.tcfg, system.lpips = tcfg, hook
            if saved is None:
                os.environ.pop(LPIPS_ENV)
            else:
                os.environ[LPIPS_ENV] = saved
    rec = dict(card=card, size=[800, 800], seed=LPIPS_SEED, lpips=value,
               lpips_cpu=cpu, rel_err_vs_cpu=rel, tol_rel=LPIPS_RTOL,
               lpips_same=same, first_s=secs[0], second_s=secs[1],
               cpu_s=cpu_s,
               cudnn_tf32=bool(torch.backends.cudnn.allow_tf32),
               validate=scores)
    if not (same == 0.0 and rel <= LPIPS_RTOL and value > 0
            and math.isfinite(scores.get("lpips", math.nan))):
        raise AssertionError(f"lpips: {rec}")
    torch.cuda.empty_cache()
    return rec


def interop_path(torch, card, system, dev="cuda"):
    """The reference-layout grid ops and the multi-object intersections on
    the card, each bit-equal to the CPU on the same inputs: Morton codes of
    every cell of a 128^3 grid and of 2^20 random coords below 1024, and
    their inverses; the trained flagship's grid and a random four-cascade
    grid as bitfields; packbits/unpackbits of the trained density grid;
    INTEROP_RAYS rays (zero direction components on some) against 64 boxes
    and 64 spheres."""
    import dataclasses

    import numpy as np

    from ngp_pl_torch.config import NGPConfig
    from ngp_pl_torch.models.occupancy import export_bitfield
    from ngp_pl_torch.ops import grid_ops, intersection, morton

    rng = np.random.default_rng(0)
    out = {}

    def same(name, fn, *args):
        """fn on the card and on the CPU; torch.equal per output."""
        t0 = time.perf_counter()
        got = fn(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        want = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        out[name] = dict(equal=all(torch.equal(g.cpu(), w)
                                   for g, w in zip(got, want)),
                         shape=[list(g.shape) for g in got], card_ms=ms)

    r = torch.arange(128)
    cells = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                        -1).reshape(-1, 3)
    coords = torch.from_numpy(rng.integers(0, 1024, (1 << 20, 3)))
    same("morton3d_grid128", morton.morton3d, cells)
    same("morton3d_random", morton.morton3d, coords)
    same("morton3d_invert", morton.morton3d_invert,
         morton.morton3d(coords))
    state = system.grid_state
    same("export_bitfield_trained", lambda occ: export_bitfield(
        dataclasses.replace(state, occ_grid=occ), system.cfg),
         state.occ_grid)
    cfg4 = NGPConfig(scale=4.0)
    occ4 = torch.from_numpy((rng.random((4, 128, 128, 128)) < 0.3).astype(
        np.uint8))
    same("export_bitfield_c4", lambda occ: export_bitfield(
        dataclasses.replace(state, occ_grid=occ), cfg4), occ4)
    same("packbits", lambda g: grid_ops.unpackbits(grid_ops.packbits(
        g, float(state.mean_density))), state.density_grid.reshape(-1))
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (INTEROP_RAYS, 3)).astype(
        np.float32))
    d = torch.from_numpy(rng.normal(size=(INTEROP_RAYS, 3)).astype(
        np.float32))
    d[::7, 0] = 0.0
    c = torch.from_numpy(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    hs = torch.from_numpy(rng.uniform(0.05, 0.4, (64, 3)).astype(
        np.float32))
    same("ray_aabb_intersect", lambda *a: intersection.ray_aabb_intersect(
        *a, 8), o, d, c, hs)
    same("ray_sphere_intersect",
         lambda *a: intersection.ray_sphere_intersect(*a, 8), o, d, c, hs)
    if not all(v["equal"] for v in out.values()):
        raise AssertionError(f"interop: the card differs from the CPU: {out}")
    return dict(card=card, **out)


# The JAX repository's measurement and data scripts on the card: the render
# FPS at the yardstick's threshold (bench_fps), the eval entry point's FPS
# loop, the per-stage train-step profile and the RTMV preparation.
FPS_SIZE = 800
FPS_FRAMES = 5
FPS_TRAIN_STEPS = 1536         # benchmarking/bench_fps.py's default
PROFILE_WARM = 192             # benchmarking/profile_step.py's PROF_WARM
PROFILE_BATCH = 8192           # its PROF_BATCH
# the stages that partition a step: the march, the field's forward and
# backward, the compositor's, Adam, and a sixteenth of the grid refresh
STEP_PARTS = ("march (strided window)", "field fwd+bwd", "composite fwd+bwd",
              "adam update")
GRID_STAGE = "grid update (every 16 steps)"
FIXTURES = os.path.join(REPO, "tests", "fixtures")
RENDER_LINE = (r"^render: ([0-9.]+) FPS at (\d+)x(\d+) "
               r"\(([0-9.]+) samples/ray\)$")


def fps_path(torch, dev="cuda"):
    """`ngp_pl_torch.benchmarking.bench_fps` on the flagship: its fit
    (FPS_TRAIN_STEPS steps), then FPS_FRAMES fenced 800x800 frames of test
    pose 0 at T 1e-2; the counts from 0 just before the fit, read after the
    frames.  K1 and K7 must launch in the timed frames.  Then a 1024-ray
    crop of that frame on the card against the plain versions on the CPU
    (`_crop_vs_cpu`, reference_crop's limits) and one more frame under
    torch.profiler, by kernel (`_profile_render`).  `dev="cpu"` rehearses
    the phase, whose launch checks then fail by design.  Returns the
    phase's record and the trained system."""
    from ngp_pl_torch.benchmarking import bench_fps

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    system = bench_fps.fps_system(dev)
    loss = bench_fps.train(system, FPS_TRAIN_STEPS)
    train_s = time.perf_counter() - t0
    rec = bench_fps.run(system, FPS_SIZE, FPS_FRAMES)
    out = rec.pop("out")
    # the record, bench_fps's detail (the timed frames' launches apart) and
    # the phase's own counts
    phase = {"record": {k: rec[k] for k in bench_fps.RECORD_KEYS},
             **{k: v for k, v in rec.items()
                if k not in bench_fps.RECORD_KEYS and k != "launches"},
             "launches_timed_frames": rec["launches"],
             "train_steps": FPS_TRAIN_STEPS, "train_loss": loss,
             "train_seconds": train_s,
             "launches": {k: c.launches for k, c in counters.items()}}
    if not (rec["launches"]["K1"] > 0 and rec["launches"]["K7"] > 0
            and math.isfinite(loss) and rec["fps"] > 0
            and bool(torch.isfinite(out["rgb"]).all())):
        raise AssertionError(f"fps: {phase}")
    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, FPS_SIZE)
    render = bench_fps.renderer(system.ngp, system.rcfg, dirs,
                                bench_fps.frame_chunk(FPS_SIZE ** 2))
    occ = system.grid_state.occ_grid
    phase["crop"] = _crop_vs_cpu(torch, system.ngp, occ, render.rcfg, dirs,
                                 pose_t.cpu().numpy(), FPS_SIZE)
    phase["profile"] = _profile_render(
        torch, lambda: render.render_pose(occ, dirs_t, pose_t),
        rec["frame_ms"])
    return phase, system


SERVING_FRAMES = 2             # timed frames of each new renderer
SERVING_CROP_CHUNK = 1024      # the one-pass renderer's chunk in its crop


def _counted(run):
    """`run()` with every kernel's count set to 0 just before and read
    just after: (its result, the launches by kernel)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = run()
    return out, {k: c.launches for k, c in counters.items()}


def serving_paths(torch, card, system, dev="cuda"):
    """On `system` (fps_path's: the flagship after FPS_TRAIN_STEPS steps)
    and bench_fps's 800x800 frame at T 1e-2, each phase counted from 0 at
    its start and read at its end:
      test_renderer  `TestRenderer` (chunk 16,384, pool x64: K1 and K7 on
                     1,048,576 samples a chunk), SERVING_FRAMES fenced
                     frames after a warm one;
      host_rounds    `HostRoundRenderer` (the JAX package's host loop), as
                     test_renderer;
      each with a 1024-ray crop on the card against the CPU's plain
      versions (`_crop_vs_cpu`, 5e-3);
      fps_ablate     the full frame and the constant-field frame: K1 and K7
                     launch in the first and not at all in the second;
      debug_fps      the frame round by round (chunk 65,536): its rounds
                     and samples equal to `RoundRenderer(chunk=65536)`'s;
      fps_sweep      the JAX script's five ladders;
      tune_fps       its four schedules, then `--oneshot`'s four
                     `TestRenderer` configurations;
      micro_march    the windowed march's stages and the compaction's
                     steps at the JAX bench's shapes.
    Every field frame must launch K1 and K7 and give finite colours.
    Returns the launches by phase."""
    import dataclasses

    from ngp_pl_torch.benchmarking import (
        bench_fps,
        debug_fps,
        fps_ablate,
        fps_sweep,
        micro_march,
        tune_fps,
    )
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models.rendering import HostRoundRenderer, TestRenderer
    from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok

    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, FPS_SIZE)
    rays_o, rays_d = get_rays(dirs_t, pose_t)
    rays_o = rays_o.contiguous()
    occ = system.grid_state.occ_grid
    rcfg = dataclasses.replace(system.rcfg,
                               test_t_threshold=bench_fps.T_THRESHOLD)
    window = segment_march_dmax_ok(dirs, scale=system.cfg.scale)
    pixels = FPS_SIZE ** 2
    launches = {}

    def fired(lc):
        return lc["K1"] > 0 and lc["K7"] > 0

    makers = {
        "test_renderer": lambda m, chunk: TestRenderer(
            m, rcfg, chunk=chunk, use_window=window),
        "host_rounds": lambda m, chunk: HostRoundRenderer(m, rcfg)}
    for name, make in makers.items():
        render = make(system.ngp, 16384)
        t0 = time.perf_counter()
        (dt, out, timed), launches[name] = _counted(
            lambda: bench_fps.timed(
                lambda: render.render_image(occ, rays_o, rays_d), dev,
                SERVING_FRAMES))
        rec = dict(card=card, frame_ms=dt * 1e3, fps=1.0 / dt,
                   samples_per_ray=out["total_samples"] / pixels,
                   rounds=out.get("rounds"),
                   mean_opacity=float(out["opacity"].mean()),
                   launches_timed_frames=timed, launches=launches[name],
                   seconds=time.perf_counter() - t0,
                   crop=_crop_vs_cpu(
                       torch, system.ngp, occ, rcfg, dirs,
                       pose_t.cpu().numpy(), FPS_SIZE,
                       make=lambda m: make(m, SERVING_CROP_CHUNK)))
        log({"phase": name, **rec})
        if not (fired(timed) and bool(out["rgb"].isfinite().all())):
            raise AssertionError(f"{name}: {rec}")

    lines = []
    t0 = time.perf_counter()
    rec, launches["fps_ablate"] = _counted(
        lambda: fps_ablate.run(system, FPS_SIZE, emit=lines.append))
    frames = rec["frames"]
    log({"phase": "fps_ablate", **rec, "lines": lines,
         "launches": launches["fps_ablate"],
         "seconds": time.perf_counter() - t0})
    if not (fired(frames["full"]["launches"])
            and frames["const-field"]["launches"] == {"K1": 0, "K7": 0}
            and all(f["finite"] for f in frames.values())
            and math.isfinite(rec["field_share"])):
        raise AssertionError(f"fps_ablate: {rec}")

    lines = []
    t0 = time.perf_counter()
    rec, launches["debug_fps"] = _counted(
        lambda: debug_fps.run(system, FPS_SIZE, emit=lines.append))
    ref = bench_fps.renderer(system.ngp, system.rcfg, dirs,
                             debug_fps.CHUNK).render_pose(occ, dirs_t, pose_t)
    rec.update(lines=lines, launches=launches["debug_fps"],
               round_renderer={k: ref[k] for k in ("rounds",
                                                   "total_samples")},
               seconds=time.perf_counter() - t0)
    log({"phase": "debug_fps", **rec})
    if not (rec["rounds"] == ref["rounds"]
            and rec["total_samples"] == ref["total_samples"]
            and fired(launches["debug_fps"])):
        raise AssertionError(f"debug_fps: {rec}")

    lines = []
    t0 = time.perf_counter()
    rec, launches["fps_sweep"] = _counted(
        lambda: fps_sweep.run(system, FPS_SIZE, emit=lines.append))
    log({"phase": "fps_sweep", **rec, "lines": lines,
         "launches": launches["fps_sweep"],
         "seconds": time.perf_counter() - t0})
    if not all(fired(c["launches"]) and c["finite"]
               for c in rec["configs"].values()):
        raise AssertionError(f"fps_sweep: {rec}")

    lines = []
    t0 = time.perf_counter()
    (sched, oneshot), launches["tune_fps"] = _counted(lambda: (
        tune_fps.run(system, FPS_SIZE, emit=lines.append),
        tune_fps.run_oneshot(system, FPS_SIZE, emit=lines.append)))
    rec = dict(sched, **oneshot, lines=lines, launches=launches["tune_fps"],
               seconds=time.perf_counter() - t0)
    log({"phase": "tune_fps", **rec})
    if not all(fired(c["launches"]) and c["finite"] for c in
               list(sched["schedules"].values()) + oneshot["oneshot"]):
        raise AssertionError(f"tune_fps: {rec}")

    t0 = time.perf_counter()
    rec, launches["micro_march"] = _counted(
        lambda: micro_march.run(dev, log=io.StringIO()))
    log({"phase": "micro_march", "card": card, "stages": rec,
         "launches": launches["micro_march"],
         "seconds": time.perf_counter() - t0})
    if not all(v["device_ms"] > 0 and v["wall_ms"] > 0 for v in rec.values()):
        raise AssertionError(f"micro_march: {rec}")
    return launches


SHARD_FRAMES = 5               # fenced frames at each world size
SHARD_TOL = 1e-6               # the split frame against the one-rank frame
SHARD_VIEWS = 2                # the eval rank path's scored views
SYNTHETIC_SIDE = 128           # the synthetic scene's side at downsample 1


def shard_frame_path(torch, card, system, dev="cuda"):
    """(a), (b) and (c) of the `shard_frame` phase (module note) on
    `system` (fps_path's) and bench_fps's frame.  The phase's launches are
    this process's, counted from 0 at its start, and both ranks', counted
    from 0 at theirs.  Returns the phase's record."""
    import dataclasses
    import re

    import torch.distributed as dist

    from ngp_pl_torch import eval as ev
    from ngp_pl_torch import parallel
    from ngp_pl_torch.benchmarking import bench_fps, shard_frame

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    dirs, dirs_t, pose_t = bench_fps.frame_inputs(system, FPS_SIZE)
    chunk = bench_fps.frame_chunk(FPS_SIZE ** 2)
    rcfg = dataclasses.replace(system.rcfg,
                               test_t_threshold=bench_fps.T_THRESHOLD)
    occ = system.grid_state.occ_grid
    keys = ("rgb", "depth", "opacity")

    def frames(group=None):
        render = bench_fps.renderer(system.ngp, rcfg, dirs, chunk,
                                    group=group)
        dt, out, _ = bench_fps.timed(
            lambda: render.render_pose(occ, dirs_t, pose_t), dev,
            SHARD_FRAMES)
        return dt * 1e3, out, render.collectives / (SHARD_FRAMES + 1)

    one_ms, one, _ = frames()
    with _build_tmp() as tmp:
        slim = os.path.join(tmp, "fps_slim.npz")
        system.save_slim(slim)
        for sub in ("a", "b"):
            os.makedirs(os.path.join(tmp, sub))
        dist.init_process_group(
            "nccl" if dev == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "a", "store"), rank=0,
            world_size=1)
        try:
            group_ms, grouped, group_coll = frames(dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        bit_equal = (all(bool(torch.equal(grouped[k], one[k])) for k in keys)
                     and all(grouped[k] == one[k] for k in (
                         "rounds", "total_samples", "alive_rays")))
        cfg = system.cfg
        argv = ["--weight_path", slim,
                "--downsample", str(FPS_SIZE / SYNTHETIC_SIDE),
                "--n_levels", str(cfg.n_levels),
                "--n_features", str(cfg.n_features_per_level),
                "--log2_hashmap_size", str(cfg.log2_hashmap_size),
                "--max_images", str(SHARD_VIEWS), "--fps_frames",
                str(FPS_FRAMES), "--device", str(dev)]
        with contextlib.redirect_stdout(io.StringIO()):
            one_eval = ev.main(argv + ["--num_devices", "1"])
        here = {k: c.launches for k, c in counters.items()}
        t1 = time.perf_counter()
        parallel.launch(shard_frame.rank_run, 2,
                        (os.path.join(tmp, "b"), slim, system.cfg, rcfg, dirs,
                         pose_t.cpu().numpy(), SHARD_FRAMES, argv, dev),
                        device="cuda:0" if dev == "cuda" else "cpu",
                        backend="gloo", store_dir=os.path.join(tmp, "b"))
        ranks = [torch.load(os.path.join(tmp, "b", f"shard_rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    pair_seconds = time.perf_counter() - t1
    err = {k: max(float((r[k] - one[k].cpu()).abs().max()) for r in ranks)
           for k in keys}
    same = all(r[k] == one[k] for r in ranks
               for k in ("rounds", "total_samples", "alive_rays"))
    val_err = {k: abs(ranks[0]["eval"][k] - getattr(one_eval, k))
               / abs(getattr(one_eval, k)) for k in ("psnr", "ssim")}
    line = next((ln for ln in ranks[0]["eval"]["lines"]
                 if re.match(RENDER_LINE, ln)), None)
    rec = dict(
        card=card, size=FPS_SIZE, chunk=chunk, frames=SHARD_FRAMES,
        rounds=one["rounds"], total_samples=one["total_samples"],
        alive_rays=one["alive_rays"],
        one_nccl_rank_bit_equal=bit_equal,
        collectives_per_frame_one_nccl_rank=group_coll,
        collectives_per_frame_two_ranks=[r["collectives_per_frame"]
                                         for r in ranks],
        two_ranks_max_abs_err=err, tol=SHARD_TOL,
        two_ranks_rounds_samples_equal=same,
        frame_ms_no_group=one_ms, frame_ms_one_nccl_rank=group_ms,
        frame_ms_two_gloo_ranks_one_card=[r["frame_ms"] for r in ranks],
        launches_per_rank=[r["launches"] for r in ranks],
        launches_per_rank_frame=[r["launches_frame"] for r in ranks],
        eval_one_rank={k: getattr(one_eval, k) for k in (
            "psnr", "ssim", "fps", "fps_loop", "fps_loop_samples_per_ray")},
        eval_two_ranks={k: v for k, v in ranks[0]["eval"].items()
                        if k != "lines"},
        eval_lines_two_ranks=ranks[0]["eval"]["lines"],
        eval_rel_err=val_err, validate_tol=VALIDATE_TOL,
        pair_seconds=pair_seconds, seconds=time.perf_counter() - t0)
    rec["launches"] = {k: here[k] + sum(int(r["launches"].get(k, 0))
                                        for r in ranks) for k in here}
    if not (bit_equal and same and max(err.values()) <= SHARD_TOL
            and all(r["launches_frame"]["K1"] > 0
                    and r["launches_frame"]["K7"] > 0 for r in ranks)
            and max(val_err.values()) <= VALIDATE_TOL and line
            and (int(re.match(RENDER_LINE, line).group(2)),
                 int(re.match(RENDER_LINE, line).group(3)))
            == (FPS_SIZE, FPS_SIZE)):
        raise AssertionError(f"shard_frame: {rec}")
    return rec


ROUNDS_WARM = 128              # profile_rounds.py's PROF_WARM is 512
PROBE_RUNS = 3                 # timed calls of each probe part (JAX: 20)
PROBE_WARMUP = 1               # untimed calls before them (JAX: 3)
PROBE_BLOCK_RUNS = 1           # timed 16-step blocks a layout (JAX: 6)
ABLATE_STEPS = 128             # the script's --steps is 1536


def probe_paths(torch, card, dev="cuda"):
    """profile_rounds (the flagship at 8192 rays, rounds pinned, warmed
    ROUNDS_WARM steps), micro_field (262,144 points) and ablate_geom
    (L16F2, then L8F4, ABLATE_STEPS steps), PROBE_RUNS calls a part after
    PROBE_WARMUP and PROBE_BLOCK_RUNS blocks a layout (the scripts'
    defaults are the JAX scripts' 20, 3 and 6): each counted from 0 at its
    start.
    Every part must read a device time; profile_rounds and micro_field
    launch K1, K2+K5, K7 and K8, ablate_geom K3 and K4 in L16F2 and K1 and
    K2+K5 in L8F4.  Returns the launches by phase."""
    from ngp_pl_torch.benchmarking import (
        ablate_geom,
        micro_field,
        profile_rounds,
    )
    from ngp_pl_torch.benchmarking.profile_step import profile_system

    launches = {}
    t0 = time.perf_counter()
    rec, launches["profile_rounds"] = _counted(lambda: profile_rounds.run(
        profile_system(dev, PROFILE_BATCH, "rounds"), ROUNDS_WARM,
        runs=PROBE_RUNS, block_runs=PROBE_BLOCK_RUNS, warmup=PROBE_WARMUP,
        log=io.StringIO()))
    log({"phase": "profile_rounds", "card": card, **rec,
         "launches": launches["profile_rounds"],
         "seconds": time.perf_counter() - t0})
    if not (all(p["device_ms"] > 0 and p["wall_ms"] > 0
                for p in rec["parts"].values())
            and all(launches["profile_rounds"][k] > 0
                    for k in FLAGSHIP_KERNELS)):
        raise AssertionError(f"profile_rounds: {rec}")

    t0 = time.perf_counter()
    rec, launches["micro_field"] = _counted(lambda: micro_field.run(
        dev, runs=PROBE_RUNS, warmup=PROBE_WARMUP, log=io.StringIO()))
    log({"phase": "micro_field", "card": card, "parts": rec,
         "launches": launches["micro_field"],
         "seconds": time.perf_counter() - t0})
    if not (all(p["device_ms"] > 0 for p in rec.values())
            and all(launches["micro_field"][k] > 0
                    for k in FLAGSHIP_KERNELS)):
        raise AssertionError(f"micro_field: {rec}")

    t0 = time.perf_counter()
    lines = []

    def ablate():
        out = []
        for tag, n_levels, n_features in ablate_geom.GEOMETRIES:
            system = ablate_geom.system_for(n_levels, n_features,
                                            ABLATE_STEPS, dev, tag=tag)
            out.append(ablate_geom.run(tag, system, ABLATE_STEPS,
                                       log=None, emit=lines.append))
            del system
        return out

    recs, launches["ablate_geom"] = _counted(ablate)
    log({"phase": "ablate_geom", "card": card, "steps": ABLATE_STEPS,
         "runs": recs, "lines": lines, "launches": launches["ablate_geom"],
         "seconds": time.perf_counter() - t0})
    if not (len(lines) == 2
            and all(math.isfinite(r["psnr"]) and r["rays_per_s"] > 0
                    for r in recs)
            and all(launches["ablate_geom"][k] > 0
                    for k in ("K1", "K2+K5", "K3", "K4"))):
        raise AssertionError(f"ablate_geom: {recs}")
    return launches


def encode_errors(torch, spec, x, table, w1, g) -> dict:
    """The encode kernel (K1 or K3, by F) and the table-gradient kernel (K2
    + K5 or K4) on (x, table, w1, g) against their plain versions on the
    card: h1's and feats' error of max (K1_TOL) and the table gradient's
    (K2_TOL), by kernel; raises past either.  Launched through the
    uncounted entries, so that a phase's counts are its script's."""
    from ngp_pl_torch.ops import hash_encoding as he

    F = spec.n_features
    fwd, bwd = ("K3", "K4") if F == 2 else ("K1", "K2+K5")
    enc = he.encode_table(table, spec)
    stand_in = type("StandIn", (), {"launches": 0})()
    feats = torch.empty((x.shape[0], spec.out_dim), device=x.device)
    h1 = he._launch_fwd(stand_in, {4: "hash_encode_fwd",
                                   2: "hash_encode_fwd_f2"}[F], F, x, enc,
                        w1, spec, feats)
    feats_p = torch.empty_like(feats)
    h1_p = he.hash_encode_fwd_plain(x, enc, w1, spec, feats_p)
    d = he._launch_bwd(stand_in, {4: "hash_encode_bwd",
                                  2: "hash_encode_bwd_f2"}[F], F, x,
                       g.contiguous(), w1.contiguous(), spec)
    d_p = he.hash_encode_bwd_plain(x, g, w1, spec)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa
    out = {fwd: max(rel(h1, h1_p), rel(feats, feats_p)), bwd: rel(d, d_p)}
    if not (out[fwd] <= K1_TOL and out[bwd] <= K2_TOL):
        raise AssertionError(f"the encode kernels disagree: {out}")
    return out


def _checked_phase(card, launches, name, run, kernels, check):
    """One phase of the scripts' groups: `run()` counted from 0 (its
    launches into `launches[name]`), `check(record)` raising past a limit
    and returning what it held, the phase's line, then every kernel named
    in `kernels` launched, or with none named, no kernel at all."""
    t0 = time.perf_counter()
    rec, launches[name] = _counted(run)
    held = check(rec)
    log({"phase": name, "card": card, **rec, "held": held,
         "launches": launches[name], "seconds": time.perf_counter() - t0})
    fired = {k: v for k, v in launches[name].items() if v}
    if not (all(k in fired for k in kernels) if kernels else not fired):
        raise AssertionError(f"{name}: launches {launches[name]}")
    return rec


ENCODE_CHECK_RUNS = 3          # timed calls of each part (the scripts: 20)
ENCODE_CHECK_WARMUP = 1        # untimed calls before them (the scripts: 3)


def encode_check_paths(torch, card, dev="cuda"):
    """The JAX repository's encode and field-tail checks, each counted
    from 0 at its start, ENCODE_CHECK_RUNS calls a part: check_pallas_encode
    at L16F2 and L8F4 (its OK line; h1 within K1_TOL, the table gradient
    within K2_TOL of the plain versions), check_field_tail (its OK line;
    K7 within K7_TOL of both plain tails, K8 within K8_F32_TOL of the f32
    one), check_bwd_parts at F=4 and F=2, micro_encode_fwd and
    micro_encode_geom at N=262,144, each script's encode kernels held on
    its inputs (`encode_errors`).  Every kernel a script runs must launch.
    Returns the launches by phase."""
    from ngp_pl_torch.benchmarking import (
        check_bwd_parts,
        check_field_tail,
        check_pallas_encode,
        micro_encode_fwd,
        micro_encode_geom,
    )
    from ngp_pl_torch.ops.hash_encoding import init_hash_table

    quiet = dict(runs=ENCODE_CHECK_RUNS, warmup=ENCODE_CHECK_WARMUP,
                 log=io.StringIO())
    launches = {}

    def phase(*args):
        _checked_phase(card, launches, *args)

    def pallas_ok(rec):
        out = {}
        for r in rec["geometries"]:
            fwd, bwd = (("K3", "K4") if r["n_features"] == 2
                        else ("K1", "K2+K5"))
            out[fwd], out[bwd] = r["rel_err"]["fwd"], r["rel_err"]["d_table"]
            if not (r["ok"] and out[fwd] <= K1_TOL and out[bwd] <= K2_TOL):
                raise AssertionError(f"check_pallas_encode: {r}")
        return out

    phase("check_pallas_encode", lambda: {"geometries": [
        check_pallas_encode.run(L, F, dev, **quiet)
        for L, F in ((16, 2), (8, 4))]}, ("K1", "K3", "K2+K5", "K4"),
        pallas_ok)

    def tail_ok(rec):
        worst = max(v["vs_f32"] for v in rec["k8"].values())
        if not (rec["ok"] and rec["k7"]["vs_f32"] <= K7_TOL
                and rec["k7"]["vs_float64"] <= K7_TOL
                and worst <= K8_F32_TOL):
            raise AssertionError(f"check_field_tail: {rec}")
        return {"K7": rec["k7"], "K8_vs_f32": worst}

    phase("check_field_tail", lambda: check_field_tail.run(
        dev, limits={"K7_TOL": K7_TOL, "K8_F32_TOL": K8_F32_TOL,
                     "K8_TOL": K8_TOL}, out=io.StringIO()), ("K7", "K8"),
        tail_ok)

    def bwd_parts_ok(rec):
        out = {}
        for F, r in rec.items():
            spec = check_bwd_parts.geometry(int(F))
            x, table, w1, g = check_bwd_parts.inputs(spec, r["setup"]["n"],
                                                     dev)
            out[F] = {"random": encode_errors(torch, spec, x, table, w1, g),
                      "run_repeated": encode_errors(
                          torch, spec, check_bwd_parts.run_repeated_x(
                              r["setup"]["n"], dev), table, w1, g)}
        return out

    phase("check_bwd_parts", lambda: {
        str(F): check_bwd_parts.run(F, dev, **quiet) for F in (4, 2)},
        ("K1", "K3", "K2+K5", "K4"), bwd_parts_ok)

    def micro_fwd_ok(rec):
        spec = micro_encode_fwd.geometry()
        return encode_errors(torch, spec, *micro_encode_fwd.inputs(
            spec, 262144, dev))

    phase("micro_encode_fwd", lambda: {"stages": micro_encode_fwd.run(
        dev, **quiet)}, ("K1", "K2+K5"), micro_fwd_ok)

    def geom_ok(rec):
        out = {}
        for tag, spec in micro_encode_geom.geometries():
            gen = torch.Generator().manual_seed(1)
            x = torch.rand((262144, 3), generator=gen).to(dev)
            g = torch.randn((262144, 64), generator=gen).to(dev)
            table = init_hash_table(spec, gen).to(dev)
            w1 = (torch.randn((spec.out_dim, 64), generator=gen)
                  * 0.05).to(dev)
            out[tag] = encode_errors(torch, spec, x, table, w1, g)
        return out

    phase("micro_encode_geom", lambda: micro_encode_geom.run(dev, **quiet),
          ("K1", "K3", "K2+K5", "K4"), geom_ok)
    return launches


DIAG_BLOCKS = 6                # diag_demand's blocks (the script: 100)
DIAG_WARM = 96                 # diag_demand2's PROF_WARM (the script: 768)
HUNT_BLOCKS = 4                # nan_hunt's blocks (the script: 1024)


def train_diag_paths(torch, card, dev="cuda"):
    """The JAX repository's demand traces, NaN tools and pose-gradient
    check on bench.py's scene at full width, each counted from 0 at its
    start: diag_demand (DIAG_BLOCKS blocks) and diag_demand2 (DIAG_WARM
    steps), each block's nine demand fields finite; nan_hunt
    (HUNT_BLOCKS blocks, a snapshot before each), its last snapshot
    through nan_replay's file in a new system (the replayed block's loss
    beside the hunt's, logged: the card's training is not
    bit-reproducible), then nan_probe on the hunted state: every stage
    finite on both paths, the kernels' h1 within K1_TOL of the plain
    path's, K7 on the kernels' h1 held by its own bf16 roundings as on
    the trained steps (`tail_rounded_as`: no hidden value outside
    K7_ROUNDED_TOL's window, rgb and log sigma within K7_ROUNDED_TOL of
    the plain tail that takes those roundings; its rgb against the f32
    plain tail's, and the kernels' rgb against the plain path's, logged:
    on the hunted state one bf16 flip moves rgb by up to ~7e-3); dbg_pose's dR and dT gradients finite and
    nonzero at S=64 (at the JAX script's S=8, logged, no ray is in the
    loss).  K1, K2+K5, K7 and K8 must launch in every phase but dbg_pose,
    K1 and K7 in nan_probe, and none in dbg_pose.  Returns the launches by
    phase."""
    from ngp_pl_torch.benchmarking import (
        dbg_pose,
        diag_demand,
        diag_demand2,
        field_tail_gates,
        nan_hunt,
        nan_probe,
        nan_replay,
    )
    from ngp_pl_torch.benchmarking.bench import bench_system
    from ngp_pl_torch.models.ngp import NGP
    from ngp_pl_torch.ops import field_tail

    launches = {}

    def phase(*args):
        return _checked_phase(card, launches, *args)

    def demand_ok(rec):
        if not (rec["blocks"] and diag_demand.all_finite(rec["blocks"])):
            raise AssertionError(f"the demand vector: {rec}")
        return {"blocks_finite": len(rec["blocks"])}

    def demand(script, exp_name, size):
        lines = []
        system = bench_system(dev, 8192, exp_name=exp_name)
        return {"blocks": script.run(system, size, emit=lines.append),
                "lines": lines}

    phase("diag_demand", lambda: demand(diag_demand, "diag", DIAG_BLOCKS),
          FLAGSHIP_KERNELS, demand_ok)
    phase("diag_demand2", lambda: demand(diag_demand2, "diag2", DIAG_WARM),
          FLAGSHIP_KERNELS, demand_ok)

    system = nan_hunt.build_system(30, dev)

    def hunt():
        lines = []
        with _build_tmp() as tmp:
            path = os.path.join(tmp, "snap.npz")
            snap, block, losses, bad = nan_hunt.hunt(
                system, HUNT_BLOCKS * 16, log=lines.append)
            nan_hunt.save_snapshot(path, snap, steps=HUNT_BLOCKS * 16,
                                   epochs=30)
            replayed = nan_replay.replay(path, dev, log=lines.append)
            mb = os.path.getsize(path) / 1e6
        return {"blocks": HUNT_BLOCKS, "losses": losses, "non_finite": bad,
                "replayed_block": block,
                "replayed_losses": replayed["losses"],
                "loss_hunt": losses[-1], "loss_replay": replayed["losses"][-1],
                "snapshot_mb": mb, "lines": lines}

    def hunt_ok(rec):
        steps = rec["replayed_losses"]
        if rec["non_finite"] or not (
                len(steps) == 16 and all(math.isfinite(v) for v in steps)):
            raise AssertionError(f"nan_hunt: {rec}")
        return {"replayed_steps_finite": len(steps)}

    phase("nan_hunt", hunt, FLAGSHIP_KERNELS, hunt_ok)

    def k7_rounded(h1, sh, *ws):
        _, seen = field_tail_gates.tail_rounded_as(
            field_tail.launch_k7, h1, sh, *ws, K7_ROUNDED_TOL)
        return seen

    def probe_ok(rec):
        worst, k7 = rec["kernels_vs_plain"], rec["tail_check"]
        if not (rec["first_bad_leaf"] is None
                and not any(rec["first_bad_stage"].values())
                and worst["h1_max_rel_err"] <= K1_TOL
                and k7 is not None and k7["out_of_window"] == 0
                and k7["max_rel_err"] <= K7_ROUNDED_TOL):
            raise AssertionError(f"nan_probe: {rec}")
        return {**worst, "k7_by_rounding": k7}

    phase("nan_probe", lambda: nan_probe.probe(
        system, log=None, tail_check=k7_rounded), ("K1", "K7"), probe_ok)
    del system
    torch.cuda.empty_cache()

    def pose():
        ngp = NGP(dbg_pose.config()[0], seed=0, device=dev, need_x_grad=True)
        out = {}
        for S in (8, 64):
            r = dbg_pose.run(ngp, dev, n_samples=S)
            out[f"S{S}"] = {k: r[k] for k in ("dR_grad_max", "dT_grad_max",
                                              "loss", "rays_in_loss")}
        return out

    def pose_ok(rec):
        got = [rec["S64"][k] for k in ("dR_grad_max", "dT_grad_max")]
        if not all(math.isfinite(v) and v > 0 for v in got):
            raise AssertionError(f"dbg_pose: {rec}")
        return {"dR_dT_finite_nonzero": True}

    phase("dbg_pose", pose, (), pose_ok)
    return launches


MICRO_RUNS = 10                # timed and profiled calls of each label
MICRO_WARMUP = 1               # untimed calls before them (the scripts: 20, 3)
# micro_r2b's N (the script: 262,144): its inputs hold 2.7 GB draws, 20 s
# of the host's time at the script's N
MICRO_CUTS = {"micro_r2b": {"N": 65536}}
MICRO_R4_STEPS = 128           # micro_r4's fit (the script: 512)
TRAIN_QUICK_STEPS = 512        # train_quick's fit (the script: 2000)
MICRO_TOL = {"K6": K6_TOL, "K1": K1_TOL, "K3": K1_TOL, "K2+K5": K2_TOL}
# the kernels of each micro's `port: ` labels
MICRO_KERNELS = {"micro": ("K6", "K3", "K1"), "micro_r2": ("K6",),
                 "micro_r2b": (), "micro_r2c": ("K6",),
                 "micro_scatter": ("K6",)}


def _fit_ok(losses) -> bool:
    return (len(losses) >= 2 and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0])


def micro_paths(torch, card, phases, dev="cuda"):
    """The phases named in `phases` (the JAX repository's six primitive
    micros at their shapes, micro_r4, its quick-train script), in their
    order, each counted from 0 at its start: every label's wall ms and
    device ms finite (MICRO_RUNS calls after MICRO_WARMUP; the scripts'
    defaults are the JAX scripts' 20 and 3; micro_r2b cut by MICRO_CUTS);
    each `port: ` call against its primitive on the same input
    (MICRO_TOL; the port's compositor prefix, no kernel, logged) and its
    kernel launched, no kernel in micro_r2b; micro_r4's fit
    (MICRO_R4_STEPS steps) and
    train_quick's (TRAIN_QUICK_STEPS steps, then both test views scored
    and dumped into a temporary directory) launching K1, K2+K5, K7 and K8
    with a finite loss that falls.  Returns the launches by phase."""
    import numpy as np

    from ngp_pl_torch.benchmarking import (
        micro,
        micro_prims,
        micro_r2,
        micro_r2b,
        micro_r2c,
        micro_r4,
        micro_scatter,
        train_quick,
    )

    launches = {}
    quiet = dict(runs=MICRO_RUNS, warmup=MICRO_WARMUP, log=None)

    def timed_ok(labels, keys):
        return list(labels) == list(keys) and all(
            math.isfinite(r["wall_ms"]) and r["wall_ms"] > 0
            and r["device_ms"] is not None and math.isfinite(r["device_ms"])
            and r["device_ms"] > 0 for r in labels.values())

    def held(name, state, refs):
        out = {}
        errs = micro_prims.port_errors(state["fns"], refs)
        for label, (kernel, err) in errs.items():
            out[label] = {"kernel": kernel, "rel_err": err,
                          "tol": MICRO_TOL.get(kernel)}
            if kernel is not None and not err <= MICRO_TOL[kernel]:
                raise AssertionError(f"{name}: {label} {out[label]}")
        state.clear()
        return out

    def script(mod):
        name = mod.__name__.rsplit(".", 1)[1]
        state = {}

        def run():
            cut = MICRO_CUTS.get(name, {})
            inp = mod.inputs(dev, **cut)
            fns = mod.functions(inp)
            state.update(inp=inp, fns=fns)
            derived = mod.derived(inp) if hasattr(mod, "derived") else None
            return {"shapes": {**mod.SHAPES, **cut},
                    "labels": micro_prims.time_labels(
                        fns, dev, derived=derived, **quiet)}

        def check(rec):
            if not timed_ok(rec["labels"], mod.KEYS):
                raise AssertionError(f"{name}: {rec}")
            return held(name, state, mod.references(state["inp"],
                                                    state["fns"]))

        _checked_phase(card, launches, name, run, MICRO_KERNELS[name],
                       check)

    counters = _counters()
    state = {}

    def r4():
        t0 = time.perf_counter()
        system, fit = micro_r4.fit_system(dev, MICRO_R4_STEPS)
        fit["launches"] = {k: c.launches for k, c in counters.items()}
        fit["seconds"] = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        c = micro_r4.occupied_counts(
            system, *micro_r4.count_rays(system, micro_r4.SHAPES["batch"],
                                         rng)).cpu().numpy()
        inp = micro_r4.inputs(system, rng, micro_r4.SHAPES["N"])
        del system
        state.update(inp=inp, fns=micro_r4.functions(inp))
        return {"fit": fit, "counts": micro_r4.count_record(c),
                "count_lines": micro_r4.count_lines(c),
                "labels": micro_r4.time_parts(inp, dev, **quiet)}

    def r4_ok(rec):
        fit = rec["fit"]
        if not (_fit_ok(fit["losses"])
                and all(fit["launches"][k] > 0 for k in FLAGSHIP_KERNELS)
                and timed_ok(rec["labels"], micro_r4.KEYS)
                and rec["labels"][micro_r4.PORT_LABELS[0]][
                    "kernel_device_ms"] > 0):
            raise AssertionError(f"micro_r4: {rec}")
        return held("micro_r4", state, micro_r4.references(state["inp"],
                                                           state["fns"]))

    def quick():
        lines = []
        with _build_tmp() as tmp, contextlib.redirect_stdout(io.StringIO()):
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                rec = train_quick.run(dev, TRAIN_QUICK_STEPS,
                                      emit=lines.append)
            finally:
                os.chdir(cwd)
        return {**rec, "lines": lines}

    def quick_ok(rec):
        # the scores and seconds are logged, not held
        if not (_fit_ok(rec["logged_losses"])
                and all(rec["launches"][k] > 0 for k in FLAGSHIP_KERNELS)):
            raise AssertionError(f"train_quick: {rec}")
        return {"loss_falls": True}

    run_phase = {
        **{m.__name__.rsplit(".", 1)[1]: lambda m=m: script(m)
           for m in (micro, micro_r2, micro_r2b, micro_r2c, micro_scatter)},
        "micro_r4": lambda: _checked_phase(card, launches, "micro_r4", r4,
                                           FLAGSHIP_KERNELS, r4_ok),
        "train_quick": lambda: _checked_phase(
            card, launches, "train_quick", quick, FLAGSHIP_KERNELS,
            quick_ok)}
    for name in phases:
        run_phase[name]()
        torch.cuda.empty_cache()
    return launches


# Two children: in one process after `micro`, the profiler on the card
# held no record of a later label's calls three profiles running (twice:
# in micro_r2b's phase, and in micro_r2's), while `micro` and `micro_r2`
# alone, and the other five phases together, read every label.
def encode_micro_paths(torch, card):
    return micro_paths(torch, card, ("micro", "micro_r2"))


def other_micro_paths(torch, card):
    return micro_paths(torch, card, ("micro_r2b", "micro_r2c",
                                     "micro_scatter", "micro_r4",
                                     "train_quick"))


# the groups of phases that run each in a spawned process of its own
CHILD_GROUPS = {"probes": ("probe_paths",),
                "checks": ("encode_check_paths", "train_diag_paths"),
                "micros": ("other_micro_paths",),
                "micros_encode": ("encode_micro_paths",)}


def _probe_child(out: str, card: str, group: str) -> None:
    """The phases of CHILD_GROUPS[group] in a spawned process; their
    launches go to `out`."""
    import torch

    sys.path.insert(0, REPO)
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")
    launches = {}
    for name in CHILD_GROUPS[group]:
        launches.update(globals()[name](torch, card))
    with open(out, "w") as f:
        json.dump(launches, f)


def probes_in_child(card, group: str = "probes") -> dict:
    """The phases of CHILD_GROUPS[group] in a process of their own,
    spawned and joined here, their counts from 0 in it: late in a long
    process the profiler on the card has dropped every record of a window
    three times running (on an H100: in this process before the probes had
    a child, and in the probes' child once the checks ran after the
    probes), and these phases read device times.
    Returns the child's launches by phase."""
    import multiprocessing

    with _build_tmp() as tmp:
        out = os.path.join(tmp, "probes.json")
        child = multiprocessing.get_context("spawn").Process(
            target=_probe_child, args=(out, card, group))
        child.start()
        child.join()
        if child.exitcode != 0:
            raise AssertionError(f"{group}: the child exited with "
                                 f"{child.exitcode}")
        with open(out) as f:
            return json.load(f)


def eval_fps_path(torch, card, slim, dev="cuda"):
    """`ngp_pl_torch.eval.main` from the trained flagship's slim checkpoint
    at 800x800 (--downsample 6.25) with --fps_frames 5 --max_images 1: the
    JAX script's "render:" line is
    printed and `EvalResult.fps_loop` set; the counts from 0 just before
    and read just after; K1 and K7 must launch."""
    import io
    import re

    from ngp_pl_torch import eval as ev

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = ev.main(["--weight_path", slim, "--downsample", "6.25",
                       "--fps_frames", "5", "--max_images", "1",
                       "--device", str(dev)])
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    line = re.search(RENDER_LINE, buf.getvalue(), re.M)
    rec = dict(card=card, line=line.group(0) if line else None,
               fps_loop=res.fps_loop,
               fps_loop_samples_per_ray=res.fps_loop_samples_per_ray,
               fps_views=res.fps, psnr=res.psnr, ssim=res.ssim,
               seconds=seconds, launches=launches)
    if not (line and res.fps_loop and res.fps_loop > 0
            and (int(line.group(2)), int(line.group(3))) == (800, 800)
            and launches["K1"] > 0 and launches["K7"] > 0):
        raise AssertionError(f"eval_fps: {rec}, {buf.getvalue()[-500:]}")
    return rec


def profile_step_path(torch, card, layout, dev="cuda"):
    """`ngp_pl_torch.benchmarking.profile_step` of the flagship in `layout`
    at PROFILE_BATCH rays after PROFILE_WARM steps: every stage's fenced
    wall ms and device ms, and the sum of the stages that partition a step
    (STEP_PARTS and a sixteenth of the grid refresh) against the full step;
    the counts from 0 just before, read just after; K1, K2+K5, K7 and K8
    must launch."""
    from ngp_pl_torch.benchmarking import profile_step as ps

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    system = ps.profile_system(dev, PROFILE_BATCH, layout)
    rec = ps.run(system, layout, warm=PROFILE_WARM)
    launches = {k: c.launches for k, c in counters.items()}
    st = rec["stages"]
    full = st["full step"]
    # device ms exist on the card only
    clocks = [c for c in ("wall_ms", "device_ms") if full[c] is not None]
    parts = {clock: sum(st[k][clock] for k in STEP_PARTS)
             + st[GRID_STAGE][clock] / 16 for clock in clocks}
    out = dict(card=card, **rec,
               parts=list(STEP_PARTS) + [GRID_STAGE + " / 16"],
               parts_ms=parts,
               parts_share_of_full_step={
                   clock: parts[clock] / full[clock] for clock in parts},
               # a 16-step block: sixteen of each stage, one grid refresh
               block_device_ms={k: (1 if k == GRID_STAGE else 16)
                                * (v["device_ms"] or 0.0)
                                for k, v in st.items()},
               seconds=time.perf_counter() - t0, launches=launches)
    if not (len(clocks) == 2
            and all(math.isfinite(v[c]) and v[c] > 0 for v in st.values()
                    for c in clocks)
            and all(launches[k] > 0 for k in FLAGSHIP_KERNELS)):
        raise AssertionError(f"profile_step: {out}")
    del system
    torch.cuda.empty_cache()
    return out


EXR_TREES = {"rtmv_exr": 5, "rtmv_exr_piz": 3, "rtmv_exr_more": 6}
EXR_BIG = 1600                 # RTMV's frame side: the timed frames
EXR_SIDE = 256                 # the frames written by OpenEXR's encoder
# the ten methods of OpenEXR 2's encoder, by cv2's names for them
EXR_METHODS = {"NONE": "NO", "RLE": "RLE", "ZIPS": "ZIPS", "ZIP": "ZIP",
               "PIZ": "PIZ", "PXR24": "PXR24", "B44": "B44", "B44A": "B44A",
               "DWAA": "DWAA", "DWAB": "DWAB"}
# read_exr against OpenEXR's decoder (cv2.imread) on the same bytes, in
# half ulps of the values read: every method bit for bit, DWA's DCT
# channels too (its inverse DCT follows OpenEXR's SSE2 order, which
# OpenEXR 2.3 runs on this machine's x86-64 host)
EXR_ULP_GATE = 0


def _rtmv_tree(tree: str, tmp: str) -> dict:
    """`prepare_rtmv` on a copy of tests/fixtures/<tree>: its frames, each
    PNG equal to the committed one the JAX script wrote, the seconds per
    frame."""
    import glob
    import shutil

    import numpy as np

    from ngp_pl_torch.datasets.color_utils import read_png
    from ngp_pl_torch.misc import prepare_rtmv

    root = os.path.join(tmp, tree)
    shutil.copytree(os.path.join(FIXTURES, tree), root)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        prepare_rtmv.main(root)
    seconds = time.perf_counter() - t0
    pngs = {}
    for got in sorted(glob.glob(os.path.join(root, "*", "images", "*.png"))):
        scene = os.path.basename(os.path.dirname(os.path.dirname(got)))
        want = os.path.join(root, scene, "expected", os.path.basename(got))
        a, b = read_png(got), read_png(want)
        pngs[f"{scene}/{os.path.basename(got)}"] = bool(
            a.shape == b.shape and np.array_equal(a, b))
    n_exr = len(glob.glob(os.path.join(root, "*", "*.exr")))
    return dict(frames=n_exr, pngs=pngs,
                seconds_per_frame=seconds / max(n_exr, 1))


def _other_exr_reader():
    """(name, read) of an OpenEXR reader on this machine that is not the
    port's, read giving (H, W, C) float32 in R, G, B(, A) order; or (None,
    why there is none).  A cross-check of `read_exr`, never its
    fallback."""
    why = []
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
        import numpy as np

        def read_cv2(path):
            img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError("cv2.imread returned None")
            img = img.astype(np.float32)
            return img[..., [2, 1, 0, 3][:img.shape[-1]]]

        if cv2.haveImageReader(os.path.join(FIXTURES, "rtmv_exr_piz",
                                            "scene_p", "00000.exr")):
            return "cv2 " + cv2.__version__, read_cv2
        why.append(f"cv2 {cv2.__version__} has no OpenEXR reader")
    except Exception as e:                      # noqa: BLE001
        why.append(f"cv2: {type(e).__name__}: {e}")
    try:
        import numpy as np
        import OpenEXR

        def read_openexr(path):
            ch = OpenEXR.File(str(path), separate_channels=True).channels()
            names = [c for c in "RGBA" if c in ch]
            return np.stack([np.asarray(ch[c].pixels, np.float32)
                             for c in names], -1)

        return "OpenEXR " + getattr(OpenEXR, "__version__", "?"), \
            read_openexr
    except Exception as e:                      # noqa: BLE001
        why.append(f"OpenEXR: {type(e).__name__}: {e}")
    return None, "; ".join(why)


def _cv2_exr_writer():
    """(cv2, its OpenEXR's version) where cv2 writes OpenEXR, else (None,
    why not)."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError as e:
        return None, f"no cv2: {e}"
    if not (cv2.haveImageWriter("f.exr")
            and hasattr(cv2, "IMWRITE_EXR_COMPRESSION")):
        return None, f"cv2 {cv2.__version__} has no OpenEXR writer"
    version = [ln.split("ver")[-1].strip(" )") for ln in
               cv2.getBuildInformation().splitlines() if "OpenEXR:" in ln]
    return cv2, version[0] if version else "?"


def _half_ulps(a, b) -> int:
    """The largest distance between a and b (float32 arrays of half
    values) in steps of the half grid."""
    import numpy as np

    def ordered(x):
        i = x.astype(np.float16).view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


def _exr_frame(side, seed):
    """Half RGBA radiance: smooth in [0, 2) with noise, a bright patch and
    a negative one, alpha in [0, 1] with an opaque band."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side] / side
    ch = {n: np.sin(7 * x * (k + 1)) * np.cos(5 * y) + 1.0
          + 0.05 * rng.standard_normal(x.shape) for k, n in enumerate("RGB")}
    ch["R"][:5, :7] = 3.5
    ch["G"][10:14, 3:9] = -0.25
    ch["A"] = np.clip(0.5 + 0.5 * np.sin(3 * x + 2 * y), 0, 1)
    ch["A"][:, :4] = 1.0
    return {n: a.astype(np.float16) for n, a in ch.items()}


def _write_exr_frame(cv2, path, ch, method):
    """`ch` written in `method` by cv2 (OpenEXR's encoder) where it writes
    a file that OpenEXR reads back, else by the test writer: (who wrote
    it, why not cv2 or None, seconds)."""
    import numpy as np

    from tests.exr_writer import write_exr

    why = "no cv2 OpenEXR writer"
    if cv2 is not None:
        bgra = np.stack([ch[n] for n in "BGRA"], -1).astype(np.float32)
        t0 = time.perf_counter()
        ok = cv2.imwrite(path, bgra, [
            cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF,
            cv2.IMWRITE_EXR_COMPRESSION,
            getattr(cv2, "IMWRITE_EXR_COMPRESSION_" + EXR_METHODS[method])])
        seconds = time.perf_counter() - t0
        if ok and cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None:
            return "cv2 " + cv2.__version__, None, seconds
        why = (f"cv2 {cv2.__version__} wrote {os.path.getsize(path)} bytes "
               f"(imwrite {ok}) that cv2.imread cannot read back")
    t0 = time.perf_counter()
    write_exr(path, ch, method)
    return "tests/exr_writer.py", why, time.perf_counter() - t0


def exr_codec_path(tmp, cv2, openexr, name, read):
    """read_exr against OpenEXR's own codec, where cv2 has it: an
    EXR_SIDE^2 half RGBA frame in each of the ten methods, written by
    OpenEXR's encoder (by the test writer where cv2's writes nothing it can
    read back), read by read_exr and by OpenEXR's decoder (cv2.imread):
    the count of differing values and the largest difference in half ulps
    (gate EXR_ULP_GATE), and for the lossless methods read_exr against the
    frame written.  Then the committed trees' frames read by both, in
    half ulps (null where OpenEXR's reader does not read one, and why),
    and a file of DC-only DWA blocks over every half (`dwa_table_probe`),
    which reads OpenEXR's table to linear.  Returns the record and whether
    it passes."""
    import glob

    import numpy as np

    from ngp_pl_torch.datasets.exr import read_exr
    from tests.exr_writer import dwa_table_probe

    rec = dict(writer=None if cv2 is None else "cv2 " + cv2.__version__,
               openexr=openexr if cv2 is not None else None,
               writer_why_none=openexr if cv2 is None else None,
               reader=name, reader_why_none=None if name else read,
               ulp_gate=EXR_ULP_GATE)
    ch = _exr_frame(EXR_SIDE, 0)
    src = np.stack([ch[n] for n in "RGBA"], -1).astype(np.float32)
    methods = {}
    for method in EXR_METHODS:
        path = os.path.join(tmp, f"codec_{method}.exr")
        who, why, _ = _write_exr_frame(cv2, path, ch, method)
        got = read_exr(path)
        m = dict(writer=who, writer_why=why,
                 bytes=os.path.getsize(path))
        if method in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24"):
            m["equal_to_frame"] = bool(np.array_equal(got, src))
        if name is None:
            m.update(differ=None, max_ulps=None)
        else:
            other = read(path)
            m.update(differ=int((got != other).sum()),
                     max_ulps=_half_ulps(got, other))
        methods[method] = m
    rec["methods"] = methods
    files = {}
    for f in sorted(glob.glob(os.path.join(FIXTURES, "rtmv_exr*", "*",
                                           "*.exr"))):
        key = os.path.relpath(f, FIXTURES)
        if name is None:
            files[key] = None
            continue
        try:
            other = read(f)
        except ValueError as e:
            files[key] = f"null: {e}"
            continue
        files[key] = _half_ulps(read_exr(f), other)
    rec["fixtures_max_ulps"] = files
    # OpenEXR's table to linear: DC-only blocks over every half
    data, nonlinear = dwa_table_probe(np.arange(1 << 16, dtype=np.uint16))
    path = os.path.join(tmp, "dwa_table.exr")
    with open(path, "wb") as f:
        f.write(data)
    got = read_exr(path)
    table = dict(values=int(got.size),
                 distinct_nonlinear=int(np.unique(nonlinear).size),
                 differ=None, max_ulps=None)
    if name is not None:
        other = read(path)
        table.update(differ=int((got != other).sum()),
                     max_ulps=_half_ulps(got, other))
    rec["dwa_table"] = table
    ulps = ([m["max_ulps"] for m in methods.values()]
            + [v for v in files.values() if isinstance(v, int)]
            + [table["max_ulps"]])
    ok = (all(u is None or u <= EXR_ULP_GATE for u in ulps)
          and all(m.get("equal_to_frame", True) for m in methods.values()))
    return rec, ok


def _blocks_compressed(path) -> tuple:
    """(blocks, blocks stored compressed) of a single-part scanline file
    of HALF channels."""
    import struct

    from ngp_pl_torch.datasets import exr

    with open(path, "rb") as f:
        data = f.read()
    attrs, _, _, table, _ = exr._part0(path, data)
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    lines = exr.COMPRESSION[attrs["compression"][1][0]][1]
    n_ch = len(exr._channels(path, attrs["channels"][1]))
    h, w = y1 - y0 + 1, x1 - x0 + 1
    n = -(-h // lines)
    offsets = struct.unpack_from(f"<{n}Q", data, table)
    sizes = [struct.unpack_from("<i", data, off + 4)[0] for off in offsets]
    raw = [min(lines, h - lines * i) * w * 2 * n_ch for i in range(n)]
    return n, sum(s < r for s, r in zip(sizes, raw))


def timed_exr_reads(tmp, cv2, name, read) -> dict:
    """read_exr's seconds on EXR_BIG^2 RGBA half frames in PIZ, B44A and
    DWAA, each written by cv2 where its file reads back (else by the test
    writer), beside OpenEXR's own reader (cv2.imread) on the same file and
    the largest difference between the two in half ulps; the PIZ frame
    read back exactly, every block of it compressed."""
    import numpy as np

    from ngp_pl_torch.datasets.exr import read_exr

    ch = _exr_frame(EXR_BIG, 1)
    ch["A"][:] = 1.0
    src = np.stack([ch[n] for n in "RGBA"], -1).astype(np.float32)
    out = {}
    for method in ("PIZ", "B44A", "DWAA"):
        path = os.path.join(tmp, f"big_{method}.exr")
        who, why, write_s = _write_exr_frame(cv2, path, ch, method)
        t0 = time.perf_counter()
        got = read_exr(path)
        t1 = time.perf_counter()
        t = dict(side=EXR_BIG, writer=who, writer_why=why,
                 write_seconds=write_s, mb=os.path.getsize(path) / 1e6,
                 read_seconds=t1 - t0, other_read_seconds=None,
                 max_ulps=None)
        if method == "PIZ":
            t["blocks"], t["blocks_compressed"] = _blocks_compressed(path)
            t["exact"] = bool(np.array_equal(got, src))
        if name is not None:
            t0 = time.perf_counter()
            other = read(path)
            t.update(other_read_seconds=time.perf_counter() - t0,
                     max_ulps=_half_ulps(got, other))
        out[method.lower() + "_1600"] = t
    return out


def exr_path(card):
    """`prepare_rtmv` on copies of the committed EXR trees (EXR_TREES:
    ZIP, RLE and ZIPS frames; PIZ half, PIZ float with a data window off
    the origin and DECREASING_Y, PXR24 float; B44, B44A, DWAA, DWAB, a
    tiled ZIP frame with MIPMAP levels, a multi-part frame): every PNG it
    writes equal to the committed one the JAX script wrote for the same
    frames, the seconds per frame; where the machine has an OpenEXR
    reader of its own, the PIZ and PXR24 frames read by it equal to
    `read_exr`'s (else null and why); `exr_codec_path`: read_exr against
    OpenEXR's own encoder and decoder in every method and on every
    committed frame; `timed_exr_reads`: the EXR_BIG^2 reads timed beside
    OpenEXR's."""
    import glob
    import importlib.util

    import numpy as np

    from ngp_pl_torch.datasets.exr import read_exr

    t_phase = time.perf_counter()
    rec = dict(card=card, imageio_installed=importlib.util.find_spec(
        "imageio") is not None)
    cv2, openexr = _cv2_exr_writer()
    name, read = _other_exr_reader()
    with _build_tmp() as tmp:
        rec["trees"] = {tree: _rtmv_tree(tree, tmp) for tree in EXR_TREES}
        rec["codec"], codec_ok = exr_codec_path(tmp, cv2, openexr, name,
                                                read)
        rec.update(timed_exr_reads(tmp, cv2, name, read))
    rec["other_reader"] = name
    if name is None:
        rec["other_reader_equal"] = None
        rec["other_reader_why_none"] = read
    else:
        files = sorted(glob.glob(os.path.join(FIXTURES, "rtmv_exr_piz", "*",
                                              "*.exr")))
        try:
            rec["other_reader_equal"] = {
                os.path.basename(f): bool(np.array_equal(read(f),
                                                         read_exr(f)))
                for f in files}
        except Exception as e:                  # noqa: BLE001
            # a reader that cannot read the files cross-checks nothing
            rec["other_reader_equal"] = None
            rec["other_reader_why_none"] = f"{type(e).__name__}: {e}"
    trees_ok = all(t["frames"] == len(t["pngs"]) == EXR_TREES[tree]
                   and all(t["pngs"].values())
                   for tree, t in rec["trees"].items())
    other_ok = (rec["other_reader_equal"] is None
                or all(rec["other_reader_equal"].values()))
    piz = rec["piz_1600"]
    timed_ok = (piz["exact"] and piz["blocks_compressed"] == piz["blocks"]
                and all(rec[k]["max_ulps"] is None
                        or rec[k]["max_ulps"] <= EXR_ULP_GATE
                        for k in ("piz_1600", "b44a_1600", "dwaa_1600")))
    rec["seconds"] = time.perf_counter() - t_phase
    if not (trees_ok and other_ok and codec_ok and timed_ok):
        raise AssertionError(f"exr: {rec}")
    return rec


def _bound_shares(rec, at="main"):
    """(input, bound_share) of a kernel's record and of the records of its
    other inputs nested in it."""
    for key, v in rec.items():
        if key == "bound_share":
            yield at, v
        elif isinstance(v, dict):
            yield from _bound_shares(v, key)


# The phases `--phases` selects, in the order they run; each is one or
# more of the phase lines above.  eval_fps reads the slim checkpoint that
# resume writes, so it runs only with resume.  Only a run of all of them
# prints the kernels line.
PHASES = ("kernels", "micro_fwd", "slice", "train", "resume", "ddp", "bench",
          "fps", "probes", "eval_fps", "profile_step", "exr",
          "train_strided", "train_rounds", "train_mc", "l16f2", "train_hdr",
          "train_pose", "train_disk")
NEEDS = {"eval_fps": "resume"}
NO_KERNELS = {"exr"}            # phases that build and launch no kernel


def parse_phases(argv) -> list:
    """The phases of `--phases a,b,...` in run order; all of them when the
    argument is absent."""
    import argparse

    parser = argparse.ArgumentParser(description="chip smoke of the port")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated, of: " + ", ".join(PHASES))
    names = [p for p in parser.parse_args(argv).phases.split(",") if p]
    unknown = sorted(set(names) - set(PHASES))
    if unknown or not names:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    missing = [f"{p} needs {NEEDS[p]}" for p in names
               if p in NEEDS and NEEDS[p] not in names]
    if missing:
        parser.error("; ".join(missing))
    return [p for p in PHASES if p in names]


def main(argv=None) -> int:
    import torch

    phases = parse_phases(argv)
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

    if set(phases) - NO_KERNELS:
        t0 = time.perf_counter()
        seconds = _build.build()
        log({"phase": "build", "seconds": time.perf_counter() - t0,
             "seconds_by_kernel": seconds,
             "kernels": list(_build.KERNELS),
             "ptxas": {k: [ln.strip() for ln in (
                 _build.BUILD_DIR / f"{k}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
                 for k in _build.KERNELS
                 if (_build.BUILD_DIR / f"{k}.log").exists()}})

    # the two geometries: the flagship L8F4 and the reference's L16F2
    tcfgs = {"flagship": train_config(downsample=6.25),
             "l16f2": train_config(downsample=6.25, n_levels=16,
                                   n_features=2)}
    # each kernel's checks, its readings on the paths added as they run
    checks = {k: {} for k in ("K1", "K7", "K2+K5", "K8", "K6", "K3", "K4")}
    if "kernels" in phases:
        for path, kernel_checks in (
                ("flagship", (("K1", lambda m: check_fwd(torch, m, "K1")),
                              ("K7", lambda m: check_k7(torch, m)),
                              ("K2+K5", lambda m: check_bwd(torch, m,
                                                            "K2+K5")),
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
    if "micro_fwd" in phases:
        micro, launches["micro_fwd"] = micro_fwd_path(torch, card)

    # the render path: counts from 0 just before, read just after
    if "slice" in phases:
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
    if "train" in phases:
        train, at_step = train_path(torch, card, "", "flagship")
        for key, rec in at_step.items():
            checks[key]["at_train_step"] = rec
        launches["train"] = train["launches"]

    # full checkpoints, resumed; the trained system's validation dumps; the
    # bench entry point: each counted from 0 at its start
    if "resume" in phases:
        system, tb, resume = resume_path(torch)
        launches["resume"] = resume["launches"]
        log({"phase": "resume", "card": card, **resume})
        log({"phase": "tensorboard", **tb})
        log({"phase": "validate", "card": card,
             **validate_dumps(torch, system)})
        # what users do with that trained field: its slim checkpoint
        # through the mesh and viewer entry points (each counted from 0 at
        # its start), LPIPS, and the reference-layout grid ops (the slim
        # checkpoint stays until `eval_fps` has read it)
        slim_dir = _build_tmp()
        slim = os.path.join(slim_dir.name, "slim.npz")
        system.save_slim(slim)
        mesh, checks["K1"]["at_mesh_grid"] = mesh_path(
            torch, card, slim, [], MESH_RES, "K1")
        launches["mesh"] = mesh["launches"]
        log({"phase": "mesh", **mesh})
        log({"phase": "kernels", "kernel": "K1", "input": "mesh_grid",
             "card": card, **checks["K1"]["at_mesh_grid"]})
        gui = gui_path(torch, card, slim)
        launches["gui"] = gui["launches"]
        log({"phase": "gui", **gui})
        log({"phase": "lpips", **lpips_path(torch, card, system)})
        log({"phase": "interop", **interop_path(torch, card, system)})
        del system
        torch.cuda.empty_cache()
    # data parallelism: one NCCL rank, then two gloo ranks on this card
    if "ddp" in phases:
        ddp = ddp_path(torch, card)
        launches["ddp"] = ddp["launches"]
        log({"phase": "ddp", **ddp})
    if "bench" in phases:
        bench = bench_path(torch)
        launches["bench"] = bench["launches"]
        log({"phase": "bench", "card": card, **bench})
    # the JAX repository's measurement and data scripts, each counted from
    # 0 at its start: render FPS at T 1e-2, the eval FPS loop from the slim
    # checkpoint, the train step stage by stage, EXR input
    if "fps" in phases:
        fps, system = fps_path(torch)
        launches["fps"] = fps["launches"]
        log({"phase": "fps", **fps})
        # the JAX package's two other renderers and the JAX repository's
        # serving and march probes, on the system `fps` trained, each
        # counted from 0 at its start
        launches.update(serving_paths(torch, card, system))
        # one frame's rays over ranks, on the same system and frame
        shard = shard_frame_path(torch, card, system)
        launches["shard_frame"] = shard["launches"]
        log({"phase": "shard_frame", **shard})
        del system
        torch.cuda.empty_cache()
    # the JAX repository's rounds-step, field-stack and geometry probes,
    # its encode and field-tail checks, demand traces, NaN tools and
    # pose-gradient check, and its primitive micros and quick-train
    # script, each group in a fresh process
    if "probes" in phases:
        launches.update(probes_in_child(card, "probes"))
        launches.update(probes_in_child(card, "checks"))
        # the JAX repository's primitive micros and quick-train script
        launches.update(probes_in_child(card, "micros"))
        launches.update(probes_in_child(card, "micros_encode"))
    if "eval_fps" in phases:
        eval_fps = eval_fps_path(torch, card, slim)
        launches["eval_fps"] = eval_fps["launches"]
        log({"phase": "eval_fps", **eval_fps})
    if "resume" in phases:
        slim_dir.cleanup()
    if "profile_step" in phases:
        for layout in ("csr", "strided"):
            prof = profile_step_path(torch, card, layout)
            launches["profile_step_" + layout] = prof["launches"]
            log({"phase": "profile_step", **prof})
    if "exr" in phases:
        log({"phase": "exr", **exr_path(card)})

    # the flagship in the strided layout and in rounds with the distortion
    # loss, counted the same way
    for layout in ("strided", "rounds"):
        if "train_" + layout not in phases:
            continue
        suffix = "_" + layout
        train, at_step = train_path(
            torch, card, suffix, layout, at_step=layout == "strided",
            seeded_cpu_tol=SEEDED_MASKED_CPU_TOL)
        for key, rec in at_step.items():
            checks[key]["at_train_step" + suffix] = rec
        launches["train" + suffix] = train["launches"]

    # the multi-cascade scene at scale 4, counted the same way
    if "train_mc" in phases:
        train, mc = mc_path(torch, card)
        for key, rec in mc.items():
            checks[key].update(rec)
        launches["train_mc"] = train["launches"]

    # the L16F2 render and train paths, counted the same way
    if "l16f2" in phases:
        tcfg = tcfgs["l16f2"]
        res, out = render_slice(torch, tcfg, views=1)
        launches["render_l16f2"] = out["launches"]
        log({"phase": "slice_l16f2", "card": card, **out})
        log({"phase": "ckpt_l16f2", **ckpt_roundtrip(torch, res, tcfg)})
        del res
        torch.cuda.empty_cache()
        with _build_tmp() as tmp:
            slim = os.path.join(tmp, "slim_l16f2.npz")
            train, at_step = train_path(
                torch, card, "_l16f2", "l16f2", seeded_tol=STEP_TOL_L16F2,
                alone=("K3", "K4"), slim_path=slim)
            for key, rec in at_step.items():
                checks[key]["at_train_step"] = rec
            launches["train_l16f2"] = train["launches"]
            # the trained L16F2 field's mesh, K3 on the path
            mesh, checks["K3"]["at_mesh_grid"] = mesh_path(
                torch, card, slim, ["--n_levels", "16", "--n_features", "2"],
                MESH_RES_L16F2, "K3")
            launches["mesh_l16f2"] = mesh["launches"]
            log({"phase": "mesh_l16f2", **mesh})
            log({"phase": "kernels", "kernel": "K3", "input": "mesh_grid",
                 "card": card, **checks["K3"]["at_mesh_grid"]})

    # the HDR head and pose refinement on the flagship, counted the same way
    if "train_hdr" in phases:
        launches["train_hdr"] = hdr_path(torch, card)["launches"]
    if "train_pose" in phases:
        launches["train_pose"] = pose_path(torch, card)["launches"]

    # the flagship on a Blender scene on disk through the train entry point,
    # then the same scene's batches drawn on the host; counted the same way
    if "train_disk" in phases:
        with _build_tmp() as tmp:
            system, disk = disk_path(torch, card, os.path.join(tmp, "lego"))
            launches["train_disk"] = disk["launches"]
            log({"phase": "train_disk", **disk})
            log({"phase": "train_reference_disk", "state": "trained",
                 **trained_gate(torch, system, "disk")})
            tcfg, datasets = system.tcfg, (system.train_dataset,
                                           system.test_dataset)
            del system
            torch.cuda.empty_cache()
            host = host_batch_path(torch, card, tcfg, *datasets)
            del datasets
            launches["host_batches"] = host["launches"]
            log({"phase": "host_batches", **host})

    if phases != list(PHASES):
        # a partial run: no kernels line, since it holds every path's
        # launches and readings
        print(card, flush=True)
        log({"phases": phases, "seconds": time.perf_counter() - t_start})
        log({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
        return 0

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
                "at_train_step_strided", "at_scale4", "at_train_step_mc",
                "at_mesh_grid",
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
    over = [(e["name"], at, share) for e in entries
            for at, share in _bound_shares(e) if share > 1.0]
    if over:
        raise AssertionError(f"faster than the bound, so the bound or the "
                             f"timing is wrong: {over}")
    print(card, flush=True)
    log({"kernels": entries, "seconds": time.perf_counter() - t_start})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
