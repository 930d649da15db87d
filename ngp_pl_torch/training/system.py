"""NeRFSystem: the training orchestrator (counterpart of
ngp_pl_tpu/training/system.py:48-473; reference train.py:53-294).

A host loop around eager steps on the card: the occupancy grid is refreshed
every 16 steps (every cell during the first 256 steps, then a quarter of
them in turn), batches are drawn on the device from the resident ray store,
and the layout, its sample budget (`_pool_mult`: the CSR pool's multiple of
the batch, or S of the strided and rounds layouts) and the march's chain
length follow the observed demand, read one interval late
(`_consume_demand`).  "auto", the default, trains in CSR through grid
warmup and then in the strided layout wherever a bucket covers the q99
per-ray demand at no more than 1.37x the mean's, else in CSR; "csr",
"strided" and "rounds" pin one layout.  `freeze_buckets` pins layout,
budget and chain (benchmarks set it before their timed blocks).

The datasets are built as the JAX package builds them (system.py:62-68):
the train split `split`, the test split "test", from `root_dir` at
`downsample`.  The train rays go to the card once when `device_dataset`
is set and they fit `device_dataset_max_bytes` (system.py:145-153), and
batches are drawn there; otherwise each batch is drawn on the host by the
dataset's `sample_batch` from a numpy Generator seeded with `seed`, and
copied to the card (system.py:274-279, 302-310), so the same seed gives
the JAX system's batches.

Validation scores the test views and writes them as PNGs with their
turbo-coloured depth; `save` and `load` write and read full checkpoints
(params, Adam state, grid state, step and, with `--optimize_ext`, the
poses and their optimizer) in the JAX package's keys.

`--optimize_ext` builds the model with the position gradient
(`need_x_grad`) and trains per-image pose corrections of the train views
(`PoseRefinement`) through the rays; `--use_exposure` trains the HDR head,
reading a per-ray exposure from a 4-channel ray store where the dataset has
one and anchoring the tonemappers at the dataset's `unit_exposure_rgb`
(0.5 without one).

In a process group (`ngp_pl_torch.parallel`, one process per GPU; the
counterpart of the JAX system's data mesh, system.py:95-114) the batch
stays global: every rank draws it, and the march noise, from the same
seeded generators and keeps its rows, so the grid refresh and the
background draw the same numbers everywhere; rank 0's state is broadcast
at construction and after `load` (`replicate`); `train_step` averages the
gradients and reduces the metrics over the ranks; validation renders
views r, r + N, ... on rank r and averages the ranks' sums; rank 0 alone
logs and traces.  Each logged step's scalars go to a TensorBoard event
file in logs/<dataset_name>/<exp_name> (system.py:264-271, 537-546).

The march is the JAX package's choice (system.py:227-245): the 8-step
windows for one cascade with uniform steps where `segment_march_dmax_ok`
holds, the two-window chain where `window_march_mc_ok` holds (multi-cascade
/ exponential steps), otherwise the general march on the grid.  The train
background is white under uniform steps (whatever `random_bg` says), else
one uniform draw per step from the system's generator with `random_bg`,
else black (train_step.py:121-128).
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ngp_pl_torch import parallel
from ngp_pl_torch.config import MAX_SAMPLES, NGPConfig, RenderConfig, TrainConfig
from ngp_pl_torch.datasets import dataset_dict
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.device import resolve_device
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.occupancy import (
    init_grid_state,
    mark_invisible_cells,
    update_density_grid,
)
from ngp_pl_torch.models.rendering import (
    RoundRenderer,
    compute_scene_chain_length,
)
from ngp_pl_torch.ops.ray_march import (
    occupancy_windows,
    segment_march_dmax_ok,
    window_march_mc_ok,
)
from ngp_pl_torch.training.checkpoint import (
    grid_state_from_numpy,
    grid_state_numpy,
    load_checkpoint,
    load_pose_state,
    load_slim_checkpoint,
    load_train_state,
    pose_state_numpy,
    save_checkpoint,
    save_slim_checkpoint,
    train_state_numpy,
)
from ngp_pl_torch.training.metrics import LPIPS_ENV, LPIPSHook
from ngp_pl_torch.training.metrics import psnr as psnr_fn
from ngp_pl_torch.training.metrics import ssim as ssim_fn
from ngp_pl_torch.training.train_step import (
    Adam,
    PoseRefinement,
    block_metrics,
    cosine_epoch_schedule,
    sample_batch,
    train_step,
)
from ngp_pl_torch.utils.events import EventWriter
from ngp_pl_torch.utils.images import depth2img, write_png

LAYOUTS = ("auto", "csr", "strided", "rounds")
TRACE_FILE = "trace_steps64-96.json"


class StepTrace:
    """torch.profiler over steps [64, 96) of a fit (system.py:484-505): it
    starts before the call that begins at step 64 and stops, after a
    fence, at the end of the call that reaches step 96, or at the fit's
    end; each call inside is a range named by its steps ("steps 64-80").
    The Chrome trace goes to <out_dir>/trace_steps64-96.json, for viewing:
    late in a long process the profiler drops device records, so no number
    is read from it."""

    START, STOP = 64, 96

    def __init__(self, out_dir: str, dev: torch.device):
        self.out_dir, self.dev = out_dir, dev
        self.prof = None

    def run(self, fn, done: int, n: int):
        """`fn()`, the fit's call that runs steps [done, done + n)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        if done == self.START:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        if self.prof is None:
            return fn()
        with record_function(f"steps {done}-{done + n}"):
            out = fn()
        if done + n >= self.STOP:
            self.stop()
        return out

    def stop(self):
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out_dir, TRACE_FILE))


class NeRFSystem:
    def __init__(self, tcfg: TrainConfig, train_dataset=None,
                 test_dataset=None, device="cuda"):
        if tcfg.train_layout not in LAYOUTS:
            raise ValueError(f"train_layout={tcfg.train_layout!r}: one of "
                             f"{LAYOUTS}")
        self.dev = resolve_device(device)
        self.tcfg = tcfg
        self.world, self.rank = parallel.world_size(), parallel.rank()
        if tcfg.num_devices > 1 and not parallel.active():
            raise RuntimeError(
                f"num_devices={tcfg.num_devices} needs a process group of as "
                f"many ranks (ngp_pl_torch.train, or parallel.launch)")
        if parallel.active():
            if tcfg.num_devices not in (0, self.world):
                raise ValueError(f"num_devices={tcfg.num_devices} in a group "
                                 f"of {self.world} ranks")
            if self.dev.type == "cuda":         # this rank's own card
                self.dev = torch.device("cuda", torch.cuda.current_device())
        if tcfg.batch_size % self.world:
            raise ValueError(f"batch_size={tcfg.batch_size} does not split "
                             f"over {self.world} ranks")
        self.cfg: NGPConfig = tcfg.ngp_config()
        self.rcfg: RenderConfig = tcfg.render_config()
        ds_cls = dataset_dict[tcfg.dataset_name]
        kw = dict(root_dir=tcfg.root_dir, downsample=tcfg.downsample,
                  device=self.dev)
        self.train_dataset = train_dataset or ds_cls(split=tcfg.split, **kw)
        self.train_dataset.batch_size = tcfg.batch_size
        self.train_dataset.ray_sampling_strategy = tcfg.ray_sampling_strategy
        self.test_dataset = test_dataset or ds_cls(split="test", **kw)

        self.window_march = self._window_ok(self.train_dataset)
        self.test_window = self._window_ok(self.test_dataset)

        # dL/dx through the encoder is only needed for pose refinement
        self.ngp = NGP(self.cfg, seed=tcfg.seed, device=self.dev,
                       need_x_grad=tcfg.optimize_ext)
        self.unit_exposure_rgb = getattr(self.train_dataset,
                                         "unit_exposure_rgb", 0.5)
        self.grid_state = init_grid_state(self.cfg, self.dev)
        if tcfg.weight_path:
            params, occ = load_slim_checkpoint(tcfg.weight_path)
            self.ngp.load_params(params)
            occ = torch.from_numpy(occ).to(self.dev)
            self.grid_state.occ_grid = occ
            self.grid_state.win_rows = occupancy_windows(occ)
        self.optimizer = Adam(
            [w for _, _, w in self.ngp._slots()],
            cosine_epoch_schedule(tcfg.lr, tcfg.num_epochs,
                                  tcfg.iters_per_epoch, tcfg.lr_final_div),
            eps=tcfg.adam_eps)

        self.poses = torch.from_numpy(self.train_dataset.poses).to(self.dev)
        self.pose = (PoseRefinement(len(self.poses), tcfg.pose_lr, self.dev)
                     if tcfg.optimize_ext else None)
        self.directions = torch.from_numpy(
            self.train_dataset.directions).to(self.dev)
        # the ray store on the card, or None: batches come from the host
        rays = self.train_dataset.rays
        nbytes = (rays.nbytes if isinstance(rays, np.ndarray)
                  else rays.numel() * rays.element_size())
        self.rays = None
        if (tcfg.device_dataset and nbytes
                and nbytes <= tcfg.device_dataset_max_bytes):
            self.rays = torch.as_tensor(rays, dtype=torch.float32).to(
                self.dev)
        self._rng = np.random.default_rng(tcfg.seed)
        # threshold 0.01 * MAX_SAMPLES / sqrt(3) (reference train.py:160)
        self.density_threshold = 0.01 * MAX_SAMPLES / math.sqrt(3.0)
        self.erode = tcfg.dataset_name == "colmap"
        self.generator = torch.Generator(device=self.dev).manual_seed(
            tcfg.seed)
        self.history: list = []
        self._host_step = 0
        self.lpips = LPIPSHook(self.dev)

        # demand controller (system.py:164-250)
        self._pool_buckets = (8, 16, 24, 32, 40, 48, 56, 64)
        if self.cfg.exp_step_factor > 0:
            # exp-stepping scenes carry 2-3x the occupied samples per ray
            self._pool_buckets += (96, 128, 160)
        self._pool_mult = self.rcfg.train_pool_mult
        self._pool_demand = 0.0
        # "auto" starts in CSR: every chain step is occupied in warmup
        self.layout = ("csr" if tcfg.train_layout == "auto"
                       else tcfg.train_layout)
        self._layout_vote = 0
        self._shrink_votes = 0
        self._rounds_buckets = (8, 16, 24, 32)
        # (first step, layout) of each stretch of training in one layout
        self.layout_log = [(0, self.layout)]
        self.chain_full = compute_scene_chain_length(
            self.train_dataset.poses, self.train_dataset.directions,
            self.cfg.scale, self.cfg.exp_step_factor, self.rcfg.max_samples,
            self.cfg.grid_size)
        self._chain_buckets = sorted({
            max(128, -(-int(self.chain_full * f) // 128) * 128)
            for f in (0.25, 0.5, 0.75, 1.0)})
        self.chain_length = self._chain_buckets[-1]
        self._chain_demand = float(self.chain_length)
        # per-round chain of the rounds layout: the cursor resumes across
        # rounds, so a round needs only its local skip and S samples
        self._rounds_chain = min(384, max(128, -(-self.chain_full // 8) * 8))
        self._pending_demand = None
        # True pins layout, budget and chain at their current values
        self.freeze_buckets = False
        self._writer: Optional[EventWriter] = None
        self.replicate()

    def replicate(self):
        """Every rank takes rank 0's parameters, Adam moments and counts,
        grid state, poses and step (the counterpart of `replicate`, as DDP
        broadcasts at wrap time); nothing without a process group."""
        if not parallel.active():
            return
        opts = [self.optimizer] + ([self.pose.opt] if self.pose else [])
        gs = self.grid_state
        parallel.broadcast_(
            [t for o in opts for t in o.params + o.mu + o.nu]
            + [gs.density_grid, gs.count_grid, gs.occ_grid, gs.mean_density,
               gs.win_rows])
        counts = torch.tensor([o.count for o in opts] + [self._host_step],
                              dtype=torch.int64, device=self.dev)
        parallel.broadcast_([counts])
        *opt_counts, self._host_step = (int(c) for c in counts.tolist())
        for o, c in zip(opts, opt_counts):
            o.count = c

    def _window_ok(self, ds) -> bool:
        """The JAX package's window rule for a dataset's cameras."""
        cfg = self.cfg
        return (cfg.cascades == 1 and cfg.exp_step_factor == 0.0
                and segment_march_dmax_ok(
                    ds.directions, grid_size=cfg.grid_size,
                    max_samples=self.rcfg.max_samples, scale=cfg.scale)
                ) or window_march_mc_ok(ds.directions, cfg.exp_step_factor,
                                        cfg.cascades)

    def renderer(self) -> RoundRenderer:
        """The test-view renderer, windows as the JAX system sets them."""
        return RoundRenderer(self.ngp, self.rcfg, use_window=self.test_window)

    def background(self) -> torch.Tensor:
        """This step's train background (train_step.py:121-128)."""
        if self.cfg.exp_step_factor == 0:
            return torch.ones(3, device=self.dev)
        if self.tcfg.random_bg:
            return torch.rand(3, generator=self.generator, device=self.dev)
        return torch.zeros(3, device=self.dev)

    # -- setup ------------------------------------------------------------
    def on_train_start(self):
        """Mark camera-invisible cells once (reference train.py:154-157)."""
        ds = self.train_dataset
        self.grid_state = mark_invisible_cells(
            self.grid_state, ds.K, ds.poses, cfg=self.cfg,
            img_w=ds.img_wh[0], img_h=ds.img_wh[1])

    # -- training ---------------------------------------------------------
    def _refresh_grid(self, step_i: int):
        n = self.tcfg.grid_update_interval
        self.grid_state = update_density_grid(
            self.ngp, self.grid_state, self.density_threshold,
            warmup=step_i < self.tcfg.grid_warmup_steps, erode=self.erode,
            phase=(step_i // n) % 4, generator=self.generator)

    def sample_batch(self):
        """(img_idxs, pix_idxs, payload) of one batch on the card: drawn
        there from the resident store, or on the host by the dataset's
        `sample_batch` and copied (system.py:274-279).  The payload is the
        rgb and, where the store has it, the exposure column.  In a process
        group every rank draws the global batch and keeps its own rows
        (`parallel.shard`), so that the generators stay in step."""
        tcfg = self.tcfg
        if self.rays is not None:
            return tuple(parallel.shard(t) for t in sample_batch(
                self.rays, tcfg.batch_size, tcfg.ray_sampling_strategy,
                self.generator))
        batch = {k: parallel.shard(torch.from_numpy(v)).numpy()
                 for k, v in self.train_dataset.sample_batch(
                     self._rng).items()}
        cols = [batch["rgb"]] + ([batch["exposure"]] if "exposure" in batch
                                 else [])
        host = [torch.from_numpy(batch["img_idxs"]),
                torch.from_numpy(batch["pix_idxs"]),
                torch.from_numpy(np.concatenate(cols, axis=1).astype(
                    np.float32))]
        if self.dev.type == "cuda":
            host = [t.pin_memory() for t in host]
        img, pix, payload = (t.to(self.dev, non_blocking=True) for t in host)
        return img.long(), pix.long(), payload

    def _train_step(self) -> Dict[str, torch.Tensor]:
        tcfg = self.tcfg
        img, pix, payload = self.sample_batch()
        exposure = (payload[:, 3:4] if tcfg.use_exposure
                    and payload.shape[-1] >= 4 else None)
        if self.pose is not None:
            rays_o, rays_d = self.pose.rays(self.directions[pix], self.poses,
                                            img)
        else:
            rays_o, rays_d = get_rays(self.directions[pix], self.poses[img])
        noise = parallel.shard(torch.rand(
            tcfg.batch_size, generator=self.generator, device=self.dev))
        gs = self.grid_state
        return train_step(self.ngp, self.optimizer,
                          gs.win_rows if self.window_march else None,
                          rays_o.contiguous(), rays_d.contiguous(),
                          payload[:, :3], noise, self.background(),
                          tcfg=tcfg, rcfg=self.rcfg,
                          n_samples=self._pool_mult,
                          chain_length=self.step_chain(), layout=self.layout,
                          occ_grid=gs.occ_grid, exposure=exposure,
                          unit_exposure_rgb=self.unit_exposure_rgb,
                          pose=self.pose)

    def step_chain(self) -> int:
        """The chain a step marches: per round under rounds
        (system.py:293-294, 463-464)."""
        return (self._rounds_chain if self.layout == "rounds"
                else self.chain_length)

    def step(self) -> Dict[str, torch.Tensor]:
        """One step (system.py:281-315): a grid refresh first at every
        interval boundary; demand consumed at the interval's end."""
        step_i = self._host_step
        n = self.tcfg.grid_update_interval
        if step_i % n == 0:
            self._refresh_grid(step_i)
        metrics = self._train_step()
        self._host_step = step_i + 1
        if (step_i + 1) % n == 0:
            self._consume_demand(metrics)
        return metrics

    def step_block(self) -> Dict[str, torch.Tensor]:
        """One grid refresh and `grid_update_interval` steps
        (system.py:445-473), queued without a host sync; the block's
        metrics are the last step's except the demand (max over the
        block), rm_samples (max) and the skip count (sum)."""
        n = self.tcfg.grid_update_interval
        step_i = self._host_step
        if step_i % n:
            raise ValueError("step_block must start block-aligned")
        self._refresh_grid(step_i)
        metrics = block_metrics([self._train_step() for _ in range(n)])
        self._host_step = step_i + n
        self._consume_demand(metrics)
        return metrics

    def _pick_bucket(self, want: float) -> int:
        for m in self._pool_buckets:
            if m >= want:
                return m
        return self._pool_buckets[-1]

    def _consume_demand(self, metrics):
        """Re-bucket layout, budget and chain from the demand vector of the
        previous interval (system.py:323-443): the vector is copied to the
        host asynchronously and read one interval late, so the host never
        waits for the block it just queued.  Nothing moves while
        `freeze_buckets` is set."""
        if self.freeze_buckets:
            return
        dv = torch.as_tensor(metrics["demand_vec"])
        if dv.is_cuda:
            host = torch.empty(dv.shape, dtype=dv.dtype, pin_memory=True)
            host.copy_(dv, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            pending = (host, event)
        else:
            pending = (dv.clone(), None)
        prev, self._pending_demand = self._pending_demand, pending
        if prev is None:
            return
        if prev[1] is not None:
            prev[1].synchronize()
        (_, _, chain_q, rm_q, _, _, vr_mean, alive_end, rm_mean_pre) = (
            float(v) for v in np.nan_to_num(
                prev[0].numpy(), posinf=0.0, neginf=0.0))
        # during grid warmup every chain step is occupied: hold the budget
        if self._host_step <= self.tcfg.grid_warmup_steps:
            return
        mode = self.tcfg.train_layout
        if mode == "rounds":
            self._consume_rounds(vr_mean, alive_end)
            return                       # the chain stays at _rounds_chain
        # every occupied sample needs its gradient, so the budget covers the
        # occupied counts: the strided row the q99 of a ray's, the CSR pool
        # the pre-clip per-ray mean (headroom 1.15 + 2)
        want_mean = rm_mean_pre * 1.15 + 2.0
        want_tail = rm_q * 1.05
        if mode in ("csr", "strided"):
            target = mode
            want = want_tail if mode == "strided" else want_mean
        elif (want_tail <= self._pool_buckets[-1]
              and self._pick_bucket(want_tail)
              <= 1.37 * self._pick_bucket(want_mean)):
            # auto: strided costs ~1/1.37 of CSR per slot, but drops the
            # rays past S from the loss; only where a bucket covers the tail
            target, want = "strided", want_tail
        else:
            target, want = "csr", want_mean
        if target != self.layout:
            self._layout_vote += 1
            if self._layout_vote >= 2:      # hysteresis: 2 intervals agree
                self.layout = target
                self._layout_vote = 0
                self._pool_demand = want
        else:
            self._layout_vote = 0
        if target == self.layout:
            self._pool_demand = max(0.8 * self._pool_demand, want)
        # growth applies at once; a shrink needs two agreeing intervals
        new_mult = self._pick_bucket(self._pool_demand)
        if new_mult >= self._pool_mult:
            self._pool_mult = new_mult
            self._shrink_votes = 0
        else:
            self._shrink_votes += 1
            if self._shrink_votes >= 2:
                self._pool_mult = new_mult
                self._shrink_votes = 0
        self._chain_demand = max(0.9 * self._chain_demand, chain_q * 1.2)
        for c in self._chain_buckets:
            if c >= self._chain_demand:
                self.chain_length = c
                break
        else:
            self.chain_length = self._chain_buckets[-1]

    def _consume_rounds(self, vr_mean: float, alive_end: float):
        """The rounds branch: S follows the mean effective demand with
        headroom, growing while more than a tenth of the batch is still
        alive after the last round."""
        want = vr_mean * 0.9 + 4.0
        if alive_end > 0.10 * self.tcfg.batch_size:
            want = max(want, self._pool_mult + 8.0)
        self._pool_demand = max(0.8 * self._pool_demand, want)
        for m in self._rounds_buckets:
            if m >= self._pool_demand:
                self._pool_mult = m
                break
        else:
            self._pool_mult = self._rounds_buckets[-1]

    def fit(self, max_steps: Optional[int] = None,
            log_every: Optional[int] = None, quiet: bool = False,
            profile_dir: Optional[str] = None):
        """Train `max_steps` steps (system.py:475-522): 16-step blocks when
        the step counts allow, single steps otherwise.  Logs the JAX
        trainer's line plus the skipped-step count, keeps it in `history`
        and writes its TensorBoard scalars (`_log_fit`).  With
        `profile_dir` the fit's steps 64-96 run under torch.profiler and
        its Chrome trace is written there (`TRACE_FILE`; `StepTrace`).  In
        a process group rank 0 alone logs, keeps `history` and traces."""
        max_steps = max_steps or self.tcfg.max_steps
        log_every = log_every or self.tcfg.log_every
        lead = self.rank == 0
        quiet = quiet or not lead
        self.on_train_start()
        t0 = time.time()
        nb = self.tcfg.grid_update_interval
        skipped = torch.zeros((), dtype=torch.int32, device=self.dev)
        blocks = (self._host_step % nb == 0 and max_steps % nb == 0
                  and log_every % nb == 0)
        n, run = (nb, self.step_block) if blocks else (1, self.step)
        trace = (StepTrace(profile_dir, self.dev) if profile_dir and lead
                 else None)
        try:
            for i in range(max_steps // n):
                metrics = trace.run(run, i * n, n) if trace else run()
                skipped = skipped + metrics["n_skipped"]
                self._note_layout(quiet)
                if lead and (((i + 1) * n) % log_every == 0 or i == 0):
                    self._log_fit(metrics, (i + 1) * n, t0, quiet, skipped)
        finally:
            if trace:
                trace.stop()
        return self.history

    def _note_layout(self, quiet: bool):
        """Record (and print) the step from which the next steps run in
        another layout."""
        if self.layout != self.layout_log[-1][1]:
            self.layout_log.append((self._host_step, self.layout))
            if not quiet:
                print(f"step {self._host_step:6d} layout {self.layout} "
                      f"x{self._pool_mult}", flush=True)

    def _log_fit(self, metrics, steps_done, t0, quiet, skipped):
        m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
        m["step"] = self._host_step
        m["skipped_total"] = int(skipped)
        if self.dev.type == "cuda":          # a fenced time
            torch.cuda.synchronize(self.dev)
        m["seconds"] = time.time() - t0
        m["rays_per_s"] = self.tcfg.batch_size * steps_done / m["seconds"]
        m["layout"] = self.layout
        m["pool_mult"] = self._pool_mult
        m["chain_length"] = self.step_chain()
        self.history.append(m)
        self._write_scalars(m)
        if not quiet:
            print(f"step {m['step']:6d} loss {m['loss']:.4f} "
                  f"psnr {m['psnr']:.2f} {m['layout']} x{m['pool_mult']} "
                  f"rm_s {m['rm_samples'] / self.tcfg.batch_size:.1f} "
                  f"{m['rays_per_s']:.0f} rays/s "
                  f"skipped {m['skipped_total']}", flush=True)

    def _write_scalars(self, m):
        """The JAX trainer's TensorBoard scalars of one logged step
        (system.py:537-546) into logs/<dataset_name>/<exp_name>, the file
        made at the first log; samples per ray over the global batch."""
        if self._writer is None:
            self._writer = EventWriter(os.path.join(
                "logs", self.tcfg.dataset_name, self.tcfg.exp_name))
        b = self.tcfg.batch_size
        for tag, v in (("loss", m["loss"]), ("psnr", m["psnr"]),
                       ("rm_s", m["rm_samples"] / b),
                       ("vr_s", m["vr_samples"] / b)):
            self._writer.add_scalar(f"train/{tag}", v, m["step"])
        self._writer.flush()

    # -- validation -------------------------------------------------------
    @torch.no_grad()
    def validate(self, save_images: Optional[bool] = None,
                 max_images: Optional[int] = None) -> Dict[str, float]:
        """PSNR/SSIM (and LPIPS) of the test views through the round renderer
        (system.py:548-630).  With `save_images` (by default unless
        `no_save_test`) each view is written to
        results/<dataset_name>/<exp_name>/ as NNN.png and its
        turbo-coloured depth as NNN_d.png.  A view without colours (a
        pose-only split such as `test_traj`) is rendered and dumped but not
        scored (system.py:589); with no view scored the result is empty.
        With `eval_lpips` each scored view's LPIPS(vgg) is averaged into
        "lpips" (system.py:593-629); without weights (`LPIPSHook`) it
        raises before any render.  In a process group rank r renders and
        dumps views r, r + N, ... and every rank returns the means over
        all views (system.py:576-621)."""
        if self.tcfg.eval_lpips and not self.lpips.available:
            raise RuntimeError(
                f"--eval_lpips: no LPIPS-vgg weights were found. Point "
                f"{LPIPS_ENV} at an npz in the LPIPS naming scheme "
                f"(`python -m ngp_pl_torch.training.lpips export FILE` "
                f"writes one from the lpips package's pretrained network), "
                f"or run without --eval_lpips to score PSNR and SSIM only")
        if save_images is None:
            save_images = not self.tcfg.no_save_test
        val_dir = os.path.join("results", self.tcfg.dataset_name,
                               self.tcfg.exp_name)
        if save_images:
            os.makedirs(val_dir, exist_ok=True)
        ds = self.test_dataset
        w, h = ds.img_wh
        renderer = self.renderer()
        dirs = torch.from_numpy(ds.directions).to(self.dev)
        n = len(ds.poses)
        if max_images:
            n = min(n, max_images)
        psnrs, ssims, lpipss = [], [], []
        # rank r renders views r, r + n, ... (system.py:576-580)
        for idx in range(self.rank, n, self.world):
            item = ds.test_item(idx)
            out = renderer.render_pose(
                self.grid_state.occ_grid, dirs,
                torch.from_numpy(item["pose"]).to(self.dev))
            pred = out["rgb"].reshape(h, w, 3)
            if "rgb" in item:        # a pose-only split renders unscored
                gt = item["rgb"].reshape(h, w, 3)
                psnrs.append(float(psnr_fn(pred, gt)))
                ssims.append(float(ssim_fn(pred, gt)))
                if self.tcfg.eval_lpips:
                    lpipss.append(self.lpips(pred, gt))
            if save_images:
                rgb = pred.cpu().numpy()
                write_png(os.path.join(val_dir, f"{idx:03d}.png"),
                          (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
                write_png(os.path.join(val_dir, f"{idx:03d}_d.png"),
                          depth2img(out["depth"].reshape(h, w).cpu().numpy()))
        if parallel.active():
            # the global means, from every rank's sums and counts
            sums = parallel.sum_floats(
                [v for vals in (psnrs, ssims, lpipss)
                 for v in (math.fsum(vals), len(vals))])
            out = {}
            for name, (tot, cnt) in zip(("psnr", "ssim", "lpips"),
                                        zip(sums[::2], sums[1::2])):
                if cnt:
                    out[name] = tot / cnt
            return out if "psnr" in out else {}
        if not psnrs:
            return {}
        out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
        if lpipss:
            out["lpips"] = float(np.mean(lpipss))
        return out

    # -- checkpointing ----------------------------------------------------
    def _state_numpy(self) -> Dict:
        params, mu, nu, count = train_state_numpy(self.ngp, self.optimizer)
        return dict(params=params, mu=mu, nu=nu, count=count,
                    grid=grid_state_numpy(self.grid_state),
                    pose=None if self.pose is None
                    else pose_state_numpy(self.pose))

    def save(self, path: str):
        """Full checkpoint: params, Adam state, grid state, step and the
        poses with their optimizer (system.py:633-638)."""
        save_checkpoint(path, **self._state_numpy(), step=self._host_step)

    def save_slim(self, path: str):
        save_slim_checkpoint(path, params=self.ngp.params_numpy(),
                             occ_grid=self.grid_state.occ_grid)

    def load(self, path: str):
        """Resume from a full checkpoint of either package
        (system.py:644-652): parameters and Adam moments are copied into
        the existing tensors (which bumps the version counters that key
        the encode's table copy and the field tail's packed weights), the
        grid state and the step replaced.  As in the JAX package, the
        demand controller is left as it is (a fresh system's layout,
        budget and chain start from their initial values).  With
        `--optimize_ext` the poses are loaded too; the JAX package's `load`
        leaves them at their current values (it loads the pose optimizer's
        state only)."""
        params, mu, nu, count, grid, pose, step = load_checkpoint(
            path, **self._state_numpy())
        load_train_state(self.ngp, self.optimizer, params, mu, nu, count)
        if pose is not None:
            load_pose_state(self.pose, pose)
        self.grid_state = grid_state_from_numpy(grid, self.dev)
        self._host_step = step
        self.replicate()
