"""Round-4 micros: the per-ray occupied-count distribution of a fitted
field, the table scatter-add's variants, and packed-row gathers, the
counterpart of benchmarking/micro_r4.py.

    python -m ngp_pl_torch.benchmarking.micro_r4 [--device cuda]
        [--steps 512 --batch 8192 --N 196608]

1. The bench's scene (8 views at 96x96, one test view) and the flagship
   in the CSR layout, as the JAX script's `TrainConfig` (batch `PROF_BATCH`
   there, `--batch` here), fitted `--steps` steps in 16-step blocks (K1,
   K2+K5, K7 and K8 on the card).  Then `batch` rays of the train views
   drawn from `np.random.default_rng(0)` (views, pixels, march noise, as
   the JAX script draws them), their box hits (`scene_hits`) and
   `march_rays_train_strided(n_samples=8)` over the whole chain on the
   fitted `win_rows`: the per-ray occupied counts before the clip to 8,
   printed as the JAX script prints them (`count_lines`).
2. The table gradient's scatter-add at N = 196,608 points a level: slots
   of N points ~ U(0, 1)^3 (`slots_local_frac_lm`) and (L, N, W) rows ~
   U(0, 1) as bf16, from the same generator; per level into f32 zeros
   from f32 rows, from bf16 rows cast, into bf16 zeros, all levels merged,
   and levels 0, 2, 3 and 7 alone, with their slots as drawn and sorted.
3. Gathers of packed rows (the table's rows at half and full width, as
   int32 zeros: PyTorch indexes no uint32) at 8 and 4 levels' slots.

Labels (`LABELS`, the JAX script's).  Beside the scatters (`PORT_LABELS`):
K2+K5, the table gradient of the fitted field's w1 on the same N points
and a gradient g (N, 64) ~ N(0, 1) drawn after the rest, held against its
plain version; its record adds, on the card, the device ms of the kernel
alone (`kernel_device_ms`, without the gradient's zero fill).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(steps=512, batch=8192, N=196608)
PERCENTILES = (50, 75, 90, 95, 98, 99, 100)
LEVELS = (0, 2, 3, 7)
LABELS = ("scatter per-level f32 in, f32 target",
          "scatter per-level bf16 in (cast), f32 tgt",
          "scatter per-level bf16 in, bf16 tgt",
          "scatter merged (all levels, one call)",
          "scatter level 0 (rows 512)", "scatter level 0 PRESORTED idx",
          "scatter level 2 (rows 17576)", "scatter level 2 PRESORTED idx",
          "scatter level 3 (rows 16384)", "scatter level 3 PRESORTED idx",
          "scatter level 7 (rows 16384)", "scatter level 7 PRESORTED idx",
          "gather 8 x N packed rows", "gather 4 x N packed rows",
          "gather 4 x N DOUBLE-wide packed rows")
PORT_LABELS = ("port: K2+K5 table gradient (N points, L8F4)",)
KEYS = LABELS + PORT_LABELS
K2_KERNEL = "hash_encode_bwd_kernel"
NOTES = {PORT_LABELS[0]: (
    "wall and device ms of the wrapper's call, the gradient's zero fill "
    "included; kernel_device_ms is the kernel alone")}


def fit_system(device: str, steps: int = 512, batch: int = 8192, **kw):
    """The JAX script's system (the bench's, CSR pinned), fitted `steps`
    steps in 16-step blocks: (system, {"steps", "losses"}), the loss of
    each block's last step."""
    from ngp_pl_torch.benchmarking.bench import bench_system

    system = bench_system(device, batch, exp_name="micro_r4",
                          train_layout="csr", **kw)
    system.on_train_start()
    losses = [float(system.step_block()["loss"])
              for _ in range(steps // system.tcfg.grid_update_interval)]
    return system, {"steps": steps, "losses": losses}


def count_rays(system, batch: int, rng):
    """`batch` rays of the train views as the JAX script draws them:
    (rays_o, rays_d, noise) on the system's device."""
    ds = system.train_dataset
    img_idxs = rng.integers(0, len(ds.poses), batch)
    pix_idxs = rng.integers(0, ds.directions.shape[0], batch)
    poses = np.asarray(ds.poses)[img_idxs]
    dirs = np.asarray(ds.directions)[pix_idxs]
    rays_d = np.einsum("nij,nj->ni", poses[:, :, :3], dirs).astype(np.float32)
    rays_o = poses[:, :, 3].astype(np.float32)
    noise = rng.random(batch).astype(np.float32)
    return tuple(mp.tensor(a, device=system.dev)
                 for a in (rays_o, rays_d, noise))


def occupied_counts(system, rays_o, rays_d, noise) -> torch.Tensor:
    """Per-ray occupied steps of the whole chain on the fitted window
    rows, before the clip to 8 samples (`rm_counts`)."""
    from ngp_pl_torch.models.rendering import scene_hits
    from ngp_pl_torch.ops.ray_march import march_rays_train_strided

    cfg, rcfg = system.cfg, system.rcfg
    hits = scene_hits(rays_o, rays_d, cfg.scale)
    return march_rays_train_strided(
        rays_o, rays_d, hits, noise, system.grid_state.win_rows,
        cascades=cfg.cascades, scale=cfg.scale,
        exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
        max_samples=rcfg.max_samples, n_samples=8,
        chain_length=system.chain_full).rm_counts


def count_lines(c: np.ndarray) -> list:
    """The JAX script's three lines on the counts."""
    mass = max(c.sum(), 1)
    return [
        "occupied-count percentiles: "
        + str({q: int(np.percentile(c, q)) for q in PERCENTILES}),
        f"mean {c.mean():.1f}; frac>16 {np.mean(c > 16):.3f}"
        f" frac>24 {np.mean(c > 24):.3f} frac>32 {np.mean(c > 32):.3f}"
        f" frac>64 {np.mean(c > 64):.3f}",
        f"sample mass in rays>32: {c[c > 32].sum() / mass:.3f}; "
        f">64: {c[c > 64].sum() / mass:.3f}"]


def count_record(c: np.ndarray) -> dict:
    mass = max(int(c.sum()), 1)
    return {"percentiles": {q: int(np.percentile(c, q)) for q in PERCENTILES},
            "mean": float(c.mean()),
            **{f"frac>{k}": float(np.mean(c > k)) for k in (16, 24, 32, 64)},
            "mass>32": float(c[c > 32].sum() / mass),
            "mass>64": float(c[c > 64].sum() / mass)}


def inputs(system, rng, N: int = 196608) -> dict:
    """Part 2's and 3's inputs, drawn from `rng` after the rays."""
    from ngp_pl_torch.ops.hash_encoding import slots_local_frac_lm

    spec, dev = system.ngp.spec, system.dev
    L, W = spec.n_levels, spec.row_width
    xs = torch.from_numpy(rng.random((N, 3)).astype(np.float32)).to(dev)
    slot = slots_local_frac_lm(xs, spec)[0]
    d_bf = torch.from_numpy(rng.random((L, N, W))).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((N, 64), np.float32)).to(dev)
    return dict(spec=spec, N=N, xs=xs, slot=slot, d_bf=d_bf,
                d_f32=d_bf.float(), g=g,
                w1=system.ngp.sigma_mlp[0].detach(),
                packed=torch.zeros((spec.total_rows, W // 2),
                                   dtype=torch.int32, device=dev),
                packed_wide=torch.zeros((spec.total_rows, W),
                                        dtype=torch.int32, device=dev))


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, by KEYS."""
    from ngp_pl_torch.ops.hash_encoding import hash_encode_bwd

    spec, slot = inp["spec"], inp["slot"]
    L, W, N = spec.n_levels, spec.row_width, inp["N"]
    d_bf, d_f32 = inp["d_bf"], inp["d_f32"]
    off = torch.tensor(spec.offsets, device=slot.device)[:, None]
    local = slot - off

    def per_level(d, dtype):
        return [mp.scatter_add(spec.sizes[l], local[l], d[l], dtype)
                for l in range(L)]

    calls = [lambda: per_level(d_f32, torch.float32),
             lambda: per_level(d_bf, torch.float32),
             lambda: per_level(d_bf, torch.bfloat16),
             lambda: mp.scatter_add(spec.total_rows, slot.reshape(-1),
                                    d_bf.reshape(L * N, W), torch.float32)]
    for l in LEVELS:
        ordered = torch.sort(local[l]).values
        calls += [lambda l=l, s=s: mp.scatter_add(spec.sizes[l], s, d_bf[l],
                                                  torch.float32)
                  for s in (local[l], ordered)]
    calls += [lambda: inp["packed"][slot.reshape(-1)],
              lambda: inp["packed"][slot[:4].reshape(-1)],
              lambda: inp["packed_wide"][slot[:4].reshape(-1)],
              lambda: hash_encode_bwd(inp["xs"], inp["g"], inp["w1"], spec)]
    return dict(zip(KEYS, calls))


def references(inp: dict, fns: dict) -> dict:
    from ngp_pl_torch.ops.hash_encoding import hash_encode_bwd_plain

    return {PORT_LABELS[0]: ("K2+K5", lambda: hash_encode_bwd_plain(
        inp["xs"], inp["g"], inp["w1"], inp["spec"]))}


def time_parts(inp: dict, device, runs: int = 20, warmup: int = 3,
               log=sys.stderr) -> dict:
    """Parts 2 and 3 timed: {label: {"wall_ms", "device_ms"}}, the port's
    label with `kernel_device_ms` on the card."""
    fns = functions(inp)
    out = mp.time_labels(fns, device, runs, warmup, log, width=46)
    if torch.device(device).type == "cuda":
        from ngp_pl_torch.benchmarking.timing import device_ms

        out[PORT_LABELS[0]]["kernel_device_ms"] = device_ms(
            fns[PORT_LABELS[0]], (K2_KERNEL,), runs=runs)
    return out


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, steps: int = 512, batch: int = 8192,
        N: int = 196608, **kw) -> dict:
    """The fit, the counts and the timed parts: {"fit", "counts",
    "count_lines", "labels"}; `kw` overrides the train configuration."""
    system, fit = fit_system(device, steps, batch, **kw)
    rng = np.random.default_rng(0)
    c = occupied_counts(system, *count_rays(system, batch, rng))
    c = c.cpu().numpy()
    lines = count_lines(c)
    if log is not None:
        print("\n".join(lines), file=log, flush=True)
    return {"fit": fit, "counts": count_record(c), "count_lines": lines,
            "labels": time_parts(inputs(system, rng, N), device, runs,
                                 warmup, log)}


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
