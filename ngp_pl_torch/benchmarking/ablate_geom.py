"""Quality and speed of the two hash-table geometries on the procedural
scene, the counterpart of benchmarking/ablate_geom.py.

    python -m ngp_pl_torch.benchmarking.ablate_geom [--steps 1536]
        [--only L16F2|L8F4] [--device cuda]

(L=16, F=2): the reference's tinycudann geometry (K3, K4 on the card).
(L=8, F=4): the flagship, equal in parameters (K1, K2+K5).
Each trains on 8 procedural views at 96x96 (batch 8192, 2 test views) for
`--steps` steps in 16-step blocks (a step at a time when `--steps` is not
a multiple of 16), then freezes its buckets and takes 64 more steps for
the rays/s (host clock, fenced by reading the last loss), then scores the
test views (`validate`) and prints the JAX script's line
`tag: rays/s R  psnr P  ssim S  layout L xS`.  Progress every 256 steps
goes to stderr.
"""
from __future__ import annotations

import argparse
import sys
import time

GEOMETRIES = (("L16F2", 16, 2), ("L8F4", 8, 4))
TIMED_STEPS = 64
LOG_EVERY = 256


def system_for(n_levels: int, n_features: int, steps: int, device: str,
               batch: int = 8192, tag: str = "", img_size: int = 96, **kw):
    """The JAX script's system: the synthetic scene's 8 train views and 2
    test views at 96x96 (`img_size`), `steps // 1000` epochs of 1000 (at
    least one)."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    tcfg = TrainConfig(dataset_name="synthetic", batch_size=batch,
                       num_epochs=max(1, steps // 1000),
                       iters_per_epoch=1000, exp_name=f"ablate_{tag}",
                       no_save_test=True, n_levels=n_levels,
                       n_features=n_features, **kw)
    return NeRFSystem(
        tcfg, device=device,
        train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                       n_train=8, device=device),
        test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                      n_test=2, device=device))


def _steps(system, n: int, tag: str, log):
    """`n` steps, in blocks where they align; the last metrics."""
    nb = system.tcfg.grid_update_interval
    m = None
    if n % nb == 0 and system._host_step % nb == 0:
        for i in range(n // nb):
            m = system.step_block()
            if ((i + 1) * nb) % LOG_EVERY == 0 and log is not None:
                print(f"  {tag} {(i + 1) * nb}/{n} loss "
                      f"{float(m['loss']):.4f}", file=log, flush=True)
    else:
        for i in range(n):
            m = system.step()
            if (i + 1) % LOG_EVERY == 0 and log is not None:
                print(f"  {tag} {i + 1}/{n} loss {float(m['loss']):.4f}",
                      file=log, flush=True)
    return m


def run(tag: str, system, steps: int, timed_steps: int = None,
        log=sys.stderr, emit=print) -> dict:
    """Train, time (`timed_steps`, TIMED_STEPS where None), score
    `system`; emits the JAX script's line and returns its numbers."""
    timed_steps = timed_steps or TIMED_STEPS
    system.on_train_start()
    m = _steps(system, steps, tag, log)
    loss = float(m["loss"]) if m is not None else float("nan")
    system.freeze_buckets = True
    t0 = time.perf_counter()
    m = _steps(system, timed_steps, tag, None)
    float(m["loss"])
    rps = system.tcfg.batch_size * timed_steps / (time.perf_counter() - t0)
    scores = system.validate(save_images=False)
    rec = {"tag": tag, "rays_per_s": rps,
           "psnr": scores.get("psnr", float("nan")),
           "ssim": scores.get("ssim", float("nan")),
           "layout": system.layout, "pool_mult": system._pool_mult,
           "steps": steps, "train_loss": loss}
    emit(f"{tag}: rays/s {rps:.0f}  psnr {rec['psnr']:.2f}"
         f"  ssim {rec['ssim']:.4f}"
         f"  layout {rec['layout']} x{rec['pool_mult']}")
    return rec


def main(argv=None) -> list:
    from ngp_pl_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1536)
    ap.add_argument("--only", type=str, default="",
                    help="run a single geometry: L16F2 or L8F4")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = []
    tags = {tag for tag, _, _ in GEOMETRIES}
    for tag, n_levels, n_features in GEOMETRIES:
        if args.only in tags - {tag}:       # the other geometry alone
            continue
        system = system_for(n_levels, n_features, args.steps, args.device,
                            tag=tag)
        out.append(run(tag, system, args.steps,
                       emit=lambda s: print(s, flush=True)))
        del system
    return out


if __name__ == "__main__":
    main()
