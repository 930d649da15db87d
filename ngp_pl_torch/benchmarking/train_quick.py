"""A quick quality run on the procedural scene: 2000 steps at 256x256 on 24
views, then the two test views scored and dumped, the counterpart of the
JAX repository's _train_tpu.py.

    python -m ngp_pl_torch.benchmarking.train_quick [--device cuda]
        [--steps 2000 --img_size 256 --n_train 24]

The JAX script's `TrainConfig` (`config`: batch 8192, 2 epochs of 1000
iterations, log every 200 steps, no test dumps after the fit, the run
named "qual") and its scene (`SyntheticDataset(split="train",
img_size=256, n_train=24)`, `(split="test", img_size=256, n_test=2)`);
`NeRFSystem.fit(max_steps=steps)`, then `validate(save_images=True)`
(results/synthetic/qual/NNN.png and NNN_d.png under the working
directory).  It prints the JAX script's three lines, `[Ns] data ready`,
`[Ns] trained` and `[Ns] val: {scores}` (seconds since the start), then a
JSON line with the seconds of each part, the scores, the fit's first and
last logged loss and the launches of K1, K2+K5, K7 and K8 (0 on the CPU,
where the plain versions run).
"""
from __future__ import annotations

import argparse
import json
import time

KERNELS = ("K1", "K2+K5", "K7", "K8")
CONFIG = dict(dataset_name="synthetic", batch_size=8192, num_epochs=2,
              iters_per_epoch=1000, exp_name="qual", no_save_test=True,
              log_every=200)


def config(**kw):
    """The JAX script's TrainConfig, `kw` replacing fields."""
    from ngp_pl_torch.config import TrainConfig

    return TrainConfig(**{**CONFIG, **kw})


def _counters():
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    return dict(zip(KERNELS, (he.hash_encode_fwd_cuda,
                              he.hash_encode_bwd_cuda, ft.field_tail_cuda,
                              ft.field_tail_bwd_cuda)))


def run(device: str = "cuda", steps: int = 2000, img_size: int = 256,
        n_train: int = 24, emit=print, **kw) -> dict:
    """The run; `kw` replaces fields of the configuration.  Returns the
    record of the JSON line."""
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.device import card_line, sync
    from ngp_pl_torch.training.system import NeRFSystem

    t0 = time.time()
    counters = _counters()
    before = {k: c.launches for k, c in counters.items()}
    train_ds = SyntheticDataset(split="train", img_size=img_size,
                                n_train=n_train, device=device)
    test_ds = SyntheticDataset(split="test", img_size=img_size, n_test=2,
                               device=device)
    t_data = time.time() - t0
    emit(f"[{t_data:.0f}s] data ready")
    system = NeRFSystem(config(**kw), train_dataset=train_ds,
                        test_dataset=test_ds, device=device)
    hist = system.fit(max_steps=steps)
    sync(device)
    t_fit = time.time() - t0
    emit(f"[{t_fit:.0f}s] trained")
    scores = system.validate(save_images=True)
    t_val = time.time() - t0
    emit(f"[{t_val:.0f}s] val: {scores}")
    losses = [h["loss"] for h in hist]
    return {"card": card_line(device), "steps": steps, "img_size": img_size,
            "n_train": n_train, "seconds": {"data": t_data,
                                            "fit": t_fit - t_data,
                                            "validate": t_val - t_fit,
                                            "total": t_val},
            "scores": scores, "loss_first": losses[0],
            "loss_last": losses[-1], "logged_losses": losses,
            "launches": {k: c.launches - before[k]
                         for k, c in counters.items()}}


def main(argv=None) -> dict:
    from ngp_pl_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--n_train", type=int, default=24)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rec = run(args.device, args.steps, args.img_size, args.n_train)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
