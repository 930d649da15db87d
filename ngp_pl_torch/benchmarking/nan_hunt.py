"""Reproduce and bisect a long run's first non-finite loss: the counterpart
of benchmarking/nan_hunt.py.

    [HUNT_STEPS=16384] [HUNT_EPOCHS=30] python -m \
        ngp_pl_torch.benchmarking.nan_hunt [--device cuda]

The JAX script's system (`build_system`: the flagship on bench.py's 8
views at 96x96, batch 8192, two test views, HUNT_EPOCHS epochs of 1000
steps for the lr schedule, by default HUNT_STEPS // 1000) trains in
16-step blocks (`NeRFSystem.step_block`), snapshotting before every block
(`snapshot`) and printing a line every 512 steps.  At the first block
whose loss is not finite, the snapshot before it goes to SNAP_PATH (npz,
under build/; `nan_replay` replays it) and `replay_block` runs that block
again step by step from the snapshot: at the first non-finite loss it
restores the state from just before that step and runs
`nan_probe.probe`, then prints the parameters' leaf statistics before and
after the step, Adam's moments after it and the grid's occupied share.

A snapshot is everything `step_block` reads: the parameters, Adam's
moments and count, the grid state, the torch generator's state and the
numpy generator's (host batches), the host step, and the controller's
layout, budget, chain, pool and chain demands, votes and pending demand
(read from its host copy).  Restored into a system of the same
configuration it gives the same block again, bit for bit on the CPU; on
the card the table gradient's atomics add in another order each run.
Pose refinement is not in a snapshot.
"""
from __future__ import annotations

import copy
import json
import math
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SNAP_PATH = os.path.join(REPO, "build", "nan_hunt", "_nan_snap.npz")
# the controller's state besides the layout, budget and chain
CONTROLLER = ("_host_step", "layout", "_pool_mult", "chain_length",
              "_pool_demand", "_chain_demand", "_layout_vote",
              "_shrink_votes")


def build_system(epochs: int, device="cuda", batch_size: int = 8192):
    """The JAX script's system, after `on_train_start`."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.datasets.synthetic import SyntheticDataset
    from ngp_pl_torch.training.system import NeRFSystem

    tcfg = TrainConfig(dataset_name="synthetic", batch_size=batch_size,
                       num_epochs=epochs, iters_per_epoch=1000,
                       exp_name="nan_hunt", no_save_test=True)
    system = NeRFSystem(
        tcfg, device=device,
        train_dataset=SyntheticDataset(split="train", img_size=96, n_train=8,
                                       device=device),
        test_dataset=SyntheticDataset(split="test", img_size=96, n_test=2,
                                      device=device))
    system.on_train_start()
    return system


def snapshot(system) -> dict:
    """The state `step_block` reads, as numpy arrays and plain values."""
    from ngp_pl_torch.training.checkpoint import (
        grid_state_numpy,
        train_state_numpy,
    )

    if system.pose is not None:
        raise NotImplementedError("pose refinement is not in a snapshot")
    # copies: on the CPU `.cpu().numpy()` shares the live tensors' memory
    params, mu, nu, count = copy.deepcopy(
        train_state_numpy(system.ngp, system.optimizer))
    pending = system._pending_demand
    if pending is not None:
        if pending[1] is not None:
            pending[1].synchronize()
        pending = pending[0].numpy().copy()
    return {"params": params, "mu": mu, "nu": nu, "count": count,
            "grid": copy.deepcopy(grid_state_numpy(system.grid_state)),
            "generator": system.generator.get_state().numpy().copy(),
            "rng": json.dumps(system._rng.bit_generator.state),
            "pending_demand": pending,
            **{k: getattr(system, k) for k in CONTROLLER}}


def restore(system, snap: dict) -> None:
    """Put `snapshot`'s state back into a system of the same
    configuration."""
    from ngp_pl_torch.training.checkpoint import (
        grid_state_from_numpy,
        load_train_state,
    )

    load_train_state(system.ngp, system.optimizer, snap["params"],
                     snap["mu"], snap["nu"], snap["count"])
    system.grid_state = grid_state_from_numpy(snap["grid"], system.dev)
    system.generator.set_state(torch.from_numpy(snap["generator"]))
    system._rng.bit_generator.state = json.loads(snap["rng"])
    pending = snap["pending_demand"]
    system._pending_demand = (None if pending is None else
                              (torch.from_numpy(np.array(pending)), None))
    for k in CONTROLLER:
        setattr(system, k, snap[k])


def save_snapshot(path: str, snap: dict, **meta) -> None:
    """`snap` as one npz (the full checkpoint's keys for the train and grid
    state, `hunt.*` for the rest), with `meta` (steps, epochs) beside."""
    from ngp_pl_torch.training.checkpoint import _full_arrays

    data = _full_arrays(snap["params"], snap["mu"], snap["nu"],
                        snap["count"], snap["grid"])
    data["hunt.generator"] = snap["generator"]
    if snap["pending_demand"] is not None:
        data["hunt.pending_demand"] = snap["pending_demand"]
    rest = {k: snap[k] for k in CONTROLLER + ("rng",)}
    data["hunt.state"] = np.frombuffer(
        json.dumps({**rest, "meta": meta}).encode(), np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


def _hunt_state(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return json.loads(f["hunt.state"].tobytes().decode())


def snapshot_meta(path: str) -> dict:
    """The `meta` that `save_snapshot` wrote beside the snapshot."""
    return _hunt_state(path)["meta"]


def load_snapshot(path: str, system) -> dict:
    """The snapshot in `save_snapshot`'s file; `system` gives the structure
    of the train and grid state."""
    from ngp_pl_torch.training.checkpoint import load_checkpoint

    params, mu, nu, count, grid, _, _ = load_checkpoint(
        path, **system._state_numpy())
    state = _hunt_state(path)
    del state["meta"]
    with np.load(path, allow_pickle=False) as f:
        gen = f["hunt.generator"]
        pending = (f["hunt.pending_demand"] if "hunt.pending_demand" in f
                   else None)
    return {"params": params, "mu": mu, "nu": nu, "count": count,
            "grid": grid, "generator": gen, "pending_demand": pending,
            **state}


def leaf_stats(named) -> list:
    """(name, absmax, NaN count, inf count) of each floating tensor."""
    out = []
    for name, t in named:
        a = t.detach().double().cpu()
        out.append((name, float(a[torch.isfinite(a)].abs().max())
                    if bool(torch.isfinite(a).any()) else math.nan,
                    int(torch.isnan(a).sum()), int(torch.isinf(a).sum())))
    return out


def _named(system, what: str):
    from ngp_pl_torch.benchmarking.nan_probe import leaf_name

    slots = list(system.ngp._slots())
    if what == "params":
        return [("params" + leaf_name(n, i), w) for n, i, w in slots]
    opt = system.optimizer
    return [(f"opt.{k}" + leaf_name(n, i), t)
            for k, ts in (("mu", opt.mu), ("nu", opt.nu))
            for (n, i, _), t in zip(slots, ts)]


def hunt(system, steps: int, log=print):
    """Blocks until `steps` or the first block whose loss is not finite.
    Returns (the snapshot before the last block run, its index, the
    losses of every block, whether the last one was non-finite)."""
    nb = system.tcfg.grid_update_interval
    B = system.tcfg.batch_size
    snap, losses = None, []
    for i in range(steps // nb):
        snap = snapshot(system)
        m = system.step_block()
        loss = float(m["loss"])
        losses.append(loss)
        step_now = (i + 1) * nb
        if step_now % 512 == 0:
            tbl = float(system.ngp.hash_table.detach().abs().max())
            log(f"step {step_now:6d} loss {loss:.5f} rm_s "
                f"{float(m['rm_samples']) / B:5.1f} tbl_absmax {tbl:9.2f} "
                f"S {system._pool_mult} {system.layout}")
        if not math.isfinite(loss):
            log(f"*** non-finite loss in block ending at step {step_now}")
            return snap, i, losses, True
    return snap, len(losses) - 1, losses, False


def replay_block(system, snap: dict, log=print) -> dict:
    """Restore `snap`, run its block step by step; at the first step with
    a non-finite loss, restore the state from just before it and probe it
    (`nan_probe.probe`).  Returns the block's step losses and, where a
    step failed, its step, the probe's record and the leaf statistics."""
    from ngp_pl_torch.benchmarking.nan_probe import probe

    restore(system, snap)
    log("replaying the failing block step-by-step...")
    before = {}
    own = vars(system).get("_train_step")     # a caller's patch, if any
    real = system._train_step

    def spied():
        before["snap"] = snapshot(system)
        return real()

    system._train_step = spied
    out = {"losses": [], "first_bad_step": None}
    try:
        for _ in range(system.tcfg.grid_update_interval):
            loss = float(system.step()["loss"])
            out["losses"].append(loss)
            log(f"  step {system._host_step}: loss {loss:.6f}")
            if not math.isfinite(loss):
                break
    finally:
        if own is None:
            del system._train_step
        else:
            system._train_step = own
    if math.isfinite(out["losses"][-1]):
        return out
    after = {k: leaf_stats(_named(system, k)) for k in ("params", "opt")}
    restore(system, before["snap"])
    out["first_bad_step"] = system._host_step
    out["probe"] = probe(system, log=log)
    out["before"] = leaf_stats(_named(system, "params"))
    out["after"] = after
    log("  first bad step found; param stats BEFORE:")
    for k, mx, nn, ni in out["before"]:
        flag = " <== " if (nn or ni) else ""
        log(f"    {k:60s} absmax {mx:12.4e} nan {nn} inf {ni}{flag}")
    log("  param stats AFTER:")
    for k, mx, nn, ni in after["params"]:
        if nn or ni or mx > 1e4:
            log(f"    {k:60s} absmax {mx:12.4e} nan {nn} inf {ni}")
    log("  opt state after:")
    for k, mx, nn, ni in after["opt"]:
        if nn or ni or mx > 1e6:
            log(f"    {k:60s} absmax {mx:12.4e} nan {nn} inf {ni}")
    occ = float((system.grid_state.occ_grid > 0).float().mean())
    out["occupied"] = occ
    log(f"  occ occupancy {occ:.4f}")
    return out


def main(argv=None):
    import argparse

    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(card_line(args.device), flush=True)
    steps = int(os.environ.get("HUNT_STEPS", 16384))
    # HUNT_EPOCHS pins the lr schedule's length apart from how far the
    # hunt runs, as in the JAX script
    epochs = int(os.environ.get("HUNT_EPOCHS", max(1, steps // 1000)))
    system = build_system(epochs, args.device)
    snap, _, _, bad = hunt(system, steps,
                           log=lambda s: print(s, flush=True))
    if not bad:
        print("no NaN reproduced", flush=True)
        return None
    save_snapshot(SNAP_PATH, snap, steps=steps, epochs=epochs)
    print(f"pre-failure snapshot -> {SNAP_PATH}", flush=True)
    return replay_block(system, snap, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
