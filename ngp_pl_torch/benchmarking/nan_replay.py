"""Replay the failing block from `nan_hunt`'s snapshot without training to
it again: the counterpart of benchmarking/nan_replay.py.

    python -m ngp_pl_torch.benchmarking.nan_replay [SNAPSHOT.npz]
        [--device cuda]

The snapshot (default `nan_hunt.SNAP_PATH`, under build/) holds the state
one block before the first non-finite loss, and the hunt's step count and
lr schedule; `replay` builds the JAX script's system with that schedule
(`nan_hunt.build_system`), restores the snapshot and replays the block
step by step (`nan_hunt.replay_block`: at the first non-finite loss, the
probe and the leaf statistics).
"""
from __future__ import annotations

import argparse


def replay(path: str, device="cuda", system=None, log=print) -> dict:
    """`replay_block` from the snapshot at `path`, in `system` or in a new
    one of the hunt's configuration."""
    from ngp_pl_torch.benchmarking import nan_hunt

    meta = nan_hunt.snapshot_meta(path)
    if system is None:
        system = nan_hunt.build_system(meta["epochs"], device)
    snap = nan_hunt.load_snapshot(path, system)
    log(f"replaying from {path} (host_step {snap['_host_step']}, "
        f"schedule {meta['epochs']} epochs)")
    return nan_hunt.replay_block(system, snap, log=log)


def main(argv=None) -> dict:
    from ngp_pl_torch.benchmarking.nan_hunt import SNAP_PATH
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=SNAP_PATH)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(card_line(args.device), flush=True)
    return replay(args.path, args.device,
                  log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
