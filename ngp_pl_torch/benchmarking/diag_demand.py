"""The budget-demand vector of every 16-step block on the bench scene: the
counterpart of benchmarking/diag_demand.py.

    python -m ngp_pl_torch.benchmarking.diag_demand [--blocks 100]
        [--device cuda]

bench.py's system (`bench.bench_system`: the flagship on 8 views at
96x96, batch 8192, 30 epochs) from `on_train_start`, then `--blocks`
blocks of `NeRFSystem.step_block` (100, the JAX script's count); after
each, the block's `demand_vec` (the element-wise max over its steps) read
field by field by name (`train_step.DEMAND_KEYS`), with the pool
multiple, chain and pool demand the controller then holds.  The JAX
script unpacks the vector into seven values, but its package's vector has
nine (ngp_pl_tpu/training/train_step.py:249-259), so it stops at its first
block; its line is printed here with the two last fields after it.  One
line a block on stdout, then a JSON line of every block's record.
"""
from __future__ import annotations

import argparse
import json
import math


def demand_fields(vec) -> dict:
    """A demand vector (9,) as {field: float} by `DEMAND_KEYS`."""
    from ngp_pl_torch.training.train_step import DEMAND_KEYS

    vals = [float(v) for v in vec.tolist()]
    if len(vals) != len(DEMAND_KEYS):
        raise ValueError(f"a demand vector of {len(vals)} fields, want "
                         f"{len(DEMAND_KEYS)}")
    return dict(zip(DEMAND_KEYS, vals))


def block_line(i: int, system, d: dict) -> str:
    """The JAX script's line, then the two fields it leaves out."""
    B = system.tcfg.batch_size
    rm = d["rm_samples"]
    return (f"blk {i:3d} pool x{system._pool_mult} chain "
            f"{system.chain_length} rm_tot {rm:.0f} rm/ray {rm / B:.1f} "
            f"rm_q99 {d['rm_counts_q']:.0f} vr_q99 {d['vr_counts_q']:.0f} "
            f"vr_q90 {d['vr_counts_q90']:.0f} vr_mean "
            f"{d['vr_counts_mean']:.1f} pd {system._pool_demand:.1f} "
            f"alive_end {d['rounds_alive_end']:.0f} rm_mean "
            f"{d['rm_counts_mean']:.1f}")


def run(system, blocks: int, emit=print) -> list:
    """`blocks` blocks from `on_train_start`; each block's record."""
    system.on_train_start()
    out = []
    for i in range(blocks):
        m = system.step_block()
        d = demand_fields(m["demand_vec"])
        emit(block_line(i, system, d))
        out.append({"block": i, "layout": system.layout,
                    "pool_mult": system._pool_mult,
                    "chain_length": system.chain_length,
                    "pool_demand": system._pool_demand, **d})
    return out


def all_finite(recs) -> bool:
    """Every block's nine fields finite."""
    from ngp_pl_torch.training.train_step import DEMAND_KEYS

    return all(math.isfinite(r[k]) for r in recs for k in DEMAND_KEYS)


def main(argv=None) -> list:
    from ngp_pl_torch.benchmarking.bench import bench_system
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    system = bench_system(args.device, 8192, exp_name="diag")
    recs = run(system, args.blocks)
    print(json.dumps({"card": card_line(args.device), "blocks": recs}),
          flush=True)
    return recs


if __name__ == "__main__":
    main()
