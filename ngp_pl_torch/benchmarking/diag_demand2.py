"""The demand and layout controller traced interval by interval at the
bench's shapes: the counterpart of benchmarking/diag_demand2.py.

    [PROF_BATCH=8192] [PROF_WARM=768] python -m \
        ngp_pl_torch.benchmarking.diag_demand2 [--device cuda]

bench.py's system at batch PROF_BATCH (`bench.bench_system`, 30 epochs)
from `on_train_start`, then PROF_WARM // 16 blocks of
`NeRFSystem.step_block`.  After each, the vector the controller holds for
the next interval (`_pending_demand`: the block's demand, copied to the
host without a wait; here its copy's event is waited on), its nine fields
by name, beside the layout, S, chain and pool demand the controller then
holds; the JAX script's line a block on stdout, then a JSON line of every
block's record.
"""
from __future__ import annotations

import json
import os


def pending_fields(system):
    """The demand vector the controller holds for its next interval, by
    field, or None before the first block."""
    from ngp_pl_torch.benchmarking.diag_demand import demand_fields

    pending = system._pending_demand
    if pending is None:
        return None
    host, event = pending
    if event is not None:
        event.synchronize()
    return demand_fields(host)


def run(system, warm: int, emit=print) -> list:
    """`warm // grid_update_interval` blocks; each block's record."""
    B = system.tcfg.batch_size
    system.on_train_start()
    out = []
    for i in range(warm // system.tcfg.grid_update_interval):
        system.step_block()
        d = pending_fields(system)
        if d is None:
            continue
        emit(f"blk {i:3d} layout {system.layout:8s} S "
             f"{system._pool_mult:3d} chain {system.chain_length:5d} pd "
             f"{system._pool_demand:6.1f} | rm_mean {d['rm_samples'] / B:5.1f}"
             f" rm_q99 {d['rm_counts_q']:6.1f} vr_q99 {d['vr_counts_q']:6.1f}"
             f" vr_mean {d['vr_counts_mean']:5.1f} rm_pre "
             f"{d['rm_counts_mean']:5.1f} chain_q {d['chain_demand_q']:6.0f}")
        out.append({"block": i, "layout": system.layout,
                    "S": system._pool_mult,
                    "chain_length": system.chain_length,
                    "pool_demand": system._pool_demand, **d})
    return out


def main(argv=None) -> list:
    import argparse

    from ngp_pl_torch.benchmarking.bench import bench_system
    from ngp_pl_torch.device import card_line, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    batch = int(os.environ.get("PROF_BATCH", 8192))
    system = bench_system(args.device, batch, exp_name="diag2")
    recs = run(system, int(os.environ.get("PROF_WARM", 768)))
    print(json.dumps({"card": card_line(args.device), "blocks": recs}),
          flush=True)
    return recs


if __name__ == "__main__":
    main()
