"""The per-stage train-step profile (`ngp_pl_torch.benchmarking.
profile_step`), the counterpart of benchmarking/profile_step.py: its stage
names are the JAX script's, every stage runs at a tiny size on the CPU in
both layouts, and its march is the one the system's own step marches."""
import functools
import json
import math
import pathlib
import re

import pytest
import torch

from ngp_pl_torch.benchmarking import profile_step as ps
from ngp_pl_torch.training.train_step import train_render

torch.set_num_threads(2)

JAX_SCRIPT = pathlib.Path(__file__).resolve().parent.parent / \
    "benchmarking" / "profile_step.py"
TINY = dict(n_levels=4, log2_hashmap_size=12)


def test_stage_names_are_jax_names():
    names = re.findall(r'timeit\("([^"]+)"', JAX_SCRIPT.read_text())
    assert tuple(names) == ps.STAGES


@pytest.mark.parametrize("layout", ps.LAYOUTS)
def test_stages_run_and_march_matches_step(layout):
    """One warm block at batch 256, every stage once: finite wall ms, no
    device ms on the CPU; then the march stage's pool against the march of
    `train_render`, the system's step, on the same rays and noise."""
    system = ps.profile_system("cpu", 256, layout, **TINY)
    rec = ps.run(system, layout, warm=16, runs=1, grid_runs=1, warmup=0)
    assert tuple(rec["stages"]) == ps.STAGES
    for name, t in rec["stages"].items():
        assert math.isfinite(t["wall_ms"]) and t["wall_ms"] > 0, name
        assert t["device_ms"] is None, name
    setup = rec["setup"]
    assert setup["layout"] == layout and setup["card"] == "cpu"
    assert setup["samples"] > 0
    rays_o, rays_d, noise = ps.ray_batch(system)
    _, m = ps.stage_fns(system, layout, rays_o, rays_d, noise)
    gs = system.grid_state
    with torch.no_grad():
        ref, _ = train_render(
            system.ngp, gs.win_rows if system.window_march else None,
            rays_o, rays_d, noise, torch.ones(3), tcfg=system.tcfg,
            rcfg=system.rcfg, n_samples=system._pool_mult,
            chain_length=system.chain_length, layout=layout,
            occ_grid=gs.occ_grid)
    assert torch.equal(m.ts, ref["ts"])
    assert torch.equal(m.deltas, ref["deltas"])
    if layout == "strided":
        assert torch.equal(m.valid, ref["valid"])
    else:
        assert torch.equal(m.ray_idx, ref["ray_idx"])
        assert torch.equal(m.valid, ref["pool_valid"])
        assert torch.equal(m.offsets, ref["offsets"])
    assert int(m.total) == int(ref["rm_samples"])


def test_main_prints_stage_json(monkeypatch, capsys):
    make = ps.profile_system
    monkeypatch.setattr(ps, "profile_system", lambda *a, **kw: make(
        *a, **{**kw, "log2_hashmap_size": 12}))
    monkeypatch.setattr(ps, "run", functools.partial(
        ps.run, runs=1, grid_runs=1, warmup=0))
    ps.main(["--device", "cpu", "--batch", "128", "--warm", "0",
             "--n_levels", "4", "--layout", "csr"])
    lines = capsys.readouterr().out.strip().splitlines()
    setup, stages = json.loads(lines[-2]), json.loads(lines[-1])
    assert setup["layout"] == "csr" and setup["batch"] == 128
    assert list(stages) == list(ps.STAGES)
    assert all(set(v) == {"wall_ms", "device_ms"} for v in stages.values())


def test_rejects_other_layouts():
    with pytest.raises(ValueError):
        ps.run(object(), "rounds")
