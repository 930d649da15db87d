"""The JAX repository's serving and march probes in the port
(`ngp_pl_torch.benchmarking.fps_ablate`, `debug_fps`, `fps_sweep`,
`tune_fps`, `micro_march`): their labels, ladders and configurations are
the JAX scripts', read from those files; each runs on the CPU at a tiny
size; debug_fps's frame has `RoundRenderer`'s rounds and samples; and
micro_march's stages compose to `march_rays_train_window`'s pool bit for
bit."""
import ast
import json
import math
import pathlib
import re

import pytest
import torch

from ngp_pl_torch.benchmarking import (
    bench_fps,
    debug_fps,
    fps_ablate,
    fps_sweep,
    micro_march,
    tune_fps,
)
from ngp_pl_torch.models.rendering import RoundRenderer, ladder

torch.set_num_threads(2)

JAX_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarking"
TINY = dict(n_levels=4, log2_hashmap_size=12, batch_size=256)
SIZE = 32


def _jax_source(name):
    return (JAX_DIR / f"{name}.py").read_text()


def _jax_ladder():
    """benchmarking/fps_sweep.py's `ladder`, compiled from its source."""
    tree = ast.parse(_jax_source("fps_sweep"))
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "ladder")
    ns = {}
    exec(compile(ast.Module([fn], []), "fps_sweep.py", "exec"), ns)
    return ns["ladder"]


def _assigned(source, target):
    """The value node assigned to the name `target` in `source`."""
    return next(n.value for n in ast.walk(ast.parse(source))
                if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == target
                    for t in n.targets))


def test_fps_ablate_labels_are_jax():
    src = _jax_source("fps_ablate")
    assert tuple(re.findall(r'bench\("([^"]+)"', src)) == fps_ablate.TAGS
    assert 'f"field share ~= ' in src


def test_debug_fps_labels_are_jax():
    src = _jax_source("debug_fps")
    m = re.search(r'tag = "([^"]+)" if NO_FIELD else "([^"]+)"', src)
    assert (debug_fps.TAGS[True], debug_fps.TAGS[False]) == m.groups()
    assert re.search(r"chunk = (\d+)", src).group(1) == str(debug_fps.CHUNK)


def test_fps_sweep_ladders_are_jax():
    """The port's `ladder` is the JAX script's, and its five configurations
    are the JAX script's dict evaluated with that `ladder`."""
    jax_ladder = _jax_ladder()
    for args in ((131072,), (65536, 16, 2, 128, 96), (4096, 8, 4, 256, 128),
                 (256,)):
        assert ladder(*args) == jax_ladder(*args), args
    configs = eval(compile(ast.Expression(_assigned(
        _jax_source("fps_sweep"), "configs")), "fps_sweep.py", "eval"),
        {"ladder": jax_ladder, "C": fps_sweep.C})
    assert fps_sweep.configs() == configs
    assert list(configs) == list(fps_sweep.configs())


def test_tune_fps_schedules_are_jax():
    src = _jax_source("tune_fps")
    assert tune_fps.CANDIDATES == ast.literal_eval(_assigned(src, "cands"))
    loop = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.For) and isinstance(n.target, ast.Tuple)
                and [e.id for e in n.target.elts] == ["chunk", "pm", "chain"])
    assert tune_fps.ONESHOT == ast.literal_eval(loop.iter)


def test_micro_march_labels_are_jax():
    labels = re.findall(r'timeit\("([^"]+)"', _jax_source("micro_march"))
    assert tuple(labels[:3]) == micro_march.STAGES


@pytest.fixture(scope="module")
def system():
    """bench_fps's system at L=4, T=2^12, batch 256 after 32 steps."""
    system = bench_fps.fps_system("cpu", **TINY)
    bench_fps.train(system, 32)
    return system


def _frame(system, size=SIZE, **kw):
    render = bench_fps.renderer(system.ngp, system.rcfg,
                                bench_fps.camera(system, size)[0],
                                kw.pop("chunk"), **kw)
    _, dirs_t, pose_t = bench_fps.frame_inputs(system, size)
    return render.render_pose(system.grid_state.occ_grid, dirs_t, pose_t)


@pytest.mark.parametrize("no_field", [False, True])
def test_debug_fps_equals_round_renderer(system, no_field):
    """Rounds and total samples of the frame equal `RoundRenderer`'s at
    the same chunk (here 256, so that the frame takes several chunks)."""
    lines = []
    rec = debug_fps.run(system, SIZE, no_field, chunk=256, emit=lines.append)
    ref = _frame(system, chunk=256, debug_const_field=no_field)
    assert rec["rounds"] == ref["rounds"] > 0
    assert rec["total_samples"] == ref["total_samples"] > 0
    assert rec["alive_rays"] == ref["alive_rays"]
    assert sum(b["rounds"] for b in rec["buckets"]) == rec["rounds"]
    assert sum(b["marched"] for b in rec["buckets"]) == rec["total_samples"]
    assert lines[0].startswith("span pass ")
    assert lines[2].startswith(f"[{debug_fps.TAGS[no_field]}] rounds ")


def test_fps_ablate_runs(system):
    lines = []
    rec = fps_ablate.run(system, SIZE, frames=1, emit=lines.append)
    assert [ln.split()[0] for ln in lines[:2]] == list(fps_ablate.TAGS)
    assert lines[2].startswith("field share ~= ")
    assert math.isfinite(rec["field_share"]) and rec["card"] == "cpu"
    assert all(r["finite"] and r["frame_ms"] > 0
               for r in rec["frames"].values())
    assert rec["frames"]["full"]["launches"] == {"K1": 0, "K7": 0}


def test_fps_sweep_runs(system):
    lines = []
    rec = fps_sweep.run(system, SIZE, frames=1, chunk=4096,
                        emit=lines.append)
    assert list(rec["configs"]) == list(fps_sweep.configs())
    assert [ln.split()[0] for ln in lines] == list(fps_sweep.configs())
    assert all(r["finite"] and r["fps"] > 0 and r["rounds"] > 0
               for r in rec["configs"].values())


def test_tune_fps_main_and_oneshot(system, tmp_path, monkeypatch, capsys):
    """`main` loads the slim checkpoint it finds (here the tiny system's)
    and times one schedule; the one-shot renderer at a small chunk."""
    ckpt = str(tmp_path / "slim.npz")
    system.save_slim(ckpt)
    make = bench_fps.fps_system
    monkeypatch.setattr(bench_fps, "fps_system",
                        lambda device: make(device, **TINY))
    rec = tune_fps.main(["--ckpt", ckpt, "--size", str(SIZE), "--device",
                         "cpu", "--only", "flat S32"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("flat S32 ")
    assert json.loads(out[-1])["schedules"].keys() == {"flat S32"}
    assert rec["schedules"]["flat S32"]["finite"]
    one = tune_fps.run_oneshot(system, SIZE, configs=((512, 8, 256),),
                               emit=lambda line: None)
    assert one["oneshot"][0]["finite"] and one["window"]
    assert one["oneshot"][0]["samples_per_ray"] > 0


SHAPE = dict(N=64, K=96, G=16, pool=2048)


def test_micro_march_stages_compose_to_march():
    """The window chain's bits, cut to each ray's box as the march cuts
    them, through the compaction steps give `march_rays_train_window`'s
    pool bit for bit; the steps give `_compact_to_pool`'s on the 25%
    candidates."""
    inp = micro_march.inputs("cpu", **SHAPE)
    fns = micro_march.stage_fns(inp)
    occ, ts = fns[micro_march.STAGES[0]]()
    N, K = SHAPE["N"], SHAPE["K"]
    occ, ts = occ.reshape(N, K), ts.reshape(N, K)
    t1, t2 = inp["hits"][:, 0], inp["hits"][:, 1]
    occ = occ & (t1 >= 0)[:, None] & (ts >= 0) & (ts < t2[:, None])
    _, pool = micro_march.compact_step_fns(occ, inp["t0"], inp["pool"],
                                           inp["dt_min"])
    m = fns[micro_march.STAGES[2]]()
    assert int(m.total) > 0
    for got, want in zip(pool, (m.ts, m.deltas, m.ray_idx, m.valid,
                                m.offsets, m.total, m.rm_counts)):
        assert torch.equal(got, want)
    _, pool = micro_march.compact_step_fns(inp["occ25"], inp["t0"],
                                           inp["pool"], inp["dt_min"])
    ref = fns[micro_march.STAGES[1]]()
    for got, want in zip(pool, [ref[i] for i in (0, 1, 2, 3, 5, 6, 7)]):
        assert torch.equal(got, want)


def test_micro_march_runs():
    rec = micro_march.run("cpu", runs=1, warmup=0, log=None, **SHAPE)
    assert tuple(rec) == micro_march.STAGES + micro_march.COMPACT_STEPS
    for label, t in rec.items():
        assert t["wall_ms"] > 0 and t["device_ms"] is None, label
