"""The port's entry points on the CPU at toy size, against the JAX
package where it has a counterpart: the validation dumps (`depth2img`
against JAX's, `write_png` decoded by imageio, JAX's file names),
`--no_save_test`, `--eval_lpips`, the train CLI's full checkpoint with
`--ckpt_path ... --val_only`, `freeze_buckets`, the new flags, and the
`bench` and `full_run` entry points (one JSON line; a resumed run).

Sizes: grid 32, L=4, log2 T=12, 24x24 views, 256 rays; inputs from numpy
seeds."""
import argparse
import dataclasses
import json
import os
import re

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.config import add_train_args as jax_add_train_args
from ngp_pl_tpu.training.system import depth2img as jax_depth2img
from ngp_pl_torch import train as ttrain
from ngp_pl_torch.benchmarking import (
    bench,
    bench_mc,
    full_run,
    full_run_probe,
)
from ngp_pl_torch.config import TrainConfig, add_train_args, config_from_args
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.rendering import RoundRenderer
from ngp_pl_torch.training.system import NeRFSystem
from ngp_pl_torch.utils.images import depth2img, write_png
from tests.test_torch_train import _jax_csr_system

torch.set_num_threads(2)

TOY = ["--device", "cpu", "--n_levels", "4", "--log2_hashmap_size", "12",
       "--batch_size", "256", "--downsample", "0.1875", "--num_epochs", "1",
       "--iters_per_epoch", "16", "--max_images", "1"]


@dataclasses.dataclass(frozen=True)
class SmallTrainConfig(TrainConfig):
    """The CPU tests' model: grid 32, L=4, T=2^12."""

    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=32)


def _small_system(tcfg=None, n_test=2, **kw):
    tcfg = tcfg or SmallTrainConfig(**{"batch_size": 256, "num_epochs": 2,
                                       "iters_per_epoch": 16, **kw})
    return NeRFSystem(
        SmallTrainConfig(**{f.name: getattr(tcfg, f.name)
                            for f in dataclasses.fields(TrainConfig)}),
        device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=24, n_train=2,
                                       device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=24,
                                      n_test=n_test, device="cpu"))


@pytest.mark.parametrize("kind", ["random", "constant", "ramp"])
def test_depth2img_matches_jax(kind):
    """Bit-equal to the JAX package's matplotlib turbo map on random,
    constant and ramp depths (f32 and f64)."""
    rng = np.random.default_rng(0)
    depth = {"random": rng.random((17, 23)).astype(np.float32) * 3.0 + 0.5,
             "constant": np.full((9, 11), 2.0, np.float32),
             "ramp": np.linspace(0.0, 4.0, 40 * 64).reshape(40, 64)}[kind]
    got = depth2img(depth)
    assert got.dtype == np.uint8 and got.shape == depth.shape + (3,)
    np.testing.assert_array_equal(got, jax_depth2img(depth))


@pytest.mark.parametrize("shape", [(1, 1, 3), (24, 37, 3)])
def test_write_png_decodes(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = os.path.join(tmp_path, "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, img.astype(np.float32))


def test_validate_writes_the_jax_file_names(tmp_path, monkeypatch):
    """results/<dataset>/<exp>/NNN.png and NNN_d.png per view: the RGB dump
    is (clip(pred, 0, 1) * 255) as uint8 and the depth dump depth2img of
    the rendered depth, for the same renders that are scored."""
    monkeypatch.chdir(tmp_path)
    system = _small_system(exp_name="dumps")
    system.on_train_start()
    system._refresh_grid(0)
    renders = []
    render = RoundRenderer.render_pose
    monkeypatch.setattr(RoundRenderer, "render_pose",
                        lambda *a: renders.append(render(*a)) or renders[-1])
    scores = system.validate(save_images=True)
    val_dir = tmp_path / "results" / "synthetic" / "dumps"
    assert sorted(os.listdir(val_dir)) == ["000.png", "000_d.png",
                                           "001.png", "001_d.png"]
    assert len(renders) == 2 and np.isfinite(scores["psnr"])
    for idx, out in enumerate(renders):
        rgb = out["rgb"].reshape(24, 24, 3).numpy()
        np.testing.assert_array_equal(
            imageio.imread(val_dir / f"{idx:03d}.png"),
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        np.testing.assert_array_equal(
            imageio.imread(val_dir / f"{idx:03d}_d.png"),
            depth2img(out["depth"].reshape(24, 24).numpy()))


def test_no_save_test_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    system = _small_system(no_save_test=True)
    scores = system.validate(max_images=1)
    assert np.isfinite(scores["ssim"])
    assert not (tmp_path / "results").exists()


def test_eval_lpips_raises_before_rendering(tmp_path, monkeypatch):
    """No LPIPS weights in the port: refused before any render, and the
    message sends no one to fetch anything."""
    monkeypatch.chdir(tmp_path)
    system = _small_system(eval_lpips=True)
    monkeypatch.setattr(RoundRenderer, "render_pose",
                        lambda *a: pytest.fail("rendered"))
    with pytest.raises(RuntimeError, match="--eval_lpips") as err:
        system.validate()
    words = set(re.findall(r"[a-z]+", str(err.value).lower()))
    assert not words & {"pip", "download", "install", "http", "https"}
    assert not (tmp_path / "results").exists()


def test_train_cli_full_checkpoint_then_val_only(tmp_path, monkeypatch):
    """The train CLI writes epoch=1.npz (full) and epoch=1_slim.npz and the
    test view's dumps; `--ckpt_path epoch=1.npz --val_only` loads it
    without training and scores and dumps the view as the run did."""
    monkeypatch.chdir(tmp_path)
    system, scores = ttrain.main(TOY)
    ckpt = tmp_path / "ckpts" / "synthetic" / "exp"
    assert sorted(os.listdir(ckpt)) == ["epoch=1.npz", "epoch=1_slim.npz"]
    with np.load(ckpt / "epoch=1.npz") as f:
        assert int(f["__step__"]) == 16 == int(f["opt[0].count"])
    dumps = tmp_path / "results" / "synthetic" / "exp"
    first = imageio.imread(dumps / "000.png")
    os.remove(dumps / "000.png")
    again, scores2 = ttrain.main(TOY + ["--ckpt_path", str(ckpt / "epoch=1.npz"),
                                        "--val_only"])
    assert again._host_step == again.optimizer.count == 16
    assert again.history == []                    # no step was taken
    assert scores2 == scores
    np.testing.assert_array_equal(imageio.imread(dumps / "000.png"), first)


def test_freeze_buckets_matches_jax():
    """While frozen, neither package's demand controller moves nor takes
    the demand in; unfrozen, both move alike again."""
    js = _jax_csr_system()
    ts = _small_system(batch_size=1024, train_layout="csr")
    rng = np.random.default_rng(0)

    def feed(i):
        v = np.asarray([rng.uniform(4, 70) * 1024, 900, 1100, 300, 30, 25,
                        18, 0, rng.uniform(30, 70)], np.float32)
        for s in (js, ts):
            s._host_step = 16 * (i + 20)          # past grid warmup
            s._consume_demand({"demand_vec": v})

    for s in (js, ts):
        s.freeze_buckets = True
    start = (ts._pool_mult, ts.chain_length, ts.layout)
    for i in range(6):
        feed(i)
        assert (ts._pool_mult, ts.chain_length, ts.layout) == start
        assert ts._pending_demand is None and js._pending_demand is None
    for s in (js, ts):
        s.freeze_buckets = False
    for i in range(6, 12):
        feed(i)
        assert (ts._pool_mult, ts.chain_length) == (js._pool_mult,
                                                    js.chain_length)
    assert (ts._pool_mult, ts.chain_length) != start[:2]


def test_new_flags_match_jax():
    """--eval_lpips, --val_only, --no_save_test, --ckpt_path,
    --use_exposure and --optimize_ext (with pose_lr): the JAX package's
    names and defaults; --use_exposure switches the head to "None" in both
    model configurations."""
    names = ("eval_lpips", "val_only", "no_save_test", "ckpt_path",
             "use_exposure", "optimize_ext")
    for name in names + ("pose_lr",):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name)
    for hdr in (False, True):
        assert (TrainConfig(use_exposure=hdr).ngp_config().rgb_act
                == JaxTrainConfig(use_exposure=hdr).ngp_config().rgb_act
                == ("None" if hdr else "Sigmoid"))
    argv = ["--eval_lpips", "--val_only", "--no_save_test", "--ckpt_path",
            "a.npz", "--use_exposure", "--optimize_ext"]
    mine, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_train_args(mine)
    jax_add_train_args(theirs)
    got = config_from_args(mine.parse_args(argv))
    want = theirs.parse_args(argv + ["--root_dir", ""])
    assert [getattr(got, n) for n in names] == [getattr(want, n)
                                                for n in names]
    assert got.ckpt_path == "a.npz" and got.val_only
    assert got.use_exposure and got.optimize_ext


def test_bench_prints_one_json_line(monkeypatch, capsys):
    """The bench at toy size (32 warm steps, one timed block of 16): one
    line on stdout, bench.py's JSON record; the buckets frozen."""
    for k, v in (("BENCH_BATCH", "256"), ("BENCH_WARM_STEPS", "32"),
                 ("BENCH_STEPS", "16")):
        monkeypatch.setenv(k, v)
    built = []
    monkeypatch.setattr(bench, "bench_system", lambda device, batch, scale:
                        built.append(_small_system(
                            batch_size=batch, scale=scale,
                            exp_name="bench")) or built[-1])
    rec = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "train_rays_per_s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1e6)
    assert built[0].freeze_buckets and built[0]._host_step == 64


def test_bench_runs_the_multi_cascade_scene(monkeypatch, capsys):
    """BENCH_SCALE=1.0 at toy size: bench.py's model of that scale (two
    cascades, steps growing by 1/256) trains on the two-window march and
    prints its record."""
    for k, v in (("BENCH_BATCH", "256"), ("BENCH_WARM_STEPS", "32"),
                 ("BENCH_STEPS", "16"), ("BENCH_SCALE", "1.0")):
        monkeypatch.setenv(k, v)
    built = []
    monkeypatch.setattr(bench, "bench_system", lambda device, batch, scale:
                        built.append(_small_system(
                            batch_size=batch, scale=scale,
                            exp_name="bench")) or built[-1])
    rec = bench.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    system = built[0]
    assert system.cfg.scale == 1.0 and system.cfg.cascades == 2
    assert system.cfg.exp_step_factor == 1.0 / 256
    assert system.window_march and system._pool_buckets[-1] == 160
    assert rec["value"] > 0 and system._host_step == 64
    assert system.history == [] and system.optimizer.count == 64


def test_bench_mc_prints_and_writes_its_record(tmp_path, monkeypatch,
                                               capsys):
    """bench_mc at toy size (scale 4 on the scene scaled by 8, black
    background, grid 32, L=4): 32 steps, one timed block; the JAX bench's
    record, printed last and written as bench_mc_window.json."""
    monkeypatch.setattr(bench_mc, "RECORD_DIR", str(tmp_path))
    monkeypatch.setattr(bench_mc, "TIMED_STEPS", 16)
    built = []

    def small(device, steps, scale, img_size):
        tcfg = SmallTrainConfig(dataset_name="synthetic", batch_size=256,
                                num_epochs=1, iters_per_epoch=1000,
                                scale=scale, exp_name="bench_mc",
                                no_save_test=True)
        ws = scale / 0.5
        built.append(NeRFSystem(
            tcfg, device=device,
            train_dataset=SyntheticDataset(split="train", img_size=img_size,
                                           n_train=2, world_scale=ws, bg=0.0,
                                           device=device),
            test_dataset=SyntheticDataset(split="test", img_size=img_size,
                                          n_test=1, world_scale=ws, bg=0.0,
                                          device=device)))
        return built[-1]

    monkeypatch.setattr(bench_mc, "bench_mc_system", small)
    rec = bench_mc.main(["--device", "cpu", "--steps", "32", "--img_size",
                         "16"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    with open(tmp_path / "bench_mc_window.json") as f:
        assert json.load(f) == rec
    assert rec["tag"] == "mc_window" and rec["cascades"] == 4
    assert rec["rays_per_s"] > 0 and 0 < rec["psnr"] < 100
    system = built[0]
    assert system.window_march and system.freeze_buckets
    assert system._host_step == 48
    assert float(system.train_dataset.rays.min()) == 0.0    # black


def test_full_run_resumes(tmp_path, monkeypatch, capsys):
    """With the interval lowered to 16 steps: a 32-step run leaves the
    step-16 checkpoint under ckpts/synthetic/full_run_torch_<tag>/; a
    48-step run resumes from it, trains 32 steps, logs the JAX run's
    lines and writes its record to the record directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(full_run, "RESUME_EVERY", 16)
    monkeypatch.setattr(full_run, "LOG_EVERY", 16)
    monkeypatch.setattr(full_run, "RECORD_DIR", str(tmp_path))
    monkeypatch.setattr(full_run, "make_system",
                        lambda tcfg, img_size, n_train, device:
                        _small_system(tcfg.replace(
                            batch_size=256, n_levels=4,
                            log2_hashmap_size=12)))
    argv = ["--device", "cpu", "--tag", "toy"]
    first = full_run.main(argv + ["--steps", "32"])
    ck = tmp_path / "ckpts" / "synthetic" / "full_run_torch_toy" / "resume.npz"
    with np.load(ck) as f:
        assert int(f["__step__"]) == 16
    assert first["steps_run"] == 32
    capsys.readouterr()
    rec = full_run.main(argv + ["--steps", "48"])
    out = capsys.readouterr().out
    assert f"resuming from {os.path.relpath(ck, tmp_path)} at step 16" in out
    steps = [ln.split()[1] for ln in out.splitlines()
             if ln.startswith("step ")]
    assert steps == ["32", "48"]
    for word in ("loss", "rm_s", "tbl_absmax", "S", "csr", "t"):
        assert f" {word} " in out.splitlines()[1]
    assert rec["steps_run"] == 32 and rec["n_skipped"] == 0
    assert rec["final_loss_finite"] and np.isfinite(rec["psnr"])
    with open(tmp_path / "full_run_toy.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))


@pytest.mark.parametrize("plain", [False, True])
def test_full_run_probe_reads_the_run(monkeypatch, capsys, plain):
    """The probe at toy size: one JSON line at the last step with the
    grid's readings and the test and train views' PSNR; `--plain` routes
    the wrappers to their plain versions for the run and restores them."""
    from ngp_pl_torch.ops import field_tail as ft
    from ngp_pl_torch.ops import hash_encoding as he

    wrappers = (he.hash_encode_fwd_cuda, he.hash_encode_bwd_cuda,
                ft.field_tail_cuda, ft.field_tail_bwd_cuda)
    seen = []
    monkeypatch.setattr(full_run_probe, "make_system",
                        lambda tcfg, img_size, n_train, device:
                        seen.append(he.hash_encode_fwd_cuda) or _small_system(
                            tcfg.replace(batch_size=256, n_levels=4,
                                         log2_hashmap_size=12)))
    full_run_probe.main(["--device", "cpu", "--steps", "32",
                         "--score_every", "32"] + ["--plain"] * plain)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["step"] == 32 and rec["plain"] == plain
    assert 0 < rec["occupied"] < 1 and rec["threshold"] > 0
    assert np.isfinite(rec["test_psnr"]) and np.isfinite(
        rec["train_view0_psnr"])
    assert (seen[0] is he.hash_encode_fwd_plain) == plain
    assert (he.hash_encode_fwd_cuda, he.hash_encode_bwd_cuda,
            ft.field_tail_cuda, ft.field_tail_bwd_cuda) == wrappers


def test_full_run_probe_transfer_state(tmp_path, monkeypatch, capsys):
    """`--save_at 16` writes the transfer file (table float16, its second
    moment bfloat16, its first moment left out, the packed grid rows left
    out); a run `--from_state` it loads, after the marking, the state the
    file holds: the rounded table and moment, a zero first moment, every
    other leaf and the grid as saved, the grid rows rebuilt; then it logs
    every block from step 16 on."""
    from ngp_pl_torch.training.checkpoint import train_state_numpy

    systems = []
    monkeypatch.setattr(full_run_probe, "make_system",
                        lambda tcfg, img_size, n_train, device:
                        systems.append(_small_system(tcfg.replace(
                            batch_size=256, n_levels=4,
                            log2_hashmap_size=12))) or systems[-1])
    full_run_probe.main(["--device", "cpu", "--steps", "16", "--save_at",
                         "16", "--save_dir", str(tmp_path),
                         "--score_every", "16"])
    path = tmp_path / "state_16.npz"
    with np.load(path) as f:
        assert f[full_run_probe.TABLE].dtype == np.float16
        assert f[full_run_probe.TABLE_NU].dtype == np.uint16
        assert full_run_probe.TABLE_MU not in f
        assert "grid.win_rows" not in f and int(f["__step__"]) == 16
    saved = systems[0]
    p0, mu0, nu0, count0 = train_state_numpy(saved.ngp, saved.optimizer)
    capsys.readouterr()
    full_run_probe.main(["--device", "cpu", "--steps", "32", "--from_state",
                         str(path), "--log_every", "16", "--score_every",
                         "32"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in recs] == [16, 32]
    assert "test_psnr" in recs[0] and "loss" in recs[1]
    fresh = _small_system(systems[1].tcfg)
    fresh.on_train_start()
    full_run_probe.load_state(fresh, str(path))
    p1, mu1, nu1, count1 = train_state_numpy(fresh.ngp, fresh.optimizer)
    assert count1 == count0 == 16 and fresh._host_step == 16
    np.testing.assert_array_equal(
        p1["hash_table"], p0["hash_table"].astype(np.float16).astype(
            np.float32))
    np.testing.assert_array_equal(
        nu1["hash_table"], torch.from_numpy(nu0["hash_table"]).bfloat16()
        .float().numpy())
    assert not mu1["hash_table"].any()
    for name in ("sigma_mlp", "rgb_mlp"):
        for a, b, c, d in zip(p1[name], p0[name], mu1[name], mu0[name]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, d)
    for field in ("density_grid", "count_grid", "occ_grid", "win_rows"):
        assert torch.equal(getattr(fresh.grid_state, field),
                           getattr(saved.grid_state, field)), field


def test_full_run_probe_host_draws_are_the_systems_on_the_cpu(monkeypatch,
                                                              capsys):
    """`--host_draws` draws batches, march jitter and refresh jitter from a
    CPU generator of the seed in the system's order: on the CPU, where the
    system's own generator is that generator, the run is the same."""
    monkeypatch.setattr(full_run_probe, "make_system",
                        lambda tcfg, img_size, n_train, device:
                        _small_system(tcfg.replace(
                            batch_size=256, n_levels=4,
                            log2_hashmap_size=12)))
    logs = []
    for extra in ([], ["--host_draws"]):
        full_run_probe.main(["--device", "cpu", "--steps", "32",
                             "--log_every", "16", "--score_every", "32"]
                            + extra)
        recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        logs.append([{k: v for k, v in r.items() if k != "t"} for r in recs])
    assert [r["step"] for r in logs[0]] == [16, 32]
    assert logs[1] == logs[0]


def test_full_run_geometries():
    """The JAX script's three fields; the ceiling's L16F4, T=2^20 table is
    one the port's encode takes (at most 16 levels, F=4)."""
    got = {}
    for geometry, ceiling in (("L8F4", False), ("L16F2", False),
                              ("L8F4", True)):
        tcfg, name, geo = full_run.run_config(30000, geometry, ceiling)
        assert (tcfg.batch_size, tcfg.num_epochs, tcfg.iters_per_epoch) == (
            8192, 30, 1000)
        got[name] = geo
    assert got == {"L8F4": "L8F4T19", "L16F2": "L16F2T19",
                   "ceiling": "L16F4T20"}
    from ngp_pl_torch.models.ngp import NGP

    tcfg, _, _ = full_run.run_config(32, "L8F4", True)
    ngp = NGP(tcfg.ngp_config(), device="cpu")
    x = torch.rand(64, 3) - 0.5
    assert ngp.hash_table.shape[1] == 128
    assert torch.isfinite(ngp.density(x)).all()


@pytest.mark.parametrize("entry", ["bench", "full_run"])
def test_benchmarks_need_cuda_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench": bench.main, "full_run": full_run.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
