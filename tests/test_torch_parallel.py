"""Data parallelism of the port on the CPU: two gloo ranks against one rank
and against the JAX package's step sharded over its 8 virtual devices
(tests/test_parallel.py:41-63).

The ranks run the bodies of tests/torch_ddp_workers.py (spawned processes
import only torch and the port), once for the whole file, meeting through
a file store under the test's temporary directory.  What holds:
- the batch shard and its divisibility error;
- one CSR step whose pool does not fill: each rank's pool is the one-rank
  pool's slice bit for bit, the loss within 1e-6, every gradient within
  1e-5 of its max, the demand vector the one-rank one, the parameters
  after the step equal across the ranks; against JAX's mesh step, the
  one-step test's limits;
- a CSR step whose pool fills: each rank truncates its own shard's pool
  (the JAX mesh step truncates the global pool; ROADMAP §4), pinned by the
  count of slots that differ;
- the strided layout, whose rows are per ray: exact;
- two blocks of a fit: the controller's layout, budget and chain equal
  the one-rank fit's after each, grids and parameters equal across ranks;
- validate over two ranks against one;
- the train CLI with `--device cpu --num_devices 2`, `--multihost` from
  the environment, and a count above the visible GPUs.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.parallel.mesh import data_mesh, replicated, shard_batch
from ngp_pl_tpu.training.train_step import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from ngp_pl_torch import parallel
from ngp_pl_torch.models.rendering import render_rays_train_csr
from ngp_pl_torch.parallel import dist as pdist
from tests import torch_ddp_workers as W

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = 7
# slots of the full pool's 2,048 where the two ranks' pools (1,024 each)
# differ from the one-rank pool (per-rank truncation, ROADMAP §4)
FULL_POOL_DIFF = 1093


def _jax_noise():
    """The march noise of JAX's step at step COUNT under key KEY
    (train_step.py:275, 120-121)."""
    k = jax.random.fold_in(jax.random.PRNGKey(KEY), W.COUNT)
    return np.array(jax.random.uniform(jax.random.split(k)[0], (W.N_RAYS,)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, noise, one-rank results by case, the two ranks' results)."""
    out = str(tmp_path_factory.mktemp("ddp"))
    noise = _jax_noise()
    inp = W.step_inputs(noise)
    parallel.launch(W.suite, 2, (out, inp, noise), device="cpu",
                    store_dir=out)
    ranks = [torch.load(os.path.join(out, f"suite_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    one = {case: W.one_step(inp, noise, case) for case in W.CASES}
    return inp, noise, one, ranks


def _pool(res):
    n = int(res["pool_valid"].sum())
    return res["ts"][:n], res["deltas"][:n], res["ray_idx"][:n], n


def test_shard_and_its_divisibility(monkeypatch):
    t = torch.arange(24).reshape(12, 2)
    assert parallel.shard(t) is t                    # no process group
    monkeypatch.setattr(pdist, "world_size", lambda: 4)
    monkeypatch.setattr(pdist, "rank", lambda: 2)
    assert torch.equal(pdist.shard(t), t[6:9])
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        pdist.shard(t[:10])


def test_two_rank_step_matches_one_rank(runs):
    _, _, one, ranks = runs
    ref, (r0, r1) = one["csr"], (x["csr"] for x in ranks)
    ts, dl, ri, n = _pool(ref)
    at, half = 0, W.N_RAYS // 2
    for r, res in enumerate((r0, r1)):
        ts_r, dl_r, ri_r, n_r = _pool(res)
        np.testing.assert_array_equal(ts_r, ts[at:at + n_r])
        np.testing.assert_array_equal(dl_r, dl[at:at + n_r])
        np.testing.assert_array_equal(ri_r + r * half, ri[at:at + n_r])
        np.testing.assert_array_equal(
            res["offsets"] + at, ref["offsets"][r * half:(r + 1) * half])
        at += n_r
    assert at == n > 0
    assert float(r0["metrics"]["loss"]) == pytest.approx(
        float(ref["metrics"]["loss"]), rel=1e-6)
    for g, g0, g1 in zip(ref["grads"], r0["grads"], r1["grads"]):
        assert np.abs(g).max() > 0
        assert np.abs(g0 - g).max() <= 1e-5 * np.abs(g).max()
        np.testing.assert_array_equal(g0, g1)
    np.testing.assert_allclose(r0["metrics"]["demand_vec"],
                               ref["metrics"]["demand_vec"], rtol=1e-6)
    for k in ("demand_vec", "loss", "psnr", "rm_samples", "vr_samples"):
        np.testing.assert_array_equal(r0["metrics"][k], r1["metrics"][k])
    for p0, p1 in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(p0, p1)


def _jax_mesh_step(inp):
    """JAX's step on the batch sharded over 8 virtual devices, from the
    same state.  On the CPU its field runs the XLA encode and tail (the
    Pallas kernels need a TPU, and interpret mode does not partition), so
    the port's ranks run the "csr_xla_tail" case, whose tail rounds as
    jitted XLA's."""
    cfg = JaxNGPConfig(**W.MODEL)
    jngp = JaxNGP(cfg, need_x_grad=False)
    tcfg = JaxTrainConfig(**W.STEP_TCFG, batch_size=W.N_RAYS,
                          n_levels=4, log2_hashmap_size=12)
    step = make_train_step(jngp, tcfg, JaxRenderConfig())
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    st = make_optimizer(tcfg).init(params)
    st = (st[0]._replace(count=jnp.asarray(W.COUNT, jnp.int32),
                         mu=jax.tree_util.tree_map(jnp.asarray, inp["mu"]),
                         nu=jax.tree_util.tree_map(jnp.asarray, inp["nu"])),
          st[1]._replace(count=jnp.asarray(W.COUNT, jnp.int32)))
    state = TrainState(params=params, pose_params={}, opt_state=st,
                       step=jnp.asarray(W.COUNT, jnp.int32))
    mesh = data_mesh(jax.devices()[:8])
    repl = replicated(mesh)
    batch = shard_batch({"img_idxs": inp["img"], "pix_idxs": inp["pix"],
                         "rgb": inp["rgb"]}, mesh)
    assert len(batch["rgb"].sharding.device_set) == 8
    occ = jnp.asarray(inp["occ"]["sparse"])
    layout, budget, chain = W.CASES["csr"]
    return step(jax.device_put(state, repl), jax.device_put(occ, repl),
                jax.device_put(jnp.asarray(inp["poses"]), repl),
                jax.device_put(jnp.asarray(inp["dirs"]), repl), batch,
                jax.random.PRNGKey(KEY), n_samples=budget,
                chain_length=chain,
                win_rows=jax.device_put(jrm.occupancy_windows(occ), repl),
                layout=layout)


def _leaves(tree):
    return [np.asarray(tree["hash_table"])] + [
        np.asarray(w) for name in ("sigma_mlp", "rgb_mlp") for w in tree[name]]


def test_two_rank_step_matches_jax_mesh_step(runs):
    """Loss within 1e-5, every gradient within 2e-3 of its max, the
    parameters within 1e-3 * lr and the moments within 1e-3 of their max
    (the one-step test's limits); the gradients are read off the moments,
    (mu_new - b1 mu) / (1 - b1), on both sides."""
    inp, _, _, ranks = runs
    new, m = _jax_mesh_step(inp)
    res = ranks[0]["csr_xla_tail"]
    assert float(res["metrics"]["loss"]) == pytest.approx(float(m["loss"]),
                                                          rel=1e-5)
    lr = W.cosine_epoch_schedule(1e-2, 2, 4, 30.0)(W.COUNT)
    mu0 = _leaves(inp["mu"])
    for a, b, m0 in zip(res["mu_new"], _leaves(new.opt_state[0].mu), mu0):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
        ga, gb = (a - 0.9 * m0) / 0.1, (b - 0.9 * m0) / 0.1
        assert np.abs(ga - gb).max() <= 2e-3 * np.abs(gb).max()
    for a, b in zip(res["params"], _leaves(new.params)):
        assert np.abs(a - b).max() <= 1e-3 * lr


def test_full_pool_truncates_per_rank(runs):
    """Each rank's pool is its own shard's march into a pool of B/2 x 8
    slots, which fills: the two ranks' pools differ from the one-rank
    pool's in FULL_POOL_DIFF slots, though the march found the same samples
    on every ray."""
    inp, noise, one, ranks = runs
    ref = one["csr_full"]
    layout, budget, chain = W.CASES["csr_full"]
    half = W.N_RAYS // 2
    ro, rd = W.get_rays(torch.from_numpy(inp["dirs"])[inp["pix"]],
                        torch.from_numpy(inp["poses"])[inp["img"]])
    win = W.occupancy_windows(torch.from_numpy(inp["occ"]["dense"]))
    cat_ts, cat_ri = [], []
    for r in range(2):
        res = ranks[r]["csr_full"]
        rows = slice(r * half, (r + 1) * half)
        ngp = W.NGP(W.NGPConfig(**W.MODEL), device="cpu")
        ngp.load_params(inp["params"])
        with torch.no_grad():
            own = render_rays_train_csr(
                ngp, win, ro[rows].contiguous(), rd[rows].contiguous(),
                torch.from_numpy(noise[rows]), torch.ones(3),
                rcfg=W.RenderConfig(), pool_mult=budget,
                chain_length=chain)
        for k in ("ts", "ray_idx", "offsets", "rm_counts"):
            np.testing.assert_array_equal(res[k], own[k].numpy())
        assert int(res["pool_valid"].sum()) == half * budget
        cat_ts.append(res["ts"])
        cat_ri.append(np.where(res["pool_valid"], res["ray_idx"] + r * half,
                               -1))
    np.testing.assert_array_equal(
        np.concatenate([ranks[r]["csr_full"]["rm_counts"] for r in range(2)]),
        ref["rm_counts"])
    assert int(ref["pool_valid"].sum()) == W.N_RAYS * budget
    diff = ((np.concatenate(cat_ts) != ref["ts"])
            | (np.concatenate(cat_ri) != ref["ray_idx"]))
    assert int(diff.sum()) == FULL_POOL_DIFF


def test_strided_two_ranks_exact(runs):
    _, _, one, ranks = runs
    ref = one["strided"]
    for k in ("ts", "deltas", "valid", "rm_counts", "loss_mask"):
        np.testing.assert_array_equal(
            np.concatenate([x["strided"][k] for x in ranks]), ref[k])
    for g, g0 in zip(ref["grads"], ranks[0]["strided"]["grads"]):
        assert np.abs(g0 - g).max() <= 1e-5 * np.abs(g).max()
    assert float(ranks[0]["strided"]["metrics"]["loss"]) == pytest.approx(
        float(ref["metrics"]["loss"]), rel=1e-6)


def test_two_rank_fit_blocks(runs):
    _, _, _, ranks = runs
    one = W.fit_blocks()
    b0, b1 = ranks[0]["fit"]["blocks"], ranks[1]["fit"]["blocks"]
    assert len(b0) == len(one["blocks"]) == 2
    for x, y, z in zip(b0, b1, one["blocks"]):
        assert (x["layout"], x["pool_mult"], x["chain"]) == (
            y["layout"], y["pool_mult"], y["chain"]) == (
            z["layout"], z["pool_mult"], z["chain"])
        for k in ("occ", "density", "demand", "loss"):
            np.testing.assert_array_equal(x[k], y[k])
        for p, q in zip(x["params"], y["params"]):
            np.testing.assert_array_equal(p, q)
    assert b0[1]["pool_mult"] != b0[0]["pool_mult"]    # the controller moved


def test_validate_two_ranks(runs):
    _, _, _, ranks = runs
    want = W.refreshed_validate()
    assert set(want) == {"psnr", "ssim"}
    for x in ranks:
        got = x["validate"]
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6)


TOY = ["--device", "cpu", "--n_levels", "2", "--log2_hashmap_size", "10",
       "--batch_size", "128", "--downsample", "0.1", "--num_epochs", "1",
       "--iters_per_epoch", "16", "--max_images", "2"]


def _cli(args, cwd, env=None, timeout=240):
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "ngp_pl_torch.train",
                             *args], cwd=cwd, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_train_cli_two_ranks_on_cpu(tmp_path):
    proc = _cli(TOY + ["--num_devices", "2"], tmp_path)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    assert sum(ln.startswith("test: ") for ln in out.splitlines()) == 1, out
    assert sorted(os.listdir(tmp_path / "ckpts" / "synthetic" / "exp")) == [
        "epoch=1.npz", "epoch=1_slim.npz"]
    assert len(os.listdir(tmp_path / "logs" / "synthetic" / "exp")) == 1


def test_multihost_from_the_environment(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(_cli(TOY + ["--multihost", "--val_only"], tmp_path,
                          env))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert [sum(ln.startswith("test: ") for ln in out.splitlines())
            for out, _ in outs] == [1, 0]
    # each rank dumped its own views: 0 by rank 0, 1 by rank 1
    assert sorted(os.listdir(tmp_path / "results" / "synthetic" / "exp")) == [
        "000.png", "000_d.png", "001.png", "001_d.png"]


def test_multihost_needs_its_environment(monkeypatch):
    for k in pdist.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--multihost needs"):
        parallel.init_from_env("cpu")


def test_num_devices_above_the_visible_gpus_raises(monkeypatch):
    from ngp_pl_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.resolve_world(0, "cuda") == 2
    assert parallel.resolve_world(1, "cuda") == 1
    with pytest.raises(ValueError, match="num_devices=3, but 2 GPU"):
        main(["--num_devices", "3"])
    assert parallel.resolve_world(0, "cpu") == 1
    assert parallel.resolve_world(3, "cpu") == 3
    # a system asked for ranks outside a process group does not fall back
    with pytest.raises(RuntimeError, match="needs a process group"):
        W.small_system(num_devices=2)


def test_weak_scaling_harness_on_cpu(tmp_path, monkeypatch):
    """`ngp_pl_torch.benchmarking.scaling` with gloo ranks on the small
    model: every run's record, the efficiency against the one-rank run,
    the split run against it, ranks equal, and the parity step at a pool
    with room within the two-rank step's limits."""
    from ngp_pl_torch.benchmarking import scaling

    for k, v in (("WARM_STEPS", 16), ("SPLIT_RAYS", 256),
                 ("PARITY_STEPS", 32), ("PARITY_RAYS", 256)):
        monkeypatch.setattr(scaling, k, v)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # a thread a rank
    out = scaling.main(["--device", "cpu", "--ranks", "1", "2",
                        "--per_rank", "128", "--steps", "16",
                        "--out", str(tmp_path)],
                       tcfg=W.SmallTrainConfig(**W.FIT))
    runs = {r["name"]: r for r in out["runs"]}
    assert sorted(runs) == ["parity_2", "split_2", "weak_1", "weak_2"]
    assert runs["weak_1"]["efficiency"] == 1.0
    assert runs["weak_2"]["batch"] == 256 and runs["split_2"]["batch"] == 256
    assert runs["split_2"]["vs_one_rank"] == (runs["split_2"]["rays_per_s"]
                                              / runs["weak_1"]["rays_per_s"])
    for r in runs.values():
        assert r["ranks_equal"] and r["skipped"] == 0
        assert r["allreduce_ms"] > 0 and r["rays_per_s"] > 0
        assert 0 <= r["full_pool_steps"] <= r["csr_steps"]
    par = runs["parity_2"]["parity"]
    assert par["rays"] == 256 and par["room"]["pool_mult"] == 128
    assert par["room"]["samples"] <= par["room"]["slots"]
    # a trained state: ~90 samples a ray, thousands of terms in a coarse
    # level's row, summed in two partials here and in one there
    assert par["room"]["loss_rel_err"] <= 1e-6
    assert par["room"]["grad_rel_err_max"] <= 1e-4


def test_weak_scaling_needs_the_one_rank_base(tmp_path):
    from ngp_pl_torch.benchmarking import scaling

    with pytest.raises(ValueError, match="one-rank run; add 1"):
        scaling.main(["--device", "cpu", "--ranks", "2", "4",
                      "--out", str(tmp_path)])
