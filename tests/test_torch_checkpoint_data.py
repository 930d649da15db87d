"""Port parity: slim checkpoints in both directions (both geometries, and
a full-size L16F2 checkpoint from JAX re-rendered through the eval entry
point), the synthetic dataset, its ground-truth renderer, ray generation
and the PSNR/SSIM metrics; plus 16x16 runs of the port's eval and train
entry points on the CPU with the --n_features flag."""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.datasets.synthetic import render_gt as jax_render_gt
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.occupancy import init_grid_state as jax_grid_state
from ngp_pl_tpu.training import checkpoint as jckpt
from ngp_pl_tpu.training.metrics import psnr as jax_psnr
from ngp_pl_tpu.training.metrics import ssim as jax_ssim
from ngp_pl_torch import eval as teval
from ngp_pl_torch import train as ttrain
from ngp_pl_torch.config import (
    NGPConfig,
    TrainConfig,
    add_eval_args,
    add_train_args,
    config_from_args,
)
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.datasets.synthetic import SyntheticDataset, render_gt
from ngp_pl_torch.eval import evaluate
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.training import checkpoint as tckpt
from ngp_pl_torch.training.metrics import psnr, ssim

torch.set_num_threads(2)

MODEL_KW = dict(scale=0.5, n_levels=4, n_features_per_level=4,
                log2_hashmap_size=12, grid_size=32)


def _kw(F=4):
    return {**MODEL_KW, "n_features_per_level": F}


def _jax_params(F=4):
    params = JaxNGP(JaxNGPConfig(**_kw(F))).init(jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("F", [4, 2])
def test_slim_checkpoint_from_jax(tmp_path, F):
    params = _jax_params(F)
    occ = (np.random.default_rng(0).random((1, 32, 32, 32)) < 0.5).astype(
        np.uint8)
    state = jax_grid_state(JaxNGPConfig(**_kw(F)))._replace(
        occ_grid=jnp.asarray(occ))
    path = os.path.join(tmp_path, "jax_slim.npz")
    jckpt.save_slim_checkpoint(path, params=params, grid_state=state)
    got, got_occ = tckpt.load_slim_checkpoint(path)
    np.testing.assert_array_equal(got_occ, occ)
    ngp = NGP(NGPConfig(**_kw(F)), device="cpu")
    ngp.load_params(got)
    back = ngp.params_numpy()
    np.testing.assert_array_equal(back["hash_table"], params["hash_table"])
    for name in ("sigma_mlp", "rgb_mlp"):
        assert len(back[name]) == len(params[name])
        for a, b in zip(back[name], params[name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("F", [4, 2])
def test_slim_checkpoint_to_jax(tmp_path, F):
    ngp = NGP(NGPConfig(**_kw(F)), seed=5, device="cpu")
    occ = torch.zeros((1, 32, 32, 32), dtype=torch.uint8)
    occ[0, 3:9, 2:30, 7] = 1
    path = os.path.join(tmp_path, "torch_slim.npz")
    tckpt.save_slim_checkpoint(path, params=ngp.params_numpy(), occ_grid=occ)
    with np.load(path) as f:
        assert {"params['hash_table']", "params['sigma_mlp'][0]",
                "params['rgb_mlp'][2]", "occ_grid"} <= set(f.files)
    params, grid = jckpt.load_slim_checkpoint(path, params=_jax_params(F))
    np.testing.assert_array_equal(grid, occ.numpy())
    mine = ngp.params_numpy()
    np.testing.assert_array_equal(np.asarray(params["hash_table"]),
                                  mine["hash_table"])
    np.testing.assert_array_equal(np.asarray(params["rgb_mlp"][1]),
                                  mine["rgb_mlp"][1])


def test_l16f2_slim_checkpoint_from_jax_rerenders_identically(tmp_path):
    """A JAX slim checkpoint of the reference L16F2 model at full size
    (hash_table (220851, 64)) loads through the eval entry point; the
    port's own slim checkpoint of it re-renders the view identically."""
    jcfg = JaxNGPConfig(n_levels=16, n_features_per_level=2)
    params = jax.tree_util.tree_map(
        np.asarray, JaxNGP(jcfg).init(jax.random.PRNGKey(4)))
    params["hash_table"] = params["hash_table"] * 1e3
    assert params["hash_table"].shape == (220851, 64)
    occ = (np.random.default_rng(1).random((1, 128, 128, 128)) < 0.05
           ).astype(np.uint8)
    state = jax_grid_state(jcfg)._replace(occ_grid=jnp.asarray(occ))
    path = os.path.join(tmp_path, "jax_l16f2_slim.npz")
    jckpt.save_slim_checkpoint(path, params=params, grid_state=state)
    tcfg = TrainConfig(downsample=0.125, n_levels=16, n_features=2,
                       weight_path=path)
    res = evaluate(tcfg, device="cpu", max_images=1)
    np.testing.assert_array_equal(res.ngp.params_numpy()["hash_table"],
                                  params["hash_table"])
    np.testing.assert_array_equal(res.occ_grid.numpy(), occ)
    assert res.samples_per_ray > 1
    again = os.path.join(tmp_path, "torch_l16f2_slim.npz")
    tckpt.save_slim_checkpoint(again, params=res.ngp.params_numpy(),
                               occ_grid=res.occ_grid)
    res2 = evaluate(tcfg.replace(weight_path=again), device="cpu",
                    max_images=1)
    assert torch.equal(res.images[0], res2.images[0])


def test_load_params_names_n_features_on_a_shape_mismatch():
    """An F=4 table given to an F=2 model: the message names the flag."""
    ngp = NGP(NGPConfig(**_kw(2)), device="cpu")
    with pytest.raises(ValueError, match="--n_features"):
        ngp.load_params(_jax_params(4))


def test_flatten_keys_match_jax():
    params = _jax_params()
    assert set(tckpt.flatten_params(params)) == set(jckpt._flatten(
        params, "params"))
    nested = tckpt.unflatten_params(tckpt.flatten_params(params))
    assert len(nested["sigma_mlp"]) == 2 and len(nested["rgb_mlp"]) == 3


def test_params_from_numpy():
    params = _jax_params()
    t = tckpt.params_from_numpy(params)
    assert isinstance(t["rgb_mlp"][2], torch.Tensor)
    np.testing.assert_array_equal(t["sigma_mlp"][1].numpy(),
                                  params["sigma_mlp"][1])


def test_synthetic_dataset_matches():
    for split in ("train", "test"):
        j = JaxSynthetic(split=split, downsample=0.125, read_meta=False)
        t = SyntheticDataset(split=split, downsample=0.125, device="cpu")
        np.testing.assert_array_equal(t.K, j.K)
        np.testing.assert_array_equal(t.poses, j.poses)
        np.testing.assert_array_equal(t.directions, j.directions)
        assert t.img_wh == j.img_wh


def test_ground_truth_matches():
    """The torch port of the analytic renderer within 1e-4 of JAX's."""
    j = JaxSynthetic(split="test", downsample=0.125, read_meta=True)
    t = SyntheticDataset(split="test", downsample=0.125, device="cpu")
    for idx in (0, 2):
        np.testing.assert_allclose(t.image(idx).numpy(), j.rays[idx],
                                   rtol=0, atol=1e-4)
    rng = np.random.default_rng(0)
    ro = np.tile([[0.0, -1.5, 0.2]], (64, 1)).astype(np.float32)
    rd = (rng.normal(size=(64, 3)) * 0.2 + [0, 1, 0]).astype(np.float32)
    gj = jax_render_gt(ro, rd)
    gt = render_gt(torch.from_numpy(ro), torch.from_numpy(rd))
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4)


def test_get_rays():
    t = SyntheticDataset(split="test", downsample=0.125, device="cpu")
    pose = torch.from_numpy(t.poses[1])
    ro, rd = get_rays(torch.from_numpy(t.directions), pose)
    np.testing.assert_allclose(rd.numpy(), t.directions @ t.poses[1][:, :3].T,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ro.numpy()[5], t.poses[1][:, 3])


def test_metrics_match():
    rng = np.random.default_rng(4)
    a = rng.random((24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(psnr(ta, tb)) - float(jax_psnr(a, b))) < 1e-4
    assert abs(float(ssim(ta, tb)) - float(jax_ssim(jnp.asarray(a),
                                                    jnp.asarray(b)))) < 1e-5


@pytest.mark.parametrize("F", [4, 2])
def test_eval_entry_point_on_cpu(F):
    """A 16x16 run of the whole slice with the plain versions: grid build
    from the train cameras + warmup refresh, one test view, metrics."""
    tcfg = TrainConfig(downsample=0.125, n_levels=4, n_features=F,
                       log2_hashmap_size=12)
    res = evaluate(tcfg, device="cpu", max_images=1)
    assert res.ngp.hash_table.shape[1] == 32 * F
    assert res.images[0].shape == (16, 16, 3)
    assert torch.isfinite(res.images[0]).all()
    op = res.opacities[0]
    assert float(op.min()) >= 0.0 and float(op.max()) <= 1.0 + 1e-6
    assert np.isfinite(res.psnr) and 0.0 < res.ssim <= 1.0
    assert res.samples_per_ray > 0 and res.rounds_per_frame >= 1
    assert res.fps > 0


@pytest.mark.parametrize("add_args", [add_eval_args, add_train_args])
def test_n_features_flag_parses_as_jax(add_args):
    """--n_features, named and defaulted as the JAX package's flag
    (ngp_pl_tpu/config.py:122, 199-201), takes 2 or 4 and reaches the
    model configuration."""
    parser = argparse.ArgumentParser()
    add_args(parser)
    assert (config_from_args(parser.parse_args([])).n_features
            == JaxTrainConfig().n_features == 4)
    tcfg = config_from_args(parser.parse_args(["--n_levels", "16",
                                               "--n_features", "2"]))
    cfg = tcfg.ngp_config()
    assert (cfg.n_levels, cfg.n_features_per_level) == (16, 2)
    with pytest.raises(SystemExit):
        parser.parse_args(["--n_features", "3"])


@pytest.mark.parametrize("entry", ["eval", "train"])
def test_entry_points_take_n_features_on_cpu(entry, tmp_path, monkeypatch):
    """Both entry points run an L=4, F=2 model on the CPU from the command
    line (16x16 views; the trainer 16 steps at 256 rays)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--n_levels", "4", "--n_features", "2",
            "--log2_hashmap_size", "12", "--max_images", "1"]
    if entry == "eval":
        res = teval.main(argv + ["--downsample", "0.125"])
        ngp = res.ngp
    else:
        system, scores = ttrain.main(argv + [
            "--downsample", "0.1875", "--batch_size", "256",
            "--num_epochs", "1", "--iters_per_epoch", "16"])
        ngp = system.ngp
        assert system.optimizer.count == 16 and np.isfinite(scores["psnr"])
        with np.load(tmp_path / "ckpts" / "synthetic" / "exp"
                     / "epoch=1_slim.npz") as f:
            assert f["params['hash_table']"].shape == (ngp.spec.total_rows,
                                                       64)
    assert ngp.spec.n_features == 2 and ngp.hash_table.shape[1] == 64
