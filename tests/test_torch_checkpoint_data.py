"""Port parity: slim checkpoints in both directions, the synthetic dataset,
its ground-truth renderer, ray generation and the PSNR/SSIM metrics; plus a
16x16 run of the port's eval entry point on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.datasets.synthetic import render_gt as jax_render_gt
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.occupancy import init_grid_state as jax_grid_state
from ngp_pl_tpu.training import checkpoint as jckpt
from ngp_pl_tpu.training.metrics import psnr as jax_psnr
from ngp_pl_tpu.training.metrics import ssim as jax_ssim
from ngp_pl_torch.config import NGPConfig, TrainConfig
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.datasets.synthetic import SyntheticDataset, render_gt
from ngp_pl_torch.eval import evaluate
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.training import checkpoint as tckpt
from ngp_pl_torch.training.metrics import psnr, ssim

torch.set_num_threads(2)

MODEL_KW = dict(scale=0.5, n_levels=4, n_features_per_level=4,
                log2_hashmap_size=12, grid_size=32)


def _jax_params():
    params = JaxNGP(JaxNGPConfig(**MODEL_KW)).init(jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, params)


def test_slim_checkpoint_from_jax(tmp_path):
    params = _jax_params()
    occ = (np.random.default_rng(0).random((1, 32, 32, 32)) < 0.5).astype(
        np.uint8)
    state = jax_grid_state(JaxNGPConfig(**MODEL_KW))._replace(
        occ_grid=jnp.asarray(occ))
    path = os.path.join(tmp_path, "jax_slim.npz")
    jckpt.save_slim_checkpoint(path, params=params, grid_state=state)
    got, got_occ = tckpt.load_slim_checkpoint(path)
    np.testing.assert_array_equal(got_occ, occ)
    ngp = NGP(NGPConfig(**MODEL_KW), device="cpu")
    ngp.load_params(got)
    back = ngp.params_numpy()
    np.testing.assert_array_equal(back["hash_table"], params["hash_table"])
    for name in ("sigma_mlp", "rgb_mlp"):
        assert len(back[name]) == len(params[name])
        for a, b in zip(back[name], params[name]):
            np.testing.assert_array_equal(a, b)


def test_slim_checkpoint_to_jax(tmp_path):
    ngp = NGP(NGPConfig(**MODEL_KW), seed=5, device="cpu")
    occ = torch.zeros((1, 32, 32, 32), dtype=torch.uint8)
    occ[0, 3:9, 2:30, 7] = 1
    path = os.path.join(tmp_path, "torch_slim.npz")
    tckpt.save_slim_checkpoint(path, params=ngp.params_numpy(), occ_grid=occ)
    with np.load(path) as f:
        assert {"params['hash_table']", "params['sigma_mlp'][0]",
                "params['rgb_mlp'][2]", "occ_grid"} <= set(f.files)
    params, grid = jckpt.load_slim_checkpoint(path, params=_jax_params())
    np.testing.assert_array_equal(grid, occ.numpy())
    mine = ngp.params_numpy()
    np.testing.assert_array_equal(np.asarray(params["hash_table"]),
                                  mine["hash_table"])
    np.testing.assert_array_equal(np.asarray(params["rgb_mlp"][1]),
                                  mine["rgb_mlp"][1])


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


def test_eval_entry_point_on_cpu():
    """A 16x16 run of the whole slice with the plain versions: grid build
    from the train cameras + warmup refresh, one test view, metrics."""
    tcfg = TrainConfig(downsample=0.125, n_levels=4, log2_hashmap_size=12)
    res = evaluate(tcfg, device="cpu", max_images=1)
    assert res.images[0].shape == (16, 16, 3)
    assert torch.isfinite(res.images[0]).all()
    op = res.opacities[0]
    assert float(op.min()) >= 0.0 and float(op.max()) <= 1.0 + 1e-6
    assert np.isfinite(res.psnr) and 0.0 < res.ssim <= 1.0
    assert res.samples_per_ray > 0 and res.rounds_per_frame >= 1
    assert res.fps > 0
