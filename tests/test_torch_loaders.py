"""The port's disk loaders against the JAX package's on fixture scenes of
every format and variant (Blender and Jrender; NSVF Synthetic,
BlendedMVS with the Jade lift, Tanks, Ignatius, test_traj; NeRF++ with
camera_path; RTMV with and without the `bricks` box; COLMAP binary with a
SIMPLE_PINHOLE and a PINHOLE camera, mip-NeRF 360's images_N folders and
test_traj; HDR-NeRF syndata and real captures): the same files read by
both give bit-equal poses, K, img_wh, directions, rays, exposures and
points (rays within 1e-6 where an image is resized: the JAX package's cv2
takes Intel IPP's resize, up to two float32 ulps from OpenCV's own code,
which the port follows; tests/test_torch_images_read.py), and the same
march-window rule on each split's directions.

Then the training system on a Blender scene written from the procedural
scene: with `device_dataset=False` its host batches are the JAX system's,
bit for bit, for 8 steps; one step on such a batch matches JAX's within
the one-step test's limits; `validate` on a pose-only split renders and
dumps without a score; the train and eval entry points read a disk scene.

Sizes: images of 6x8 to 24x16 pixels, 3-54 views; the system's model at
grid 32, L=4, log2 T=12, 256 rays."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets import dataset_dict as jax_datasets
from ngp_pl_tpu.datasets.ray_utils import get_rays as jax_get_rays
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch import eval as teval
from ngp_pl_torch import train as ttrain
from ngp_pl_torch.benchmarking.disk_scene import write_blender_scene
from ngp_pl_torch.config import RenderConfig, TrainConfig
from ngp_pl_torch.datasets import dataset_dict
from ngp_pl_torch.datasets.ray_utils import get_rays
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.system import NeRFSystem
from tests import disk_scenes
from tests.test_torch_train import (
    N_RAYS,
    SmallTrainConfig,
    _jax_loss_and_grads,
    _jax_model,
    _leaves,
    _port_model,
    _shell_grid,
)

torch.set_num_threads(2)

# (format, fixture writer and its arguments, downsample, splits, resized)
CASES = {
    "blender": ("nerf", lambda p: disk_scenes.blender(p), 0.02,
                ("train", "trainval", "test"), False),
    "blender_resized": ("nerf", lambda p: disk_scenes.blender(p, h=20, w=20),
                        0.02, ("train", "test"), True),
    "blender_rgb": ("nerf", lambda p: disk_scenes.blender(p, channels=3),
                    0.02, ("train",), False),
    "jrender": ("nerf", lambda p: disk_scenes.blender(p, jrender="Coffee"),
                0.02, ("train", "test"), False),
    "nsvf_synthetic": ("nsvf", lambda p: disk_scenes.nsvf(p), 0.01,
                       ("train", "val", "trainval", "trainvaltest", "test",
                        "test_traj"), False),
    "nsvf_blendedmvs": ("nsvf", lambda p: disk_scenes.nsvf(p, "BlendedMVS"),
                        0.01, ("train", "test", "test_traj"), True),
    "nsvf_tanks": ("nsvf", lambda p: disk_scenes.nsvf(p, "Tanks"), 0.01,
                   ("train", "test", "test_traj"), True),
    "nsvf_ignatius": ("nsvf", lambda p: disk_scenes.nsvf(p, "Ignatius"),
                      0.01, ("train", "test_traj"), True),
    "nerfpp": ("nerfpp", lambda p: disk_scenes.nerfpp(p), 1.0,
               ("train", "val", "trainval", "test", "test_traj"), False),
    "rtmv_bricks": ("rtmv", lambda p: disk_scenes.rtmv(p), 1.0,
                    ("test", "train", "trainval"), False),
    "rtmv": ("rtmv", lambda p: disk_scenes.rtmv(p, "barbershop"), 1.0,
             ("train",), False),
    "colmap": ("colmap", lambda p: disk_scenes.colmap(p), 1.0,
               ("train", "test", "trainval", "test_traj"), False),
    "colmap_pinhole": ("colmap", lambda p: disk_scenes.colmap(p, "pinhole"),
                       1.0, ("train", "test"), False),
    "colmap_360_v2": ("colmap", lambda p: disk_scenes.colmap(p, "360_v2"),
                      0.25, ("train", "test"), False),
    "hdr_syndata": ("colmap", lambda p: disk_scenes.hdr_nerf(p), 1.0,
                    ("train", "test"), False),
    "hdr_real": ("colmap", lambda p: disk_scenes.hdr_nerf(p, "real"), 1.0,
                 ("train", "test"), False),
}


def _assert_same(t, j, resized):
    assert t.img_wh == j.img_wh
    for name in ("K", "directions", "poses"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.rays.dtype == j.rays.dtype and t.rays.shape == j.rays.shape
    if resized:
        np.testing.assert_allclose(t.rays, j.rays, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(t.rays, j.rays)
    assert t.has_exposure == j.has_exposure
    for name in ("unit_exposure_rgb", "pts3d"):
        assert hasattr(t, name) == hasattr(j, name), name
        if hasattr(j, name):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert len(t) == len(j)


@pytest.mark.parametrize("case", list(CASES))
def test_loader_matches_jax(tmp_path, case):
    """Every split of the fixture: the JAX loader's arrays, and the same
    window rule (8-step windows at one cascade; the two-window chain at
    scale 4) on its directions."""
    fmt, write, downsample, splits, resized = CASES[case]
    root = write(tmp_path)
    for split in splits:
        t = dataset_dict[fmt](root, split, downsample, device="cpu")
        j = jax_datasets[fmt](root, split=split, downsample=downsample)
        _assert_same(t, j, resized)
        if split == "train":
            assert len(t.rays) > 0
        for ms, scale in ((1024, 0.5), (256, 0.5), (1024, 4.0)):
            assert (trm.segment_march_dmax_ok(t.directions, 128, ms, scale)
                    == jrm.segment_march_dmax_ok(j.directions, 128, ms,
                                                 scale))
        for f, c in ((0.0, 1), (1 / 256, 4), (1 / 256, 7), (0.02, 4)):
            assert (trm.window_march_mc_ok(t.directions, f, c)
                    == jrm.window_march_mc_ok(j.directions, f, c))
    # a test item: the pose and, where the split has images, its colours
    t = dataset_dict[fmt](root, splits[-1], downsample, device="cpu")
    j = jax_datasets[fmt](root, split=splits[-1], downsample=downsample)
    ti, ji = t.test_item(0), j.test_item(0)
    np.testing.assert_array_equal(ti["pose"], ji["pose"])
    assert ("rgb" in ti) == ("rgb" in ji)
    if "rgb" in ji:
        assert isinstance(ti["rgb"], torch.Tensor)
        np.testing.assert_allclose(ti["rgb"].numpy(), ji["rgb"], rtol=0,
                                   atol=1e-6 if resized else 0)
        assert ("exposure" in ti) == ("exposure" in ji)


def test_read_meta_false_and_hdr_store(tmp_path):
    """`read_meta=False` gives the intrinsics alone; an HDR-NeRF store has
    the exposure table's value in a fourth channel, the test item's
    exposure too, and the capture's unit exposure."""
    root = disk_scenes.blender(tmp_path)
    t = dataset_dict["nerf"](root, "train", 0.02, device="cpu",
                             read_meta=False)
    assert t.poses.shape == (0, 3, 4) and t.K.shape == (3, 3)
    root = disk_scenes.hdr_nerf(tmp_path)
    t = dataset_dict["colmap"](root, "train", 1.0, device="cpu")
    assert t.rays.shape == (54, 48, 4) and t.unit_exposure_rgb == 0.73
    np.testing.assert_array_equal(np.unique(t.rays[:, 0, 3]),
                                  np.float32([1 / 8, 2.0, 32.0]))
    tt = dataset_dict["colmap"](root, "test", 1.0, device="cpu")
    assert tt.test_item(1)["exposure"] == np.float32(1 / 8 * 4 ** 3)


@pytest.mark.parametrize("fmt", ["nerf", "nsvf", "colmap", "nerfpp", "rtmv"])
def test_disk_loader_needs_a_root_dir(fmt):
    with pytest.raises(ValueError, match="root_dir"):
        dataset_dict[fmt]("", "train", 1.0, device="cpu")


def test_registry_and_flags_match_jax():
    """The six names; `root_dir`, `split`, `device_dataset` and
    `device_dataset_max_bytes` with the JAX package's defaults (`root_dir`
    may be left out here: ""); `--dataset_name` and `--split` with its
    choices on both entry points."""
    import argparse

    from ngp_pl_torch.config import add_eval_args, add_train_args

    assert set(dataset_dict) == set(jax_datasets)
    for name in ("root_dir", "split", "device_dataset",
                 "device_dataset_max_bytes"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name)
    for add in (add_train_args, add_eval_args):
        p = argparse.ArgumentParser()
        add(p)
        acts = {a.dest: a for a in p._actions}
        assert set(acts["dataset_name"].choices) == set(jax_datasets)
        assert acts["split"].choices == ["train", "trainval", "trainvaltest"]
        args = p.parse_args(["--dataset_name", "rtmv", "--root_dir", "d",
                             "--split", "trainval"])
        assert (args.dataset_name, args.root_dir, args.split) == (
            "rtmv", "d", "trainval")


# -- the training system on a disk scene -------------------------------------

SCENE = dict(dataset_name="nerf", downsample=0.02, batch_size=N_RAYS,
             num_epochs=1, iters_per_epoch=16, train_layout="csr",
             no_save_test=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """NeRF-Synthetic's layout at 16x16 (downsample 0.02): 3 train and 2
    test views of the procedural scene, RGBA."""
    root = str(tmp_path_factory.mktemp("disk") / "lego")
    rec = write_blender_scene(root, n_train=3, n_test=2, side=16,
                              device="cpu")
    return root, rec


def test_scene_writer_round_trip(scene):
    """The loader gives back the written views within 1/255 (8-bit colour
    and alpha) and the procedural poses."""
    root, rec = scene
    ds = dataset_dict["nerf"](root, "train", 0.02, device="cpu")
    assert ds.rays.shape == (3, 256, 3)
    assert np.abs(ds.rays - rec["train_gt"].numpy()).max() <= 1 / 255
    np.testing.assert_allclose(ds.poses, rec["train_poses"], rtol=0,
                               atol=1e-6)


def test_host_batches_match_the_jax_system(scene):
    """Past its device budget the store stays on the host, and 8 steps draw
    the JAX system's batches (`NeRFSystem.sample_batch`) bit for bit; under
    the budget it goes to the device."""
    root, _ = scene
    ts = NeRFSystem(SmallTrainConfig(root_dir=root, device_dataset=False,
                                     **SCENE), device="cpu")
    assert ts.rays is None
    js = JaxSystem(JaxTrainConfig(root_dir=root, device_dataset=False,
                                  n_levels=4, log2_hashmap_size=12,
                                  num_devices=1, **SCENE))
    assert js.rays_device is None
    seen, draw = [], ts.train_dataset.sample_batch
    ts.train_dataset.sample_batch = lambda rng: seen.append(draw(rng)) \
        or seen[-1]
    for _ in range(8):
        m = ts.step()
        assert np.isfinite(float(m["loss"]))
    assert len(seen) == 8
    for got in seen:
        want = js.sample_batch()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    small = NeRFSystem(SmallTrainConfig(root_dir=root, **SCENE),
                       device="cpu")
    np.testing.assert_array_equal(small.rays.numpy(),
                                  small.train_dataset.rays)
    over = NeRFSystem(SmallTrainConfig(root_dir=root,
                                       device_dataset_max_bytes=1000,
                                       **SCENE), device="cpu")
    assert over.rays is None


def test_one_step_on_a_host_batch_matches_jax(monkeypatch, scene):
    """One CSR step on a host batch of the disk scene (rays from its poses
    and directions, targets from its store), from identical params: rays
    bit-equal, pool identical, loss within 1e-5, every gradient within
    2e-3 of its max (test_torch_train's one-step limits)."""
    root, _ = scene
    ds = dataset_dict["nerf"](root, "train", 0.02, device="cpu")
    ds.batch_size = N_RAYS
    b = ds.sample_batch(np.random.default_rng(3))
    ro_j, rd_j = jax_get_rays(jnp.asarray(ds.directions[b["pix_idxs"]]),
                              jnp.asarray(ds.poses[b["img_idxs"]]))
    ro_t, rd_t = get_rays(torch.from_numpy(ds.directions)[b["pix_idxs"]],
                          torch.from_numpy(ds.poses)[b["img_idxs"]])
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    np.testing.assert_array_equal(rd_t.numpy(), np.asarray(rd_j))
    ro, rd = ro_t.contiguous().numpy(), rd_t.contiguous().numpy()
    jngp, params = _jax_model(scale_table=1e3, seed=2)
    params["sigma_mlp"][1][:, 0] *= 4.0
    occ = _shell_grid()
    noise = np.random.default_rng(9).random(N_RAYS).astype(np.float32)
    loss_j, res_j, grads_j = _jax_loss_and_grads(
        monkeypatch, jngp, params, occ, ro, rd, b["rgb"], noise)
    ngp = _port_model(params)
    win = trm.occupancy_windows(torch.from_numpy(occ))
    res_t, loss_of = tts.train_render(
        ngp, win, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(noise), torch.ones(3),
        tcfg=TrainConfig(lr=1e-2, num_epochs=2, iters_per_epoch=4),
        rcfg=RenderConfig(), n_samples=8, chain_length=1152, layout="csr")
    for f in ("ts", "ray_idx", "offsets", "rm_counts"):
        np.testing.assert_array_equal(res_t[f].numpy(), np.asarray(res_j[f]),
                                      err_msg=f)
    assert int(res_t["rm_samples"]) > 0
    loss_t = loss_of(torch.from_numpy(b["rgb"]))
    assert float(loss_t.detach()) == pytest.approx(loss_j, rel=1e-5)
    grads_t = torch.autograd.grad(loss_t, [w for _, _, w in ngp._slots()])
    for i, (a, g) in enumerate(zip(grads_t, _leaves(grads_j))):
        assert np.abs(g).max() > 0, i
        assert np.abs(a.numpy() - g).max() <= 2e-3 * np.abs(g).max(), i


def test_validate_a_pose_only_split(scene, tmp_path, monkeypatch):
    """A test split without images (NeRF++'s camera_path) renders and dumps
    each view and scores none; a split with images scores."""
    root, _ = scene
    monkeypatch.chdir(tmp_path)
    traj = dataset_dict["nerfpp"](disk_scenes.nerfpp(tmp_path), "test_traj",
                                  device="cpu")
    assert len(traj.rays) == 0
    system = NeRFSystem(SmallTrainConfig(root_dir=root, exp_name="traj",
                                         **SCENE), device="cpu",
                        test_dataset=traj)
    assert system.validate(save_images=True, max_images=2) == {}
    assert sorted(os.listdir("results/nerf/traj")) == [
        "000.png", "000_d.png", "001.png", "001_d.png"]
    system.test_dataset = dataset_dict["nerf"](root, "test", 0.02,
                                               device="cpu")
    scores = system.validate(save_images=False)
    assert set(scores) == {"psnr", "ssim"}
    assert all(np.isfinite(v) for v in scores.values())


def test_train_and_eval_entry_points_on_a_disk_scene(scene, tmp_path,
                                                     monkeypatch):
    """`python -m ngp_pl_torch.train --dataset_name nerf --root_dir DIR`
    trains, checkpoints and scores the test views; `ngp_pl_torch.eval`
    scores them again from the slim checkpoint."""
    root, _ = scene
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--dataset_name", "nerf", "--root_dir", root,
            "--downsample", "0.02", "--n_levels", "4",
            "--log2_hashmap_size", "12"]
    system, scores = ttrain.main(argv + [
        "--batch_size", "256", "--num_epochs", "1", "--iters_per_epoch",
        "16", "--max_images", "1", "--train_layout", "csr"])
    assert system.optimizer.count == 16 and system.rays is not None
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert sorted(os.listdir("results/nerf/exp")) == ["000.png", "000_d.png"]
    slim = tmp_path / "ckpts" / "nerf" / "exp" / "epoch=1_slim.npz"
    assert slim.exists()
    res = teval.main(argv + ["--weight_path", str(slim)])
    assert len(res.images) == 2 and res.images[0].shape == (16, 16, 3)
    assert np.isfinite(res.psnr)


@pytest.mark.parametrize("device_dataset", [True, False])
def test_hdr_batches_carry_the_exposure_column(tmp_path, device_dataset):
    """An HDR-NeRF store's fourth channel reaches the step as each ray's
    exposure on both paths: the batch's payload is the store's rows, and
    an HDR step on it is finite."""
    root = disk_scenes.hdr_nerf(tmp_path)
    system = NeRFSystem(SmallTrainConfig(
        dataset_name="colmap", root_dir=root, use_exposure=True,
        device_dataset=device_dataset, batch_size=N_RAYS, num_epochs=1,
        iters_per_epoch=16, train_layout="csr", no_save_test=True),
        device="cpu")
    assert (system.rays is None) == (not device_dataset)
    assert system.unit_exposure_rgb == 0.73
    img, pix, payload = system.sample_batch()
    assert payload.shape == (N_RAYS, 4)
    store = system.train_dataset.rays
    np.testing.assert_array_equal(payload.numpy(),
                                  store[img.numpy(), pix.numpy()])
    assert np.isfinite(float(system.step()["loss"]))
