"""Video export (`ngp_pl_torch/utils/video.py`, the train CLI's assembly)
against the JAX package's GIF fallback (`ngp_pl_tpu/utils/video.py`,
which writes a GIF through imageio where imageio has no ffmpeg backend),
both decoded by imageio.

Frame counts equal; depth frames (at most 256 colours, the turbo table's)
decode exactly in both; RGB frames within the port's quantiser's bound,
`QUANT_MAX_ERR` (25 of 255 per channel, the 6x6x6 cube).  Delay: JAX's
fallback passes `duration=1/fps` in seconds where imageio's Pillow writer
reads milliseconds, so its GIF carries a delay of 0 (a defect of the JAX
package, filed); the port's delay is the one JAX asks for, round(100 /
fps) hundredths, equal to imageio's GIF written with that duration in
milliseconds.

Sizes: 24x32 frames, 32x32 renders, grid 32, L=4, log2 T=12."""
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from ngp_pl_tpu.training.system import depth2img as jax_depth2img
from ngp_pl_tpu.utils.video import write_video as jax_write_video
from ngp_pl_torch import train as ttrain
from ngp_pl_torch.utils import video as tvideo
from tests import disk_scenes
from tests.test_torch_entry_points import _small_system

torch.set_num_threads(2)


def _frames(kind, n=4, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "depth":
        return [jax_depth2img(rng.random((24, 32)).astype(np.float32))
                for _ in range(n)]
    if kind == "few":                   # 200 colours
        pal = rng.integers(0, 256, (200, 3), np.uint8)
        return [pal[rng.integers(0, 200, (24, 32))] for _ in range(n)]
    return [(rng.random((24, 32, 3)) * 255).astype(np.uint8)
            for _ in range(n)]


def _decoded(path):
    return [f[..., :3] for f in imageio.mimread(path)]


def _delays(path):
    im = Image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(im.info.get("duration", 0))
    return out


@pytest.mark.parametrize("kind", ["depth", "few", "rgb"])
def test_gif_against_jax_fallback(tmp_path, kind):
    frames = _frames(kind)
    pj = jax_write_video(str(tmp_path / "j" / "v.mp4"), frames, fps=30)
    pt = tvideo.write_video(str(tmp_path / "t" / "v.mp4"), frames, fps=30)
    assert pt == str(tmp_path / "t" / "v.gif") and pj.endswith("v.gif")
    dj, dt = _decoded(pj), _decoded(pt)
    assert len(dt) == len(dj) == len(frames)
    for a, b, f in zip(dt, dj, frames):
        assert a.shape == b.shape == f.shape
        err = np.abs(a.astype(int) - f).max()
        if kind == "rgb":
            assert 0 < err <= tvideo.QUANT_MAX_ERR
        else:                           # at most 256 colours: exact
            assert err == 0
            np.testing.assert_array_equal(a, b)
    # the delay JAX asks for, as imageio writes it given milliseconds
    want = str(tmp_path / "want.gif")
    imageio.mimsave(want, frames, duration=1000.0 / 30)
    assert _delays(pt) == _delays(want) == [30] * len(frames)
    assert _delays(pj) == [0] * len(frames)          # JAX's defect
    assert Image.open(pt).info.get("loop") == 0      # loops


@pytest.mark.parametrize("shape", [(1, 1), (3, 1365), (40, 130)])
def test_lzw_decodes_exactly(tmp_path, shape):
    """Code widths 9-12 and the table's clear at 4,096 codes: noise of 256
    reds, and a run of one colour, decode to the frame."""
    rng = np.random.default_rng(1)
    noise = np.zeros(shape + (3,), np.uint8)
    noise[..., 0] = rng.integers(0, 256, shape)
    flat = np.zeros(shape + (3,), np.uint8) + np.uint8([7, 11, 13])
    path = str(tmp_path / "x.gif")
    tvideo.write_gif(path, [noise, flat], fps=25)
    got = _decoded(path)
    np.testing.assert_array_equal(got[0], noise)
    np.testing.assert_array_equal(got[1], flat)
    assert _delays(path) == [40, 40]


def test_render_trajectory_video(tmp_path):
    """Two poses through the system's round renderer: the rgb frames and
    the depth frames as validate dumps them."""
    system = _small_system(n_test=2)
    ds = system.test_dataset
    w, h = ds.img_wh
    dirs = torch.from_numpy(ds.directions)
    renderer = system.renderer()
    p_rgb, p_dep = tvideo.render_trajectory_video(
        renderer, system.grid_state.occ_grid, ds.poses, dirs, ds.img_wh,
        str(tmp_path), "traj", fps=10)
    assert p_rgb.endswith("traj_rgb.gif") and p_dep.endswith("traj_depth.gif")
    rgb, dep = _decoded(p_rgb), _decoded(p_dep)
    assert len(rgb) == len(dep) == 2
    for i, pose in enumerate(ds.poses):
        out = renderer.render_pose(system.grid_state.occ_grid, dirs,
                                   torch.from_numpy(pose))
        want = (np.clip(out["rgb"].reshape(h, w, 3).numpy(), 0, 1)
                * 255).astype(np.uint8)
        assert np.abs(rgb[i].astype(int) - want).max() <= \
            tvideo.QUANT_MAX_ERR
        np.testing.assert_array_equal(
            dep[i], jax_depth2img(out["depth"].reshape(h, w).numpy()))
    assert _delays(p_rgb) == [100, 100]


def test_train_cli_assembles_nsvf_synthetic_videos(tmp_path, monkeypatch):
    """An NSVF Synthetic scene through the train CLI: rgb.gif and depth.gif
    beside the dumps, frames as JAX's assembly reads the same dumps."""
    root = disk_scenes.nsvf(tmp_path / "scene")
    assert "Synthetic" in root
    monkeypatch.chdir(tmp_path)
    ttrain.main(["--device", "cpu", "--dataset_name", "nsvf", "--root_dir",
                 root, "--downsample", "0.02", "--n_levels", "4",
                 "--log2_hashmap_size", "12", "--batch_size", "64",
                 "--num_epochs", "1", "--iters_per_epoch", "16"])
    val_dir = tmp_path / "results" / "nsvf" / "exp"
    assert (val_dir / "rgb.gif").exists() and (val_dir / "depth.gif").exists()
    names = sorted(f for f in os.listdir(val_dir) if f.endswith(".png"))
    rgb = [imageio.imread(val_dir / f) for f in names
           if not f.endswith("_d.png")]
    dep = [imageio.imread(val_dir / f) for f in names if f.endswith("_d.png")]
    assert len(rgb) == len(dep) == 2
    jax_write_video(str(tmp_path / "j" / "depth.mp4"), dep, fps=30)
    np.testing.assert_array_equal(
        np.stack(_decoded(str(val_dir / "depth.gif"))),
        np.stack(_decoded(str(tmp_path / "j" / "depth.gif"))))
    got = _decoded(str(val_dir / "rgb.gif"))
    assert len(got) == len(rgb)
    for a, b in zip(got, rgb):
        assert np.abs(a.astype(int) - b).max() <= tvideo.QUANT_MAX_ERR


def test_no_videos_for_other_scenes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ttrain.main(["--device", "cpu", "--n_levels", "4", "--log2_hashmap_size",
                 "12", "--batch_size", "64", "--downsample", "0.1875",
                 "--num_epochs", "1", "--iters_per_epoch", "16",
                 "--max_images", "1"])
    files = os.listdir(tmp_path / "results" / "synthetic" / "exp")
    assert sorted(files) == ["000.png", "000_d.png"]
