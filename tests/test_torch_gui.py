"""The orbit viewer (`ngp_pl_torch/show_gui.py`) against the JAX package's
`show_gui.py` on the CPU: the camera after orbit, scale and pan; one frame
of `render_cam` at 32x32 from one slim checkpoint at the viewer's
thresholds (128 samples, T 1e-2; one chunk of 1,024 rays, so the short
bucket ladder), rgb within the round renderer's limits (5e-2 on every
ray, 5e-3 on all but 0.5% of rays, as
`test_round_renderer_bucket_ladder_matches_jax`: the few past 5e-3 end on
a steep surface where the two fields' numerics differ), total samples and
rounds equal; `--screenshot` writes the frame as a PNG;
`run_gui` raises without dearpygui.

At 128 samples the JAX viewer's window rule is False for these cameras,
so JAX reads the grid's z-lines and the port the grid itself, whose bits
they equal.

Sizes: grid 32, L=4, log2 T=12, 32x32 frames."""
import dataclasses
import sys

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import show_gui as jgui
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_torch import show_gui as tgui
from ngp_pl_torch.ops.ray_march import segment_march_dmax_ok
from ngp_pl_torch.training.checkpoint import save_slim_checkpoint
from tests.test_torch_entry_points import SmallTrainConfig

torch.set_num_threads(2)


@dataclasses.dataclass(frozen=True)
class SmallJaxConfig(JaxTrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=32)


def _moves(cam):
    cam.orbit(40.0, -25.0)
    cam.scale(1.5)
    cam.pan(300.0, -120.0)
    cam.orbit(-15.0, 60.0)


def test_orbit_camera_matches_jax():
    ds = JaxSynthetic(split="test", downsample=0.25, read_meta=False)
    cams = [m.OrbitCamera(ds.K, ds.img_wh, r=2.5) for m in (jgui, tgui)]
    np.testing.assert_array_equal(cams[1].pose, cams[0].pose)
    for cam in cams:
        _moves(cam)
    for name in ("pose", "rot", "center"):
        a, b = getattr(cams[1], name), getattr(cams[0], name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert cams[1].radius == cams[0].radius


def _slim(tmp_path, grid):
    """A slim checkpoint of JAX's seeded small model, its table x1e4 and
    sigma head x8 so that rays end inside the box, and a random grid."""
    jngp = JaxNGP(SmallJaxConfig().ngp_config(), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e4
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(8.0)
    occ = (np.random.default_rng(0).random((1, grid, grid, grid))
           < 0.3).astype(np.uint8)
    path = str(tmp_path / f"slim{grid}.npz")
    save_slim_checkpoint(path, params=jax.tree_util.tree_map(np.asarray,
                                                             params),
                         occ_grid=occ)
    return path


def test_render_cam_matches_jax(tmp_path):
    path = _slim(tmp_path, 32)
    ds = JaxSynthetic(split="test", downsample=0.25, read_meta=False)
    assert ds.img_wh == (32, 32)
    assert not segment_march_dmax_ok(ds.directions, grid_size=32,
                                     max_samples=128)
    jg = jgui.NGPGUI(SmallJaxConfig(ckpt_path=path), ds.K, ds.img_wh)
    tg = tgui.NGPGUI(SmallTrainConfig(ckpt_path=path), ds.K, ds.img_wh,
                     device="cpu")
    assert tg.renderer.chunk == 1024 and tg.renderer.rcfg.max_samples == 128
    assert tg.renderer.rcfg.test_t_threshold == 1e-2
    for g in (jg, tg):
        _moves(g.cam)
    want = jg.render_cam(jg.cam)
    got = tg.render_cam(tg.cam)
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    err = np.abs(got - want).reshape(-1, 3).max(1)
    assert err.max() <= 5e-2 and (err > 5e-3).mean() <= 5e-3
    assert tg.mean_samples == jg.mean_samples
    j_out = jg.render_image.from_pose(jg.params, jg.occ_grid, jg._dirs,
                                      jg.cam.pose)
    assert tg.rounds == j_out["rounds"]
    np.testing.assert_array_equal(j_out["rgb"].reshape(32, 32, 3), want)
    # some rays end on the field, some cross empty space to the white
    assert (got < 0.9).any() and (got > 0.99).any()
    assert tg.dt > 0


def test_screenshot_writes_the_frame(tmp_path, capsys):
    """`python -m ngp_pl_torch.show_gui --screenshot` at 32x32 with the
    default grid: a PNG of the frame `render_cam` returns, quantised as
    the JAX viewer quantises it."""
    path = _slim(tmp_path, 128)
    png = str(tmp_path / "shot.png")
    gui = tgui.main(["--device", "cpu", "--n_levels", "4",
                     "--log2_hashmap_size", "12", "--downsample", "0.25",
                     "--ckpt_path", path, "--screenshot", png])
    img = imageio.imread(png)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    frame = gui.render_cam(gui.cam)
    np.testing.assert_array_equal(
        img, (np.clip(frame, 0, 1) * 255).astype(np.uint8))
    assert f"wrote {png}" in capsys.readouterr().out


def test_run_gui_needs_dearpygui(tmp_path, monkeypatch):
    """No fallback: without dearpygui the window raises."""
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    gui = tgui.NGPGUI(SmallTrainConfig(ckpt_path=_slim(tmp_path, 32)),
                      np.float32([[38.4, 0, 16], [0, 38.4, 16], [0, 0, 1]]),
                      (32, 32), device="cpu")
    with pytest.raises(ImportError):
        gui.run_gui()


def test_viewer_needs_a_checkpoint():
    with pytest.raises(ValueError, match="--ckpt_path"):
        tgui.NGPGUI(SmallTrainConfig(), np.eye(3, dtype=np.float32),
                    (32, 32), device="cpu")
