"""`python -m ngp_pl_torch.eval --fps_frames N`: the timing loop of the
root eval.py (:45-62), N fenced renders of test pose 0 after a warm one,
beside the per-view scores, which the loop leaves as they are."""
import re

import numpy as np
import pytest
import torch

from ngp_pl_torch import eval as teval
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.rendering import RoundRenderer

torch.set_num_threads(2)

ARGV = ["--device", "cpu", "--downsample", "0.125", "--n_levels", "4",
        "--log2_hashmap_size", "12", "--max_images", "2"]


def test_fps_frames_loop(monkeypatch, capsys):
    """--fps_frames 3 renders test pose 0 four more times than a run with
    --fps_frames 0 and prints the JAX script's line; the scores, images
    and the per-view FPS field are those of the run without the loop."""
    calls = []
    render_pose = RoundRenderer.render_pose

    def spy(self, occ_grid, directions, pose, bg_color=None):
        calls.append(pose.clone())
        return render_pose(self, occ_grid, directions, pose, bg_color)

    monkeypatch.setattr(RoundRenderer, "render_pose", spy)
    base = teval.main(ARGV + ["--fps_frames", "0"])
    n_base = len(calls)
    out_base = capsys.readouterr().out
    res = teval.main(ARGV + ["--fps_frames", "3"])
    out = capsys.readouterr().out
    loop = calls[2 * n_base:]
    assert n_base == 3                 # the warm frame and two views
    assert len(loop) == 4
    pose0 = torch.from_numpy(SyntheticDataset(
        split="test", downsample=0.125, device="cpu").poses[0])
    assert all(torch.equal(p, pose0) for p in loop)
    assert base.fps_loop is None and "render:" not in out_base
    assert res.fps_loop > 0 and res.fps_loop_samples_per_ray > 0
    assert res.psnr == base.psnr and res.ssim == base.ssim
    assert all(torch.equal(a, b) for a, b in zip(res.images, base.images))
    assert res.fps > 0
    w, h = res.images[0].shape[1], res.images[0].shape[0]
    m = re.search(r"^render: ([0-9.]+) FPS at (\d+)x(\d+) "
                  r"\(([0-9.]+) samples/ray\)$", out, re.M)
    assert m, out
    assert (int(m.group(2)), int(m.group(3))) == (w, h)
    assert float(m.group(1)) == pytest.approx(res.fps_loop, abs=5e-3)
    assert float(m.group(4)) == pytest.approx(
        res.fps_loop_samples_per_ray, abs=0.05)
    assert re.search(r"^test: psnr=", out, re.M)


def test_fps_loop_samples_are_view_zeros():
    """The loop renders the pose the first scored view renders: its
    samples per ray are view 0's."""
    from ngp_pl_torch.config import TrainConfig

    tcfg = TrainConfig(downsample=0.125, n_levels=4, log2_hashmap_size=12)
    res = teval.evaluate(tcfg, device="cpu", max_images=1, fps_frames=1)
    assert res.fps_loop_samples_per_ray == pytest.approx(
        res.samples_per_ray, rel=0, abs=0)
    assert np.isfinite(res.fps_loop)
