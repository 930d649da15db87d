"""A run with the look for a card skipped, driven on the CPU at a small
size through the program's plain versions: sound, it is correct; with the
timed path broken underneath (a step that leaves the state unchanged, a
loss over half of the batch, a frame altered where it is produced),
`correct` comes out false."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from perfbench import control, harness, loops

SEED = 2 ** 31 + 11          # more than 32 signed bits hold


# At the tiny size a 32-step fit on 4 views of 24x24 renders the orbit no
# nearer its ground truth than an unfitted field does (a mean squared gap of
# 0.044-0.048 on both), so the tiny cell holds that number to this size's
# own limit; `test_gt_readings` checks its arithmetic.
TINY_GT_MSE = 0.1


def tiny(name: str, root=harness.ROOT) -> harness.Cell:
    """The cell with its configuration cut to a size a CPU test holds:
    4 levels of a 2^12 table, 4 views of 24x24, 256 rays a step."""
    cell = harness.Cell(name, root)
    cfg = copy.deepcopy(cell.config)
    m = cfg["model"]
    m.update(n_levels=4, log2_hashmap_size=12)
    m["density_mlp"] = [4 * m["n_features"]] + m["density_mlp"][1:]
    cfg["recipe"]["batch_size"] = 256
    cfg["scene"].update(views=4, img_size=24)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, warm_blocks=2, rate_blocks=1,
                        fit_steps=32, trace_frames=2, reference_frames=2,
                        orbit={"poses": 3, "elevation_deg": 30.0})
    if "frame_gt_mse" in cell.limits:
        cell.limits = dict(cell.limits, frame_gt_mse=TINY_GT_MSE)
    return cell


def run(cell, faults=None, seconds=0.3) -> dict:
    torch.manual_seed(0)
    r = loops.Run(cell, SEED, seconds, False, 0, 1, torch.device("cpu"),
                  time.perf_counter(), faults=faults)
    return json.loads(loops.main_rank(r))


@pytest.fixture(scope="module")
def train_cell():
    return tiny("train-l16f2-synthetic")


def test_a_sound_train_run_is_correct(train_cell):
    line = run(train_cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_broken_step_is_not_correct(train_cell, fault):
    line = run(train_cell, {"step": control.FAULTS[fault]})
    assert not line["correct"], line["checks"]


class Altered:
    """The renderer with every frame's colours moved where they are
    produced."""

    def __init__(self, rend):
        self.rend = rend

    def render_pose(self, *args, **kw):
        out = self.rend.render_pose(*args, **kw)
        return dict(out, rgb=out["rgb"] + 0.05)


def test_render_sound_and_altered():
    cell = tiny("render-l8f4-synthetic")
    assert run(cell)["correct"]
    line = run(cell, {"render": Altered})
    assert not line["correct"], line["checks"]


def test_gt_readings():
    """The render readings' gap from the ground truth: 0 for the ground
    truth itself, 0.01 for it moved by 0.1 on every colour."""
    from perfbench import scene, weights

    cell = tiny("render-l8f4-synthetic")
    r = loops.Run(cell, SEED, 0.0, False, 0, 1, torch.device("cpu"),
                  time.perf_counter())
    _, test = r.views()
    gt = scene.views(test.poses, test.img_wh[0], torch.device("cpu"))
    model = cell.config["model"]
    params = weights.make(model, SEED, torch.device("cpu"))
    G = model["grid_size"]
    occ = torch.ones((1, G, G, G), dtype=torch.uint8)
    kind = loops.kind("render")
    for shift, want in ((0.0, 0.0), (0.1, 0.01)):
        images = [(i, gt[i] + shift) for i in range(len(gt))]
        got = kind.readings(images, params, occ, test, cell.config,
                            cell.traffic, SEED, torch.device("cpu"))
        assert got["frame_gt_mse"] == pytest.approx(want, abs=1e-6)


def test_render_serves_one_field_for_every_seed():
    """The render cell fits its field from the traffic's `fit_seed`, so
    runs of two seeds serve the same field and each frame the same work."""
    from perfbench import program

    cell = tiny("render-l8f4-synthetic")
    kind = loops.kind("render")
    fields = []
    for seed in (SEED, 7):
        torch.manual_seed(seed)
        r = loops.Run(cell, seed, 0.0, False, 0, 1, torch.device("cpu"),
                      time.perf_counter())
        views, test = r.views()
        leaves = program.params(kind.fit(r, views, test))
        fields.append([leaves["hash_table"], *leaves["sigma_mlp"],
                       *leaves["rgb_mlp"]])
    for a, b in zip(*fields):
        assert torch.equal(a, b)
