"""The control at a size a CPU holds: the reference in the next precision
below the configuration's, put in the program's place, comes out as not
correct against the cell's own limits, and reads well above the
program's sound run on the number it moves."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, harness
from perfbench.tests.test_perfbench_faults import SEED, tiny

MOVED = {"train-l16f2-synthetic": "rgb_gap",
         "render-l8f4-synthetic": "frame_mean_abs"}


# the render cell's fault is planted in its fit, which reads apart from a
# sound one only at the cell's own size (see TINY_GT_MSE): not planted here
PLANTED = {"train-l16f2-synthetic": None, "render-l8f4-synthetic": ()}


@pytest.mark.parametrize("name", sorted(MOVED))
def test_the_control_is_not_correct(name):
    cell = tiny(name)
    (rec,) = control.readings(cell, [SEED], torch.device("cpu"),
                              log=lambda s: None, only=PLANTED[name])
    sound = harness.compare(rec["program"], cell.limits)
    assert harness.passed(sound), sound
    ctrl = {k: rec["control"].get(k, rec["program"][k])
            for k in cell.limits}
    assert not harness.passed(harness.compare(ctrl, cell.limits)), ctrl
    key = MOVED[name]
    assert rec["control"][key] >= 3.0 * rec["program"][key]
    for fault, reading in rec.items():
        if fault in control.FAULTS:
            got = {k: reading.get(k, rec["program"][k]) for k in cell.limits}
            assert not harness.passed(harness.compare(got, cell.limits))
