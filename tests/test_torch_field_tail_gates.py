"""The two gates that hold K7 and K8 to their plain versions in
chip_smoke.py, at the train pool's 393,216 samples of chip_smoke.py's
inputs: the f32 plain version's own miss of its float64-summed twin (what a
correct kernel may read against it) lies within the limit against the f32
plain version, and every wrong variant of
ngp_pl_torch/benchmarking/field_tail_gates.py trips at least one gate.
"""
import importlib.util
import os

import pytest
import torch

from ngp_pl_torch.benchmarking import field_tail_gates as g
from ngp_pl_torch.ops import field_tail as ft

P = 393216
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gates():
    """Per kernel: its inputs, its two plain outputs, its reading and its
    (f32, float64) limits."""
    smoke, ws = _smoke(), g.model_weights()
    out = {}
    for kernel, args, plain, err, limits in (
            ("K7", (*g.tail_inputs(P, *g.K7_INPUTS), *ws), ft.field_tail_plain,
             g.k7_error, (smoke.K7_TOL, smoke.K7_TOL)),
            ("K8", (*g.tail_inputs(P, *g.K8_INPUTS, grads=True), *ws),
             ft.field_tail_bwd_plain, g.k8_error,
             (smoke.K8_F32_TOL, smoke.K8_TOL))):
        out[kernel] = (args, plain(*args), plain(*args, acc=torch.float64),
                       err, limits)
    return out


@pytest.mark.parametrize("kernel", ["K7", "K8"])
def test_f32_plain_version_misses_float64_sums_within_the_f32_gate(
        gates, kernel):
    args, f32, f64, err, (lim32, _) = gates[kernel]
    assert 0.0 < err(f32, f64) <= lim32
    assert err(g.variant("", *args), f32) == 0.0


@pytest.mark.parametrize("kernel,wrong",
                         [("K7", w) for w in g.K7_WRONG]
                         + [("K8", w) for w in g.K8_WRONG])
def test_wrong_variant_trips_a_gate(gates, kernel, wrong):
    args, f32, f64, err, (lim32, lim64) = gates[kernel]
    got = g.variant(wrong, *args)
    assert err(got, f32) > lim32 or err(got, f64) > lim64
