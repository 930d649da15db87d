"""The benchmark's arithmetic on hand-worked values: rate, percentile,
roofline bounds, the readers, and the result line's keys."""
from __future__ import annotations

import json
import math

import pytest
import torch

from perfbench import harness, trace, yardstick
from perfbench.reference import field as rf

MODEL = {"n_levels": 2, "n_features": 2, "log2_hashmap_size": 12,
         "base_resolution": 16, "max_resolution_factor": 2048.0,
         "scale": 0.5, "grid_size": 128, "density_mlp": [4, 64, 16],
         "color_mlp": [32, 64, 64, 3], "sh_degree": 4}


def test_rate_and_percentile():
    assert yardstick.rate(16384 * 160, 2.0) == 1310720.0
    assert yardstick.percentile([10, 20, 30, 40, 50], 95) == 48.0
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile(list(range(1, 101)), 50) == 50.5
    with pytest.raises(ValueError):
        yardstick.rate(1, 0.0)


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert yardstick.bound_s(3.35e12, 0.0, 0.0) == 1.0
    assert yardstick.bound_s(0.0, 989e12, 67e12) == 2.0
    assert yardstick.bound_s(3.35e9, 989e9, 0.0) == 1e-3


def test_tail_bounds_by_hand():
    shapes = [(64, 16), (32, 64), (64, 64), (64, 3)]
    w = 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3          # 7360
    P = 1000
    assert yardstick.tail_fwd_bound(P, shapes) == pytest.approx(
        max((P * 336 + w * 4) / 3.35e12, 2 * P * w / 989e12))
    assert yardstick.tail_bwd_bound(P, shapes) == pytest.approx(
        max((P * 148 * 4 + 2 * w * 4) / 3.35e12,
            2 * P * (2 * w + 6336) / 989e12))


def test_table_points_counts_distinct_corners():
    g = rf.grid(MODEL)
    one = torch.tensor([[0.5, 0.5, 0.5]])
    # one sample: 8 corners on each of 2 levels
    assert yardstick.table_points(one, g) == 16
    # the same sample twice reads the same points
    assert yardstick.table_points(one.repeat(2, 1), g) == 16


def test_encode_bounds_by_hand():
    g = rf.grid(MODEL)
    N, pts = 1000, 500
    LF = 4
    fwd = max((N * 12 + N * 256 + pts * 2 * 4 + LF * 256) / 3.35e12,
              2 * N * LF * 64 / 989e12 + N * 2 * (8 * 2 * 2 + 16) / 67e12)
    assert yardstick.encode_fwd_bound(N, pts, g, 4, False) == \
        pytest.approx(fwd)
    bwd = max((N * 12 + N * 256 + LF * 256 + pts * 2 * 4) / 3.35e12,
              2 * N * LF * 64 / 989e12 + N * 2 * (16 + 8 * 2 * 2) / 67e12)
    assert yardstick.encode_bwd_bound(N, pts, g) == pytest.approx(bwd)


def test_sample_flops_by_hand():
    mm = 2.0 * (4 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3)
    interp = 2 * (8 * 2 * 2 + 16)
    assert yardstick.sample_flops(MODEL, False) == mm + interp
    assert yardstick.sample_flops(MODEL, True) == 3 * mm + 2 * interp


def test_trace_union_and_breakdown():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    tr = {"device_ops": [("a", 0.0, 2e6), ("b", 0.0, 1e6), ("a", 3e6, 4e6)],
          "gaps": [("aten::cumsum", 5.0)]}
    b = trace.breakdown(tr)
    assert b["device_ops"] == [["a", 3.0], ["b", 1.0]]
    assert b["idle_gaps"][0][0] == "aten::cumsum"
    assert b["idle_gaps"][0][1] == pytest.approx(5e-6)


def _ctx(**kw):
    ctx = {"units": 4, "window_s": 2.0, "busy_s": 1.5, "chips": 1,
           "device_ops": [("hash_encode_fwd_kernel", 0.0, 100.0),
                          ("ncclDevKernel_AllReduce", 100.0, 300.0),
                          ("elementwise", 300.0, 700.0)],
           "launches": 40, "hand": ("hash_encode_fwd_kernel",),
           "comm": ("nccl",), "bound_s": 50e-6, "samples": 8.0,
           "rays": 4.0, "flops": 989e12 * 0.02, "rounds": 12,
           "pixels": 16}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name,want", [
    ("launches_per_step.train", 10.0),
    ("launches_per_frame.render", 10.0),
    ("torch_kernels_ms.train", 0.1),        # 400 us over 4 steps
    ("torch_kernels_ms.render", 0.1),
    ("device_idle_pct.render", 25.0),
    ("samples_per_ray.train", 2.0),
    ("samples_per_ray.render", 0.5),
    ("rounds_per_frame.render", 3.0),
    ("hand_kernels_roofline.train", 50.0),  # 50 us over 100 us
    ("step_mfu.train", 1.0),                 # 0.02 s of peak over 2 s
    ("device_idle_pct.train", 25.0),
])
def test_readers_by_hand(name, want):
    assert harness.reader(name).read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["hand_kernels_roofline.render",
                                  "torch_kernels_ms.train",
                                  "step_mfu.render",
                                  "device_idle_pct.render"])
def test_readers_find_nothing_and_say_so(name):
    ctx = _ctx(device_ops=[], bound_s=0.0, flops=0.0, busy_s=0.0)
    assert harness.reader(name).read(ctx) is None


def test_result_line_has_the_contract_keys_checks_last():
    checks = harness.compare({"loss_gap": 1e-4, "other": 2.0},
                             {"loss_gap": 1e-3})
    assert harness.passed(checks)
    line = json.loads(harness.result_line(
        True, 10, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
        {"platform": "gpu", "kind": "k", "count": 1,
         "memory_peak_bytes": 1}, checks))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == {"loss_gap": {"value": 1e-4, "limit": 1e-3}}
    traced = json.loads(harness.result_line(
        False, 1, 0, {}, {}, checks, {"device_ops": [], "idle_gaps": []}))
    assert list(traced)[-2:] == ["breakdown", "checks"]


def test_a_reading_above_its_limit_fails_and_a_missing_one_raises():
    assert not harness.passed(harness.compare({"a": 2.0}, {"a": 1.0}))
    with pytest.raises(RuntimeError):
        harness.compare({}, {"a": 1.0})


def test_grid_sizes_match_the_published_table():
    g = rf.grid({**MODEL, "n_levels": 16, "log2_hashmap_size": 19})
    assert g.total_rows == 220851 and g.row_width == 64
    g4 = rf.grid({**MODEL, "n_levels": 8, "n_features": 4,
                  "log2_hashmap_size": 19})
    assert g4.total_rows == 102752 and g4.row_width == 128
    assert math.isclose(g.resolutions[-1], 1024, rel_tol=0.01)


def test_trace_read_counts_operations_not_annotations():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, a, b, dev, ann=False):
        return NS(name=name, time_range=NS(start=a, end=b),
                  device_type=dev, is_user_annotation=ann)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = NS(events=lambda: [
        ev("aten::mul", 0.0, 50.0, cpu), ev("cudaLaunchKernel", 1.0, 2.0, cpu),
        ev("k1", 10.0, 20.0, cuda), ev("nccl:all_reduce", 30.0, 40.0, cuda),
        ev("ncclDevKernel_AllReduce", 30.0, 40.0, cuda),
        ev("gpu_range", 10.0, 40.0, cuda, ann=True)])
    tr = trace.read(prof)
    assert [op[0] for op in tr["device_ops"]] == ["k1",
                                                  "ncclDevKernel_AllReduce"]
    assert tr["launches"] == 1 and tr["busy_us"] == 20.0
    assert tr["gaps"] == [("aten::mul", 10.0)]
