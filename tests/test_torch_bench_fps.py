"""The render-FPS benchmark (`ngp_pl_torch.benchmarking.bench_fps`): its
renderer at T 1e-2 against the JAX package's `make_device_round_renderer(
..., t_threshold=1e-2)`, and its entry point's JSON line against
benchmarking/bench_fps.py's keys."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.models.rendering import make_device_round_renderer
from ngp_pl_tpu.ops.ray_march import segment_march_dmax_ok
from ngp_pl_torch.benchmarking import bench_fps
from ngp_pl_torch.config import RenderConfig
from ngp_pl_torch.models.rendering import RoundRenderer
from tests.test_torch_render import _occ, _rays, _render_models

torch.set_num_threads(2)

# benchmarking/bench_fps.py:78-86, in its order
JAX_KEYS = ["metric", "value", "unit", "vs_baseline", "samples_per_ray",
            "rounds", "mean_opacity"]


# Total samples: equal at F=2.  At F=4 one ray of the 300 ends its first
# round at opacity 0.990033 in JAX and just under 0.99 in the port (K1's
# plain version sums its bf16 products in another order), so it marches a
# second round of 53 samples (0.4% of the total); the limit is then the
# round renderer's parity limit, 1% (tests/test_torch_render.py).
SAMPLES_REL = {4: 1e-2, 2: 0.0}


@pytest.mark.parametrize("F", [4, 2])
def test_renderer_at_fps_threshold_matches_jax(F):
    """Grid 32, L=4, 300 rays, chunk 256: the same rounds, the samples
    within SAMPLES_REL; rgb and opacity within 5e-3, depth within 1e-2
    (the round renderer's parity limits, tests/test_torch_render.py)."""
    jngp, params, tngp = _render_models(F)
    occ = _occ()
    ro, rd = _rays()
    out_j = make_device_round_renderer(
        jngp, JaxRenderConfig(), chunk=256,
        use_window=segment_march_dmax_ok(rd, scale=0.5),
        t_threshold=1e-2)(params, jnp.asarray(occ), ro, rd)
    render = bench_fps.renderer(tngp, RenderConfig(), rd, chunk=256)
    assert render.rcfg.test_t_threshold == 1e-2
    out_t = render.render_image(torch.from_numpy(occ), torch.from_numpy(ro),
                                torch.from_numpy(rd))
    assert out_t["opacity"].max() > 0.99
    assert out_t["total_samples"] == pytest.approx(
        out_j["total_samples"], rel=SAMPLES_REL[F], abs=0)
    assert out_t["rounds"] == out_j["rounds"]
    np.testing.assert_allclose(out_t["rgb"].numpy(), out_j["rgb"], atol=5e-3)
    np.testing.assert_allclose(out_t["opacity"].numpy(), out_j["opacity"],
                               atol=5e-3)
    np.testing.assert_allclose(out_t["depth"].numpy(), out_j["depth"],
                               atol=1e-2)
    # the threshold is what moves: at validation's 1e-4 the rays march on
    assert RoundRenderer(tngp, RenderConfig(), chunk=256).render_image(
        torch.from_numpy(occ), torch.from_numpy(ro),
        torch.from_numpy(rd))["total_samples"] > out_t["total_samples"]


def test_frame_chunk():
    assert bench_fps.frame_chunk(800 * 800) == 131072
    assert bench_fps.frame_chunk(64 * 64) == 4096
    assert bench_fps.frame_chunk(300) == 512


def test_main_prints_jax_line(monkeypatch, capsys):
    """`main` on a tiny model (L=4, T=2^12, batch 256): the last line is
    JAX's record, its keys in JAX's order; the line before holds the frame
    time, the launches (0 on the CPU) and the device."""
    make = bench_fps.fps_system
    monkeypatch.setattr(bench_fps, "fps_system", lambda device: make(
        device, n_levels=4, log2_hashmap_size=12, batch_size=256))
    rec = bench_fps.main(["--size", "64", "--frames", "2", "--train_steps",
                          "32", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == JAX_KEYS
    assert last["metric"] == "render_fps"
    assert last["unit"] == "frames/s @ 64x64"
    assert last["value"] > 0 and last["rounds"] >= 1
    assert last["vs_baseline"] == round(rec["fps"] / 36.2, 4)
    assert 0.0 <= last["mean_opacity"] <= 1.0
    assert last["samples_per_ray"] == round(rec["samples"] / 64 ** 2, 2)
    detail = json.loads(lines[-2])
    assert detail["frames"] == 2 and detail["card"] == "cpu"
    assert detail["launches"] == {"K1": 0, "K7": 0}
    assert detail["frame_ms"] == pytest.approx(1e3 / rec["fps"])
    assert rec["out"]["rgb"].shape == (64 * 64, 3)
    assert bool(torch.isfinite(rec["out"]["rgb"]).all())
