"""One frame's rays over two gloo ranks on the CPU (`RoundRenderer(group=)`,
the port of `make_device_round_renderer(mesh=)`; tests/test_parallel.py:
118-146), against the one-rank port and against JAX's renderer with its
chunk rays sharded over two of the harness's 8 CPU devices.

The ranks run tests/torch_shard_workers.py's `suite` once for the file
(they import only torch and the port) and meet through a file store under
the test's temporary directory.  What holds, in every case
(`W.CASES`: the span pass, a short last chunk split 7 and 6, given buckets
whose first slots are fewer than the alive rays, the unspanned path with
its padded last chunk):
- rounds, total samples and alive rays equal the one-rank frame's, and
  rgb, depth and opacity are within 1e-6 of it on every ray (a ray's
  result depends only on its rounds' buckets, which depend only on the
  global alive count; the field computes each sample alone);
- both ranks hold the whole frame;
- against JAX's mesh renderer on the inputs of
  tests/test_torch_render.py::test_round_renderer_matches_jax, that
  test's limits; on the other cases, the limits of its bucket-ladder test,
  which allow the few rays that end on a steep surface, where the port's
  field rounds as the TPU kernels do and JAX's CPU field does not (one of
  512 in "spanned", 6.7e-3 in rgb and 7.7e-3 in opacity: there the
  one-rank port misses JAX's one-device frame by as much, and JAX's mesh
  frame equals its one-device frame).
Also: the shares and the gather of ragged rows; `group=None` runs no
collective and a one-rank group gives the frame bit for bit; the eval
entry point with `--device cpu --num_devices 2`, and two `--multihost`
processes, print the one-rank scores.
"""
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import RenderConfig as JaxRenderConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.rendering import make_device_round_renderer
from ngp_pl_tpu.parallel.mesh import data_mesh
from ngp_pl_torch import parallel
from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.parallel import dist as pdist
from ngp_pl_torch.training.checkpoint import save_slim_checkpoint
from tests import torch_shard_workers as W

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_TOL = 1e-6


def _jax_model(scale):
    """JAX's seeded model with a denser field, so that rays terminate
    (tests/test_torch_render.py's `_render_models`)."""
    jngp = JaxNGP(JaxNGPConfig(**W.model_kw(scale)), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e4
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(8.0)
    return jngp, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX models and parameters by scale, numpy parameters by scale, the
    one-rank frames by case, the two ranks' frames)."""
    out = str(tmp_path_factory.mktemp("shard"))
    models = {s: _jax_model(s) for s in {c[0] for c in W.CASES.values()}}
    params = {s: jax.tree_util.tree_map(np.asarray, p)
              for s, (_, p) in models.items()}
    parallel.launch(W.suite, 2, (out, params), device="cpu", store_dir=out)
    ranks = [torch.load(os.path.join(out, f"frame_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    one = {case: W.render(params, case) for case in W.CASES}
    return models, params, one, ranks


@pytest.mark.parametrize("n", [0, 1, 2, 7, 13, 256])
def test_shares_are_contiguous_and_even(n):
    for world in (1, 2, 3, 4):
        bounds = [pdist.share_bounds(n, r, world) for r in range(world)]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [b - a for a, b in bounds]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_helpers_are_the_identity_without_a_group():
    t = torch.arange(10.0).reshape(5, 2)
    assert not parallel.active()
    assert parallel.my_share(7) == (0, 7)
    assert parallel.gather_ragged(t) is t
    assert parallel.gather_ints([3, 4], "cpu").tolist() == [[3, 4]]


@pytest.mark.parametrize("case", list(W.CASES))
def test_split_frame_matches_one_rank(runs, case):
    _, _, one, ranks = runs
    ref = one[case]
    assert ref["rounds"] > 0 and ref["opacity"].max() > 0.99
    r0, r1 = (r[case] for r in ranks)
    for res in (r0, r1):
        for k in ("rounds", "total_samples", "alive_rays"):
            assert res[k] == ref[k], k
        for k in ("rgb", "depth", "opacity"):
            err = float(np.abs(res[k] - ref[k]).max())
            print(f"{case} {k} max |two ranks - one rank| = {err}")
            assert err <= SPLIT_TOL, k
        assert res["collectives"] > ref["rounds"]
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_array_equal(r0[k], r1[k])
    assert ref["collectives"] == 0


@pytest.mark.parametrize("case", list(W.CASES))
def test_rounds_take_the_first_slots_across_ranks(runs, case):
    """Each round the two ranks' rows are the first min(slots, alive) of
    the chunk's alive rays, and the ranks see the same bucket and count."""
    _, _, _, (r0, r1) = runs
    rows0, rows1 = r0[case]["rows"], r1[case]["rows"]
    assert len(rows0) == len(rows1) == r0[case]["rounds"]
    for (slots, n_alive, a), (slots1, n_alive1, b) in zip(rows0, rows1):
        assert (slots, n_alive) == (slots1, n_alive1)
        assert a + b == min(slots, n_alive)
    if case == "buckets":
        assert any(n > s for s, n, _ in rows0)
        assert any(b == 0 < n for (_, n, _), (_, _, b) in zip(rows0, rows1))


def test_chunks_split_unevenly_and_a_rank_runs_idle(runs):
    """The short last chunk splits 7/6; in the unspanned frame the padded
    last chunk's real rays are all rank 0's; and a rank with no alive ray
    left still joins the rounds (0 rows) while the other has some."""
    _, _, one, (r0, r1) = runs
    assert one["short_last_chunk"]["alive_rays"] % W.CHUNK == 13
    scale, n, _ = W.CASES["unspanned"]
    assert n % W.CHUNK == W.CHUNK // 2
    idle = [(case, i) for case in ("spanned", "short_last_chunk")
            for i, ((_, n_alive, a), (_, _, b)) in enumerate(
                zip(r0[case]["rows"], r1[case]["rows"]))
            if n_alive > 0 and 0 in (a, b)]
    assert idle


@pytest.mark.parametrize("case", ["render_test_rays", "spanned",
                                  "unspanned"])
def test_split_frame_matches_jax_mesh(runs, case):
    """The two ranks' frame against `make_device_round_renderer(mesh=)`
    over two CPU devices: depth within 1e-2, total samples within 1%,
    alive rays equal; rgb and opacity within 5e-3 on the inputs of
    test_round_renderer_matches_jax, elsewhere within 5e-2 on every ray
    and 5e-3 on all but 0.5% of rays (the bucket-ladder test's limits)."""
    models, _, _, (r0, _) = runs
    scale, n, _ = W.CASES[case]
    jngp, params = models[scale]
    occ, ro, rd = W.scene(case)
    out_j = make_device_round_renderer(
        jngp, JaxRenderConfig(), chunk=W.CHUNK,
        mesh=data_mesh(jax.devices()[:2]))(params, jnp.asarray(occ), ro, rd)
    for k in ("rgb", "opacity"):
        err = np.abs(r0[case][k] - out_j[k]).reshape(n, -1).max(1)
        print(f"{case} {k} max |split - JAX mesh| = {err.max()}, rays "
              f"past 5e-3: {(err > 5e-3).sum()}")
        if case == "render_test_rays":
            assert err.max() <= 5e-3, k
        else:
            assert err.max() <= 5e-2, k
            assert (err > 5e-3).mean() <= 5e-3, k
    np.testing.assert_allclose(r0[case]["depth"], out_j["depth"], atol=1e-2)
    assert r0[case]["total_samples"] == pytest.approx(
        out_j["total_samples"], rel=1e-2)
    if "alive_rays" in out_j:
        assert r0[case]["alive_rays"] == out_j["alive_rays"]


def test_no_group_runs_no_collective_and_one_rank_group_is_exact(
        runs, tmp_path, monkeypatch):
    """`group=None` is the one-rank renderer: it calls no collective; a
    process group of world size 1 runs the split program and gives the
    same frame bit for bit, rounds and samples too."""
    _, params, one, _ = runs

    def refuse(*a, **k):
        raise AssertionError("a collective without a group")

    with monkeypatch.context() as m:
        m.setattr(dist, "all_gather", refuse)
        m.setattr(dist, "broadcast", refuse)
        again = {case: W.render(params, case) for case in W.CASES}
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        grouped = {case: W.render(params, case, dist.group.WORLD)
                   for case in W.CASES}
    finally:
        dist.destroy_process_group()
    for case in W.CASES:
        for res in (again[case], grouped[case]):
            for k in ("rgb", "depth", "opacity"):
                np.testing.assert_array_equal(res[k], one[case][k])
            for k in ("rounds", "total_samples", "alive_rays"):
                assert res[k] == one[case][k]
        assert grouped[case]["collectives"] > 0


def _eval_cmd(slim, *extra):
    return [sys.executable, "-m", "ngp_pl_torch.eval", "--device", "cpu",
            "--weight_path", slim, "--downsample", "0.125", "--n_levels",
            "4", "--log2_hashmap_size", "12", "--max_images", "2",
            "--fps_frames", "1", *extra]


def _eval_lines(out):
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


@pytest.fixture(scope="module")
def eval_one(tmp_path_factory):
    """(a slim checkpoint of a seeded L=4 field on a grid 30% occupied,
    the eval CLI's lines at one rank on it)."""
    tmp = tmp_path_factory.mktemp("eval")
    cfg = NGPConfig(scale=0.5, n_levels=4, n_features_per_level=4,
                    log2_hashmap_size=12)
    params = NGP(cfg, seed=3, device="cpu").params_numpy()
    params["hash_table"] = params["hash_table"] * 1e4
    occ = (np.random.default_rng(0).random((1, 128, 128, 128)) < 0.3)
    slim = str(tmp / "slim.npz")
    save_slim_checkpoint(slim, params=params, occ_grid=occ.astype(np.uint8))
    out = subprocess.run(_eval_cmd(slim), cwd=str(tmp), env=_env(),
                         capture_output=True, text=True, timeout=300)
    return slim, _eval_lines(out)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **kw)


def _same_readings(one, two):
    """The `test:` line equal, the `views:` and `render:` lines at the
    same size and samples per ray."""
    assert one[0].startswith("test: psnr=") and two[0] == one[0]
    views = r"views: [0-9.]+ FPS at (\d+x\d+) \(([0-9.]+) samples/ray"
    render = r"render: [0-9.]+ FPS at (\d+x\d+) \(([0-9.]+) samples/ray\)$"
    for pat, i in ((views, 1), (render, 2)):
        assert re.match(pat, one[i]).groups() == re.match(pat, two[i]).groups()


def test_eval_cli_over_two_ranks_prints_one_rank_scores(eval_one, tmp_path):
    """`python -m ngp_pl_torch.eval --device cpu --num_devices 2` prints
    the one-rank readings."""
    slim, one = eval_one
    out = subprocess.run(_eval_cmd(slim, "--num_devices", "2"),
                         cwd=str(tmp_path), env=_env(), capture_output=True,
                         text=True, timeout=300)
    _same_readings(one, _eval_lines(out))


def test_eval_multihost_from_the_environment(eval_one, tmp_path):
    """Two `--multihost` processes joined through RANK, WORLD_SIZE, ...:
    rank 0 alone prints, the one-rank readings."""
    slim, one = eval_one
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        _eval_cmd(slim, "--multihost"), cwd=str(tmp_path),
        env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert outs[1][0] == ""
    _same_readings(one, outs[0][0].strip().splitlines())
