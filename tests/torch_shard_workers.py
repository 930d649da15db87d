"""Rank bodies and inputs of tests/test_torch_shard_frame.py: one frame's
rays split over gloo ranks (`RoundRenderer(group=...)`).

A spawned rank imports the function it runs by name, so the bodies live
here, in a module that imports only numpy, torch and the port.  Each rank
writes what it rendered to <out>/frame_rank<r>.pt; `render` without a
group gives the one-rank frame.

Sizes: grid 32, L=4, F=4, T=2^12, chunk 256; the shapes of
tests/test_parallel.py's sharded renderer test and of
tests/test_torch_render.py's round renderer test.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ngp_pl_torch.config import NGPConfig, RenderConfig
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.rendering import RoundRenderer

G = 32
CHUNK = 256
# case: (scale, rays, the renderer's keywords)
CASES = {
    # the span pass and two chunks
    "spanned": (0.5, 512, {}),
    # tests/test_torch_render.py::test_round_renderer_matches_jax's rays
    "render_test_rays": (0.5, 300, {}),
    # a last chunk of 13 alive rays, split 7 and 6
    "short_last_chunk": (0.5, 333, {}),
    # a first bucket of 128 slots under 256 alive rays: the first 128 in
    # ray order across the ranks, so rank 1 takes none in that round
    "buckets": (0.5, 512, {"buckets": [(128, 8, 64), (64, 16, 128)]}),
    # scale 2: three cascades, exponential steps, no span pass; 2.5 chunks
    # of consecutive rays, the last padded (its real rays all on rank 0)
    "unspanned": (2.0, 640, {}),
}


def model_kw(scale: float) -> dict:
    return dict(scale=scale, n_levels=4, n_features_per_level=4,
                log2_hashmap_size=12, grid_size=G)


def scene(case: str):
    """(occ_grid, rays_o, rays_d) numpy of a case: at scale 0.5 a grid 30%
    occupied with an empty slab, rays from one camera with 8 pointing
    away (tests/test_torch_render.py); at scale 2 three nested boxes and
    rays along +z (tests/test_torch_multicascade.py)."""
    scale, n, _ = CASES[case]
    if scale <= 0.5:
        rng = np.random.default_rng(0)
        occ = (rng.random((1, G, G, G)) < 0.3).astype(np.uint8)
        occ[:, :6] = 0
        rng = np.random.default_rng(0)
        cam = np.array([0.2, -1.4, 0.5], np.float32)
        fwd = -cam / np.linalg.norm(cam)
        rd = (rng.normal(size=(n, 3)) * 0.25 + fwd).astype(np.float32)
        rd[:8] = -rd[:8]
        ro = np.tile(cam, (n, 1)).astype(np.float32)
        return occ, ro, rd
    occ = np.zeros((3, G, G, G), np.uint8)
    occ[0, 8:24, 8:24, 8:24] = 1
    occ[1, 12:20, 12:20, 12:20] = 1
    occ[2, 10:22, 10:22, 14:18] = 1
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)) * np.array([0.3, 0.3, 0.1]) + [0, 0, 1.0]
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.tile(np.array([[0.1, -0.05, -5.0]], np.float32), (n, 1))
    return occ, ro, rd


def render(params: dict, case: str, group=None) -> dict:
    """The case's frame through `RoundRenderer(group=group)` with `params`
    (by scale); each round's (bucket slots, global alive rays, this rank's
    rows) is recorded under "rows"."""
    scale, _, kw = CASES[case]
    ngp = NGP(NGPConfig(**model_kw(scale)), device="cpu")
    ngp.load_params(params[scale])
    occ, ro, rd = (torch.from_numpy(a) for a in scene(case))
    rows = []
    renderer = RoundRenderer(ngp, RenderConfig(), chunk=CHUNK, group=group,
                             **kw)
    out = renderer.render_image(
        occ, ro, rd, on_round=lambda bucket, n_alive, valid, n_eff:
        rows.append((bucket[0], n_alive, valid.shape[0])))
    return {**{k: out[k].numpy() for k in ("rgb", "depth", "opacity")},
            **{k: out[k] for k in ("total_samples", "rounds", "alive_rays")},
            "rows": rows, "collectives": renderer.collectives}


def suite(out: str, params: dict) -> None:
    """Every case split over the ranks of the default group."""
    res = {case: render(params, case, dist.group.WORLD) for case in CASES}
    torch.save(res, os.path.join(out, f"frame_rank{dist.get_rank()}.pt"))
