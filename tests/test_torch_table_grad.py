"""The table gradient (K2+K5 at F=4, K4 at F=2) on the CPU: what its kernels
may change and what their design counts.

- The plain version is invariant under a permutation of the samples within
  1e-5 of max (the card's K2_TOL): only the order of its f32 sums changes,
  which is all the kernels' merged and reordered reductions may change.
- On a ray-ordered train pool of the port's own train step (few cells per
  ray on the coarse levels, zero rows on the unused slots), the plain
  version matches the JAX package's `_encode_mlp_pl_cv` backward
  (interpreted Pallas kernel + per-level scatters) within 1e-5 of max.
- `table_grad_inputs.capture` hands back the step's own (x, g, w1).
- `table_grad_probe.merged_levels` and `design_reductions`, the levels the
  kernel merges (from its `kMergeMaxRes`) and the count of reductions its
  issue rule gives, on inputs whose count is known.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from ngp_pl_torch.benchmarking import table_grad_inputs as tgi
from ngp_pl_torch.benchmarking import table_grad_probe as probe
from ngp_pl_torch.benchmarking.train_setup import train_config, train_system
from ngp_pl_torch.ops import hash_encoding as the
from ngp_pl_tpu.ops import hash_encoding as jhe
from tests.table_grad_pool import SmallTrainConfig, train_pool

torch.set_num_threads(2)

K2_TOL = 1e-5
# two dense levels (8 and 64 bricks) and two hashed ones (128 slots)
SPEC_KW = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4,
               per_level_scale=2.0)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("F", [4, 2])
@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 700))
def test_plain_table_grad_is_invariant_under_sample_order(F, seed, n):
    """Random points, a third of them on one point (merged on every level)
    and a sixth with zero rows; the same gradient with the samples in a
    random order, within K2_TOL of max."""
    spec = the.make_grid_spec(n_features=F, **SPEC_KW)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[: n // 3] = x[0]
    g = rng.normal(0, 1, (n, 64)).astype(np.float32)
    g[rng.random(n) < 1 / 6] = 0.0
    w1 = rng.normal(0, 0.3, (spec.out_dim, 64)).astype(np.float32)
    perm = rng.permutation(n)
    d = the.hash_encode_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                  torch.from_numpy(w1), spec)
    d_perm = the.hash_encode_bwd_plain(torch.from_numpy(x[perm]),
                                       torch.from_numpy(g[perm]),
                                       torch.from_numpy(w1), spec)
    scale = float(d.abs().max())
    assert float((d - d_perm).abs().max()) <= K2_TOL * scale


@pytest.mark.parametrize("F", [4, 2])
def test_plain_table_grad_on_a_train_pool_matches_jax(F):
    """The port's own train step's pool (`tests/table_grad_pool.py`): ray
    by ray, ~16 samples per level-0 cell, half the slots unused.  Against
    the vjp of the JAX package's `_encode_mlp_pl_cv` (the interpreted
    Pallas backward, then the per-level scatter-adds) with the same g,
    within K2_TOL of max."""
    x, g, w1, spec = train_pool(F)
    nonzero = (g != 0).any(dim=1)
    slot, local, _ = the.slots_local_frac_lm(x, spec)
    cells0 = torch.unique((slot[0] * 8 + (local[0] * torch.tensor(
        [4, 2, 1])).sum(-1))[nonzero]).numel()
    assert 0 < int(nonzero.sum()) < x.shape[0] and not bool(nonzero[-1])
    assert cells0 * 8 < int(nonzero.sum())          # duplicate-heavy
    cfg = SmallTrainConfig(n_levels=4, n_features=F,
                           log2_hashmap_size=12).ngp_config()
    spec_j = jhe.make_grid_spec(
        n_levels=cfg.n_levels, n_features=F,
        log2_hashmap_size=cfg.log2_hashmap_size,
        base_resolution=cfg.base_resolution,
        per_level_scale=cfg.per_level_scale)
    assert spec_j.offsets == spec.offsets and spec_j.sizes == spec.sizes
    table = jnp.zeros((spec_j.total_rows, spec_j.row_width), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda t: jhe._encode_mlp_pl_cv(
            spec_j, 128, jnp.asarray(x.numpy()), t,
            jnp.asarray(w1.numpy())), table)
        (d_ref,) = vjp(jnp.asarray(g.numpy()))
    d = the.hash_encode_bwd_plain(x, g, w1, spec)
    assert d.shape == d_ref.shape
    assert _rel(d.numpy(), d_ref) <= K2_TOL


@pytest.mark.parametrize("F", [4, 2])
def test_capture_hands_back_the_train_steps_input(F):
    """`capture` runs one ordinary step and returns what the table
    gradient received: the pool's positions (pool slots x 3, in the unit
    cube), their h1 gradients (x 64, zero on the unused slots at the
    pool's end) and the model's first-layer weight."""
    tcfg = SmallTrainConfig(batch_size=64, n_levels=4, n_features=F,
                            log2_hashmap_size=12, num_epochs=1)
    system = train_system(tcfg, dev="cpu", img_size=16, n_train=2)
    w1_before = system.ngp.sigma_mlp[0].detach().clone()
    x, g, w1 = tgi.capture(system)
    P = tcfg.batch_size * system._pool_mult
    assert x.shape == (P, 3) and g.shape == (P, 64)
    assert w1.shape == (4 * F, 64)
    assert x.dtype == g.dtype == w1.dtype == torch.float32
    assert x.is_contiguous() and g.is_contiguous()
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    assert torch.equal(w1, w1_before)
    assert system._host_step == 1
    assert not system.ngp.sigma_mlp[0].detach().equal(w1_before)  # stepped


@pytest.mark.parametrize("F", [4, 2])
def test_design_reductions_count(F):
    """Per cell 8 reductions at F=4 (a v4 per corner) and 6 at F=2 (two
    aligned z-pairs as v4, four v2): once per nonzero sample, or once per
    cell among a warp's nonzero samples on the merged levels (all four
    levels of this grid: R = 4 ... 32)."""
    spec = the.make_grid_spec(n_features=F, **SPEC_KW)
    assert all(probe.merged_levels(spec))
    per_cell = 8 if F == 4 else 6
    g = torch.ones((96, 64))
    same = torch.full((96, 3), 0.3)
    assert probe.design_reductions(same, g, spec) == 3 * 4 * per_cell
    spread = torch.stack([torch.arange(96) / 96.0] * 3, dim=1)
    assert probe.design_reductions(spread, g, spec) == sum(
        len(set(zip(*(torch.floor(spread[w:w + 32] * r).T.tolist()))))
        for r in spec.resolutions for w in (0, 32, 64)) * per_cell
    g[::2] = 0.0
    g[0, 5] = -0.0
    assert probe.design_reductions(same, g, spec) == 3 * 4 * per_cell
    g[:] = 0.0
    assert probe.design_reductions(same, g, spec) == 0


@pytest.mark.parametrize("geometry,merged", [
    (dict(n_levels=8, n_features=4), 5), (dict(n_levels=16, n_features=2),
                                          11)])
def test_merged_levels_are_the_coarse_ones(geometry, merged):
    """The two geometries on the card, under the kernel's kMergeMaxRes
    (256): L8F4 merges R = 16 ... 172, L16F2 R = 16 ... 255; the finer
    levels are left to one lane per cell."""
    assert probe.merge_max_res() == 256
    cfg = train_config(**geometry).ngp_config()
    spec = the.make_grid_spec(cfg.n_levels, cfg.n_features_per_level,
                              cfg.log2_hashmap_size, cfg.base_resolution,
                              cfg.per_level_scale)
    flags = probe.merged_levels(spec)
    assert flags == (True,) * merged + (False,) * (cfg.n_levels - merged)
    assert max(r for r, f in zip(spec.resolutions, flags) if f) <= 256


def test_bwd_wrapper_refuses_a_gradient_past_int32_indices():
    """The kernels index the table gradient with 32-bit ints."""
    spec = dataclasses.replace(the.make_grid_spec(n_features=4, **SPEC_KW),
                               offsets=(0, 8, 72, 2 ** 24),
                               sizes=(8, 64, 128, 128))
    x = torch.zeros((4, 3))
    g = torch.zeros((4, 64))
    w1 = torch.zeros((16, 64))
    with pytest.raises(ValueError, match="32-bit"):
        the.hash_encode_bwd_cuda(x, g, w1, spec)
