"""Port parity for K6, the row scatter-add: the plain version
(`scatter_rows_plain`, the dispatcher's CPU path) against the JAX package's
`scatter_accum` run in interpret mode on the CPU, on indices outside
[0, R) (which `scatter_accum` clips to [0, R - 1], and the port clamps) and
on the ray-coherent runs of the JAX scatter bench.

Inputs are made with numpy from a seed and fed to both packages.  Tolerance:
1e-5 of the largest magnitude of the JAX result (f32 sums in another order;
K6_TOL of chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ngp_pl_tpu.ops.scatter_accum import scatter_accum
from ngp_pl_torch.benchmarking.bench_inputs import runs_pattern
from ngp_pl_torch.ops import scatter_rows as tsr

torch.set_num_threads(2)

TOL = 1e-5
R = 64


def _jax(d, idx, n_rows):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(scatter_accum(jnp.asarray(d),
                                        jnp.asarray(idx.astype(np.int32)),
                                        n_rows=n_rows, block=256))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _outside(kind, rng, P):
    """Indices in [0, R) with some outside: below 0, at or above R, or
    both, including the extremes of int32."""
    idx = rng.integers(0, R, P)
    k = P // 8
    if kind in ("negative", "both"):
        idx[:k] = rng.integers(-3 * R, 0, k)
        idx[k] = -2 ** 31
    if kind in ("at_or_above", "both"):
        idx[-k:] = rng.integers(R, 4 * R, k)
        idx[-k - 1] = R
        idx[-k - 2] = 2 ** 31 - 1
    return rng.permutation(idx)


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("kind", ["negative", "at_or_above", "both"])
def test_plain_k6_clamps_as_scatter_accum_clips(kind, W):
    """Rows whose index lies outside [0, R) land on row 0 or row R - 1, as
    in `scatter_accum` (its `jnp.clip`), not dropped and not an error."""
    rng = np.random.default_rng(W + len(kind))
    P = 512
    d = rng.normal(size=(P, W)).astype(np.float32)
    idx = _outside(kind, rng, P)
    ref = _jax(d, idx, R)
    got = tsr.scatter_rows(torch.from_numpy(d), torch.from_numpy(idx), R)
    assert got.shape == (R, W)
    assert _rel(got.numpy(), ref) <= TOL
    # the clamped rows are really there: dropping them would miss by a row
    lost = d[(idx < 0) | (idx >= R)].sum(0)
    edge = (0 if kind == "negative" else R - 1)
    assert np.abs(lost).max() > 100 * TOL * np.abs(ref).max()
    assert np.abs(got.numpy()[edge] - ref[edge]).max() <= TOL * np.abs(
        ref).max()


def test_plain_k6_matches_scatter_accum_on_ray_coherent_runs():
    """The JAX scatter bench's pattern (runs of 74 equal indices into 512
    rows), cut to 2,048 rows of 128: the contention case of the kernel."""
    rng = np.random.default_rng(0)
    P, W, n_rows = 2048, 128, 512
    d = rng.normal(size=(P, W)).astype(np.float32)
    idx = runs_pattern(rng, P, n_rows, 74)
    assert (np.diff(idx) != 0).sum() <= -(-P // 74)
    ref = _jax(d, idx, n_rows)
    got = tsr.scatter_rows(torch.from_numpy(d), torch.from_numpy(idx),
                           n_rows)
    assert _rel(got.numpy(), ref) <= TOL


def test_cpu_dispatch_clamps_and_counts_no_launch():
    """On CPU tensors the dispatcher runs the plain version (no launch)
    and clamps; `index_add_` itself would raise on these indices."""
    rows = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([-2, 0, 5, 2])
    n0 = tsr.scatter_rows_cuda.launches
    out = tsr.scatter_rows(rows, idx, 3)
    assert tsr.scatter_rows_cuda.launches == n0
    want = torch.zeros(3, 3)
    want[0] = rows[0] + rows[1]
    want[2] = rows[2] + rows[3]
    assert torch.equal(out, want)
    with pytest.raises((IndexError, RuntimeError)):
        torch.zeros(3, 3).index_add_(0, idx, rows)
