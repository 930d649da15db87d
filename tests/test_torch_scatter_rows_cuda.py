"""On the card only: K6, the row scatter-add (csrc/scatter_rows.cu), against
its plain version run on the CPU (a clamped `index_add_`), within 1e-5 of
max (K6_TOL of chip_smoke.py: the kernel's reductions add in another order
than the plain version, and a run of equal indices is summed before it is
reduced), on the inputs where its segments of 16 rows, its batches of 8,
its vector and scalar reductions and its runs could go wrong: ragged P (0,
1, 31, 4,097), W = 3 and 130 (scalar reductions), 64 and 128 (float4),
a misaligned view (scalar), indices outside [0, R) (clamped), every row on
one index, and the JAX scatter bench's runs of 74.  Each launch counts
once.

    python -m pytest -m cuda --noconftest tests/test_torch_scatter_rows_cuda.py
"""
import numpy as np
import pytest
import torch

K6_TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")


def _check(rows, idx, R):
    """The kernel on the card against the plain version on the CPU."""
    from ngp_pl_torch.ops import scatter_rows as sr

    n0 = sr.scatter_rows_cuda.launches
    got = sr.scatter_rows(rows.cuda(), idx.cuda(), R)
    assert sr.scatter_rows_cuda.launches == n0 + (
        1 if rows.shape[0] and rows.shape[1] else 0)
    ref = sr.scatter_rows_plain(rows.cpu(), idx.cpu(), R)
    got = got.cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    assert float((got - ref).abs().max()) <= K6_TOL * scale if scale else (
        bool((got == 0).all()))
    return got


def _rows(P, W, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(P, W)).astype(np.float32)), rng


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 64, 128, 130])
@pytest.mark.parametrize("P", [1, 31, 4097])
def test_k6_ragged_rows_and_widths(P, W):
    _card()
    rows, rng = _rows(P, W, P * 1000 + W)
    _check(rows, torch.from_numpy(rng.integers(0, 37, P)), 37)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 128])
def test_k6_clamps_indices_outside(W):
    """Negative indices land on row 0, indices >= R on row R - 1, as
    `scatter_accum` clips them; none is dropped."""
    _card()
    P, R = 4097, 40
    rows, rng = _rows(P, W, 7 + W)
    idx = rng.integers(-2 * R, 3 * R, P)
    idx[:2] = [-2 ** 62, 2 ** 62]
    got = _check(rows, torch.from_numpy(idx), R)
    low = rows[torch.from_numpy(idx <= 0)].sum(0)
    high = rows[torch.from_numpy(idx >= R - 1)].sum(0)
    assert torch.allclose(got[0], low, rtol=1e-5, atol=1e-4)
    assert torch.allclose(got[R - 1], high, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 130])
def test_k6_every_row_on_one_index(W):
    """One run over all rows: every warp sums its segment and reduces
    once, all on one output row."""
    _card()
    rows, _ = _rows(4097, W, 11)
    got = _check(rows, torch.full((4097,), 5, dtype=torch.int64), 8)
    assert bool((got[:5] == 0).all()) and bool((got[6:] == 0).all())


@pytest.mark.cuda
def test_k6_ray_coherent_runs():
    """The JAX scatter bench's pattern at its full size: 327,680 rows of
    128 into 512 rows, runs of 74 equal indices."""
    _card()
    from ngp_pl_torch.benchmarking.bench_inputs import k6_runs

    rows, idx, R = k6_runs("cpu")
    _check(rows, idx, R)


@pytest.mark.cuda
def test_k6_misaligned_rows_take_scalar_reductions():
    """A view of rows that starts 4 bytes past a 16-byte boundary, W = 128:
    the kernel reads it with scalar loads and reductions."""
    _card()
    from ngp_pl_torch.ops import scatter_rows as sr

    rows, rng = _rows(1025, 129, 13)
    view = rows.cuda()[:, 1:]
    assert not view.is_contiguous()
    flat = torch.empty(1024 * 128 + 1, device="cuda")
    mis = flat[1:].view(1024, 128)
    mis.copy_(view[:1024])
    assert mis.data_ptr() % 16 == 4
    idx = torch.from_numpy(rng.integers(0, 64, 1024))
    n0 = sr.scatter_rows_cuda.launches
    got = sr.scatter_rows_cuda(mis, idx.cuda(), 64).cpu()
    assert sr.scatter_rows_cuda.launches == n0 + 1
    ref = sr.scatter_rows_plain(mis.cpu(), idx, 64)
    assert float((got - ref).abs().max()) <= K6_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_k6_no_rows():
    """P = 0: zeros, no launch."""
    _card()
    got = _check(torch.empty((0, 128)), torch.empty((0,), dtype=torch.int64),
                 16)
    assert got.shape == (16, 128)
