"""Port parity for K9, the encode-forward ablation bench: the plain version
of each variant (ngp_pl_torch/ops/encode_ablations.py) against the Pallas
bodies of benchmarking/micro_pallas_fwd.py run in interpret mode on the
CPU, the decoder and lane constants against the JAX package's, and the
port's bench entry point.

Sizes: L=8, N=256, bn=128 (the bench's widths: rows of 64 u32 words, 128
lanes, H=64, F=4).  Inputs are made with numpy from a seed and fed to both
packages: the bench's random rows, except for the variants that read the
rows' bits as f32 (no_decode, stream), where those rows hold inf and NaN
patterns; they get the bits of f32 U(-2, 2) instead.  Errors are normalised
by the largest magnitude of the JAX result."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ngp_pl_tpu.ops import hash_encoding_pallas as jhp
from ngp_pl_torch.benchmarking import micro_fwd
from ngp_pl_torch.ops import encode_ablations as ea

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, N, BN = 8, 256, 128
TOL = 1e-5          # of max |h1| and of max |ft2|: f32 sums in another order


def _micro():
    """benchmarking/micro_pallas_fwd.py, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        "micro_pallas_fwd", os.path.join(REPO, "benchmarking",
                                         "micro_pallas_fwd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


micro = _micro()
BODIES = {"full": micro.full_kernel, "no_decode": micro.no_decode_kernel,
          "no_wrow": micro.no_wrow_kernel, "no_ft": micro.no_ft_kernel,
          "stream": micro.stream_kernel, "full_il": micro.full_kernel_il}


def _inputs(variant, seed=0):
    """rows (L, N, 64) u32, meta_T (L, 4, N) and w1big (L, 128, 64) f32."""
    rng = np.random.default_rng(seed)
    if variant in ("no_decode", "stream"):
        rows = rng.uniform(-2, 2, (L, N, 64)).astype(np.float32).view(
            np.uint32)
    else:
        rows = rng.integers(0, 2 ** 31, (L, N, 64), dtype=np.int64).astype(
            np.uint32)
    meta_T = rng.random((L, 4, N)).astype(np.float32)
    w1big = rng.random((L, 128, 64)).astype(np.float32)
    return rows, meta_T, w1big


def _interleave(rows):
    return np.ascontiguousarray(
        rows.reshape(L, N // BN, BN, 64).transpose(1, 0, 2, 3))


def _pallas(body, rows, meta_T, w1big, il):
    """The bench's pallas_call around one body, interpreted, returning h1
    and ft2 apart (the bench returns only their sum)."""
    tab, sel = micro.lane_table(4, 128), micro.feat_selector(4, 128)
    rows_spec = (pl.BlockSpec((1, 1, BN, 64), lambda n, l: (n, l, 0, 0))
                 if il else pl.BlockSpec((1, BN, 64), lambda n, l: (l, n, 0)))
    with pltpu.force_tpu_interpret_mode():
        h1, ft2 = pl.pallas_call(
            body, grid=(N // BN, L),
            in_specs=[rows_spec,
                      pl.BlockSpec((1, 4, BN), lambda n, l: (l, 0, n)),
                      pl.BlockSpec((1, 128, 64), lambda n, l: (l, 0, 0)),
                      pl.BlockSpec((8, 64), lambda n, l: (0, 0)),
                      pl.BlockSpec((8, 64), lambda n, l: (0, 0)),
                      pl.BlockSpec((64, 4), lambda n, l: (0, 0)),
                      pl.BlockSpec((64, 4), lambda n, l: (0, 0))],
            out_specs=[pl.BlockSpec((BN, 64), lambda n, l: (n, 0)),
                       pl.BlockSpec((1, 4, BN), lambda n, l: (l, 0, n))],
            out_shape=[jax.ShapeDtypeStruct((N, 64), jnp.float32),
                       jax.ShapeDtypeStruct((L, 4, N), jnp.float32)],
            interpret=True,
        )(jnp.asarray(rows), jnp.asarray(meta_T), jnp.asarray(w1big),
          jnp.asarray(tab[:, :64]), jnp.asarray(tab[:, 64:]),
          jnp.asarray(sel[:64]), jnp.asarray(sel[64:]))
    return np.asarray(h1), np.asarray(ft2)


def _plain(variant, rows, meta_T, w1big):
    h1, ft2 = ea.encode_ablation(
        variant, torch.from_numpy(rows.view(np.int32)),
        torch.from_numpy(meta_T), torch.from_numpy(w1big), BN)
    return h1.numpy(), ft2.numpy()


def _within(got, ref, tol=TOL):
    """max |got - ref| <= tol * max |ref| (exact when ref is all zeros)."""
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    return float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


@pytest.mark.parametrize("variant", ea.VARIANTS)
def test_plain_variant_matches_interpreted_pallas_body(variant):
    """h1 and ft2 of each variant's plain version against its Pallas body:
    the same rounding points (bf16 weighted row values, bf16 w1, f32
    lane weights with no bf16 rounding); only the f32 sums run in another
    order.  Tolerance 1e-5 of max, as the card holds the kernel to the
    plain version."""
    rows, meta_T, w1big = _inputs(variant)
    il = variant == "full_il"
    h_j, ft_j = _pallas(BODIES[variant], _interleave(rows) if il else rows,
                        meta_T, w1big, il)
    h_t, ft_t = _plain(variant, _interleave(rows) if il else rows, meta_T,
                       w1big)
    assert _within(h_t, h_j) and _within(ft_t, ft_j)
    if variant in ("no_ft", "stream"):
        assert (ft_t == 0).all() and (ft_j == 0).all()
    else:
        assert np.abs(ft_j).max() > 0
    if variant == "stream":        # the same sequential f32 sum
        np.testing.assert_array_equal(h_t, h_j)


@pytest.mark.parametrize("variant", ea.VARIANTS)
def test_bench_call_matches_plain(monkeypatch, variant):
    """Through the bench's own `make_variant` (and
    `make_variant_interleaved`) at N=256, bn=128: its h1.sum() + ft2.sum()
    against the plain version's, within 1e-5 of the sum of magnitudes (the
    sums themselves run in another order)."""
    monkeypatch.setattr(micro, "N", N)
    monkeypatch.setattr(micro, "bn", BN)
    rows, meta_T, w1big = _inputs(variant, seed=1)
    if variant == "full_il":
        rows = _interleave(rows)
        fn = micro.make_variant_interleaved(BODIES[variant], BN)
    else:
        fn = micro.make_variant(BODIES[variant])
    with pltpu.force_tpu_interpret_mode():
        got = float(fn(jnp.asarray(rows), jnp.asarray(meta_T),
                       jnp.asarray(w1big)))
    h1, ft2 = _plain(variant, rows, meta_T, w1big)
    ref = float(h1.astype(np.float64).sum() + ft2.astype(np.float64).sum())
    scale = float(np.abs(h1).sum() + np.abs(ft2).sum())
    assert abs(got - ref) <= TOL * scale


def test_f16_decoder_bit_equal_on_every_pattern():
    """All 65,536 f16 bit patterns, alone and under random high halves,
    bit-equal to the JAX decoder: subnormals and signed zeros exact, and
    exponent 31 finite (2^16 * (1 + m/1024) * sign), unlike f16 itself."""
    h = np.arange(65536, dtype=np.uint32)
    hi = np.random.default_rng(2).integers(0, 65536, 65536).astype(
        np.uint32) << 16
    for words in (h, h | hi):
        ref = np.asarray(jhp.f16_bits_to_f32(jnp.asarray(words)))
        got = ea.f16_bits_to_f32(torch.from_numpy(words.view(np.int32)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      ref.view(np.uint32))
    assert np.isfinite(got.numpy()).all()
    assert float(got[0x7C00]) == 2.0 ** 16          # f16 inf's bits
    assert float(got[0x0001]) == 2.0 ** -24         # smallest subnormal


def test_lane_constants_equal_jax():
    np.testing.assert_array_equal(ea.lane_table(), jhp.lane_table(4, 128))
    np.testing.assert_array_equal(ea.feat_selector(),
                                  jhp.feat_selector(4, 128))


def test_entry_point_on_cpu(capsys, monkeypatch):
    """`python -m ngp_pl_torch.benchmarking.micro_fwd --device cpu` at N=256
    (one timed call per row): one JSON line per row, host times under
    `cpu_ms` (never `ms`), bounds from the shapes, no launches."""
    monkeypatch.setattr(micro_fwd, "RUNS", 1)
    monkeypatch.setattr(micro_fwd, "WARMUP", 0)
    recs = micro_fwd.main(["--device", "cpu", "--n", str(N), "--bn",
                           str(BN), "--interleaved"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [r["row"] for r in recs] == [
        "full", "no_decode", "no_wrow", "no_ft", "stream", "full_il",
        "gather_il", "k1"]
    for r in recs:
        assert r["device"] == "cpu" and "ms" not in r and r["cpu_ms"] > 0
        assert r["launches"] == 0 and r["bound_by"] == "bytes"
    full = recs[0]
    assert full["bytes"] == (L * N * 64 * 4 + L * 3 * N * 4
                             + L * 128 * 64 * 4 + N * 64 * 4 + L * 4 * N * 4)
    assert recs[2]["bytes"] < full["bytes"] and recs[4]["bytes"] < recs[2][
        "bytes"]


def test_entry_point_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        micro_fwd.main(["--n", str(N)])


def test_wrapper_refuses_cpu_only_shapes():
    """The kernel's contract, checked before the device: int32 rows,
    N a multiple of 128, and for full_il of bn."""
    rows, meta_T, w1big = (torch.from_numpy(a.view(np.int32) if a.dtype ==
                                            np.uint32 else a)
                           for a in _inputs("full"))
    with pytest.raises(ValueError, match="multiple of 128"):
        ea.CUDA["full"](rows[:, :200], meta_T[..., :200], w1big)
    with pytest.raises(ValueError, match="rows"):
        ea.CUDA["full"](rows.float(), meta_T, w1big)
    with pytest.raises(ValueError, match="bn"):
        ea.CUDA["full_il"](rows, meta_T, w1big, 96)
    with pytest.raises(ValueError, match="CUDA device"):
        ea.CUDA["full"](rows, meta_T, w1big)

