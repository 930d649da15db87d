"""On the card only: K9, the six encode ablations (csrc/
encode_ablations.cu), against their plain version run on the card, within
1e-5 of max |h1| and of max |ft2| (K9_TOL of chip_smoke.py: the kernel
rounds where the plain version does and sums exact bf16 products on the
tensor cores, so only the order of the f32 sums differs; stream sums in
the plain version's order and must match it exactly), where the
persistent grid, the ring, the fragment layout and the decode could go
wrong: N = 128 (one item), 256 and 128 x 1,537 (more tiles than blocks, a
ragged last round), L = 1, 3, 8 and 16, full_il at two blocks bn, rows
holding every f16 pattern (exponent 31 and subnormals included) in both
halves of a word, and the kernel's w1 pack against `pack_w1_layout`.
Each launch counts once.

    python -m pytest -m cuda --noconftest tests/test_torch_encode_ablations_cuda.py
"""
import numpy as np
import pytest
import torch

K9_TOL = 1e-5
VARIANTS = ("full", "no_decode", "no_wrow", "no_ft", "stream", "full_il")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from ngp_pl_torch.device import resolve_device

    resolve_device("cuda")


def _inputs(variant, L, n, seed):
    """Rows on the card: the bench's random u32 words, or f32 U(-2, 2) bits
    for the variants that read them as f32; meta_T and w1big U[0, 1)."""
    rng = np.random.default_rng(seed)
    if variant in ("no_decode", "stream"):
        rows = rng.uniform(-2, 2, (L, n, 64)).astype(np.float32).view(
            np.int32)
    else:
        rows = rng.integers(0, 2 ** 32, (L, n, 64)).astype(np.uint32).view(
            np.int32)
    meta_T = rng.random((L, 4, n)).astype(np.float32)
    w1big = rng.random((L, 128, 64)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (rows, meta_T, w1big)]


def _check(variant, rows, meta_T, w1big, bn):
    from ngp_pl_torch.ops import encode_ablations as ea

    if variant == "full_il":
        rows = ea.interleave(rows, bn)
    n0 = ea.CUDA[variant].launches
    got = ea.encode_ablation(variant, rows, meta_T, w1big, bn)
    assert ea.CUDA[variant].launches == n0 + 1
    ref = ea.encode_ablation_plain(variant, rows, meta_T, w1big)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= K9_TOL * scale if scale else err == 0.0
    if variant in ("no_ft", "stream"):
        assert bool((got[1] == 0).all())
    if variant == "stream":
        assert torch.equal(got[0], ref[0])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 3, 8, 16])
@pytest.mark.parametrize("n", [128, 256, 128 * 1537])
@pytest.mark.parametrize("variant", VARIANTS)
def test_k9_variant_matches_plain(variant, n, L):
    _card()
    bn = 128 if n == 128 * 1537 else n
    _check(variant, *_inputs(variant, L, n, seed=L * 7 + n % 1000), bn)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 4096])
def test_k9_full_il_blocks(bn):
    """The interleaved layout at two blocks, N = 12,288 (3 blocks of
    4,096, 96 of 128)."""
    _card()
    _check("full_il", *_inputs("full_il", 8, 12288, seed=bn), bn)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_wrow", "no_ft", "full_il"])
def test_k9_decodes_every_half_pattern(variant):
    """Rows whose low halves run through all 65,536 f16 patterns and whose
    high halves hold them in another order: exponent 31 (2^16 (1 + m/1024)
    sign, not inf or NaN), subnormals and signed zeros, in both lanes of a
    word."""
    _card()
    L, n = 8, 256
    h = np.arange(L * n * 64, dtype=np.uint32) % 65536
    hi = np.random.default_rng(9).permutation(h)
    rows = (h | (hi << 16)).view(np.int32).reshape(L, n, 64)
    _, meta_T, w1big = _inputs(variant, L, n, seed=10)
    got = _check(variant, torch.from_numpy(rows).cuda(), meta_T, w1big, 128)
    assert float(got[0].abs().max()) > 2.0 ** 16


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 16])
def test_k9_pack_matches_layout(L):
    """The kernels' w1 pack, bit for bit, against `pack_w1_layout`."""
    _card()
    from ngp_pl_torch.ops import encode_ablations as ea

    w1big = _inputs("full", L, 128, seed=L)[2] * 4.0 - 2.0
    got = ea.pack_w1_cuda(w1big).cpu()
    want = ea.pack_w1_layout(w1big.cpu()).reshape(-1).view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k9_wrappers_refuse_cpu_tensors():
    _card()
    from ngp_pl_torch.ops import encode_ablations as ea

    rows, meta_T, w1big = (t.cpu() for t in _inputs("full", 1, 128, seed=0))
    for v in VARIANTS:
        with pytest.raises(ValueError):
            ea.CUDA[v](rows, meta_T, w1big, 128)
