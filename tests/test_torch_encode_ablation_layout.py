"""K9, the encode ablations, on the CPU: the decode, the w1 pack and the
summation order of the kernel's tensor-core design (csrc/
encode_ablations.cu), against the plain version
(`encode_ablation_plain`, itself held to the JAX bench's Pallas bodies in
tests/test_torch_encode_ablations.py).

- The decode: moving a half's sign to bit 31 and its exponent and mantissa
  to bits 13..27 gives an f32 of value dec(h) * 2^-112, where dec is the
  TPU's integer decoder (`f16_bits_to_f32`); times w * 2^112 it rounds to
  the same f32 as dec(h) * w, bit for bit, for all 65,536 patterns of
  either half of a word (subnormals, signed zeros and exponent 31
  included) and any lane weight w in [0, 1].
- The pack (`pack_w1_layout`, the order the kernel's pack writes) holds
  each bf16(w1big[l, lane, col]) exactly once.
- The contraction: A's columns given to the lanes as the kernel gives them
  (k-chunk 2 cp + h, column pair p: word 16 cp + 4 (p & 3) + 2 h + (p >> 2),
  its lanes j and j + 64), B's rows from the pack and ft2 from a 0/1
  selector; each chunk's products summed in f32, then over chunks and
  levels, agree with the plain version within K9_TOL (1e-5 of max), h1
  and ft2, for each contracting variant.
"""
import numpy as np
import pytest
import torch

from ngp_pl_torch.ops import encode_ablations as ea

torch.set_num_threads(2)

K9_TOL = 1e-5
SCALE = 2.0 ** 112
L, N = 3, 256


def scaled_halves(u: torch.Tensor):
    """The kernel's bit move: int64 words (u32 values) -> the f32 of each
    half, dec(h) * 2^-112 (lane j from the low half, j + 64 from the
    high)."""
    lo = ((u << 16) & 0x80000000) | ((u << 13) & 0x0FFFE000)
    hi = (u & 0x80000000) | ((u >> 3) & 0x0FFFE000)
    return tuple((b - ((b >> 31) << 32)).to(torch.int32).view(torch.float32)
                 for b in (lo, hi))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


WEIGHTS = {
    "one": np.ones(65536, np.float32),
    "zero": np.zeros(65536, np.float32),
    "random": np.random.default_rng(1).random(65536).astype(np.float32),
    # products that land among the f32 subnormals, or underflow to 0
    "tiny": (np.random.default_rng(2).random(65536) * 2.0 ** -120).astype(
        np.float32),
}


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
def test_scaled_decode_times_scaled_weight_is_bit_equal(kind):
    h = torch.arange(65536, dtype=torch.int64)
    other = torch.from_numpy(
        np.random.default_rng(3).integers(0, 65536, 65536))
    w = torch.from_numpy(WEIGHTS[kind])
    dec = ea.f16_bits_to_f32(h)
    ref = dec * w
    big = w * SCALE
    assert torch.equal(big / SCALE, w)            # the scaling is exact
    lo, _ = scaled_halves(h | (other << 16))
    _, hi = scaled_halves(other | (h << 16))
    for v in (lo, hi):
        np.testing.assert_array_equal(_bits(v * big), _bits(ref))
    if kind == "one":
        np.testing.assert_array_equal(_bits(lo * SCALE), _bits(dec))
        assert float((lo * SCALE)[0x7C00]) == 2.0 ** 16
        assert float((lo * SCALE)[0x8001]) == -(2.0 ** -24)


@pytest.mark.parametrize("levels", [1, 3])
def test_pack_holds_each_bf16_weight_once(levels):
    rng = np.random.default_rng(levels)
    w1big = torch.from_numpy(rng.normal(size=(levels, 128, 64)).astype(
        np.float32))
    p = ea.pack_w1_layout(w1big)
    assert p.dtype == torch.bfloat16 and p.numel() == levels * 128 * 64
    assert p.numel() * 2 == levels * ea.W1P_WORDS * 4   # 16 KB a level
    # unpack: b-fragment (kc, ntp, lane, q, half) -> (lane j + 64 half, col)
    kc, ntp, lane, q, e = torch.meshgrid(
        torch.arange(8), torch.arange(4), torch.arange(32), torch.arange(4),
        torch.arange(2), indexing="ij")
    j = 16 * (kc >> 1) + 4 * (lane & 3) + 2 * (kc & 1) + (q & 1) + 64 * e
    col = (2 * ntp + (q >> 1)) * 8 + (lane >> 2)
    flat = (j * 64 + col).reshape(-1)
    assert torch.equal(torch.sort(flat).values, torch.arange(128 * 64))
    un = torch.empty((levels, 128 * 64), dtype=torch.bfloat16)
    un[:, flat] = p.reshape(levels, -1)
    assert torch.equal(un.reshape(levels, 128, 64),
                       w1big.to(torch.bfloat16))


def _columns():
    """(8, 16) lane of each A column: chunk kc = 2 cp + h, column 2p + e."""
    lanes = torch.empty((8, 16), dtype=torch.int64)
    for kc in range(8):
        cp, h = kc >> 1, kc & 1
        for p in range(8):
            j = 16 * cp + 4 * (p & 3) + 2 * h + (p >> 2)
            lanes[kc, 2 * p], lanes[kc, 2 * p + 1] = j, j + 64
    return lanes


def _b_chunks(packed_l):
    """(8, 16, 64) f32 B of each k-chunk from one level's pack: lane (g, t)'s
    fragment q holds rows 2p, 2p + 1, p = t + 4 (q & 1), column 8 nt + g."""
    B = torch.zeros((8, 16, 64))
    for kc in range(8):
        for ntp in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    p = t + 4 * (q & 1)
                    col = (2 * ntp + (q >> 1)) * 8 + g
                    B[kc, 2 * p:2 * p + 2, col] = packed_l[kc, ntp, lane,
                                                           q].float()
    return B


def _point_weight(pt, meta):
    """(N,) ((hat_x * hat_y) * hat_z) of corner point pt, f32."""
    def hat(c, p):
        return torch.clamp_min(1.0 - (c - p).abs(), 0.0)

    return (hat(float(pt // 9), meta[0]) * hat(float(pt // 3 % 3), meta[1])
            * hat(float(pt % 3), meta[2]))


def emulate(variant, rows, meta_T, w1big):
    """The kernel's arithmetic on the CPU: bf16 A columns from the scaled
    decode and scaled weights, B from the pack, ft2 from the selector;
    each chunk's 16 products summed in f32, then chunk after chunk and
    level after level."""
    lanes = _columns()
    packed = ea.pack_w1_layout(w1big)
    n = rows.shape[1]
    h1 = torch.zeros((n, 64))
    ft2 = torch.zeros((rows.shape[0], 4, n))
    for l in range(rows.shape[0]):
        u = rows[l].to(torch.int64) & 0xFFFFFFFF
        if variant == "no_decode":
            lo = hi = rows[l].view(torch.float32)
            scale = 1.0
        else:
            lo, hi = scaled_halves(u)
            scale = SCALE
        # weight of lane j and j + 64 of word j: points c = j // 4, 16 + c
        w_lo = torch.stack([_point_weight(j // 4, meta_T[l])
                            for j in range(64)], 1) * scale
        w_hi = torch.stack([_point_weight(16 + j // 4, meta_T[l])
                            if j // 4 < 11 else torch.zeros(n)
                            for j in range(64)], 1) * scale
        if variant == "no_wrow":
            w_lo = w_hi = torch.full((n, 64), scale)
        vals = torch.cat([lo * w_lo, hi * w_hi], 1).to(torch.bfloat16).float()
        B = _b_chunks(packed[l])
        for kc in range(8):
            A = vals[:, lanes[kc]]
            h1 = h1 + A @ B[kc]
            if variant != "no_ft":
                S = torch.zeros((16, 4))
                for k, j in enumerate(lanes[kc].tolist()):
                    if j < 108:
                        S[k, j % 4] = 1.0
                ft2[l] = ft2[l] + (A @ S).T
    return h1, ft2


@pytest.mark.parametrize("variant", ["full", "no_decode", "no_wrow", "no_ft"])
def test_emulated_summation_order_matches_plain(variant):
    rng = np.random.default_rng(5)
    if variant == "no_decode":
        rows = rng.uniform(-2, 2, (L, N, 64)).astype(np.float32).view(
            np.int32)
    else:
        rows = rng.integers(0, 2 ** 32, (L, N, 64)).astype(
            np.uint32).view(np.int32)
    rows = torch.from_numpy(rows)
    meta_T = torch.from_numpy(rng.random((L, 4, N)).astype(np.float32))
    w1big = torch.from_numpy(rng.random((L, 128, 64)).astype(np.float32))
    got = emulate(variant, rows, meta_T, w1big)
    ref = ea.encode_ablation_plain(variant, rows, meta_T, w1big)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= K9_TOL * max(scale, 1e-30)
    if variant == "no_ft":
        assert bool((got[1] == 0).all())
    else:
        assert float(got[1].abs().max()) > 0
