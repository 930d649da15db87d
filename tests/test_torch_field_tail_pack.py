"""The field tail's host side on the CPU: the bf16 weight fragments the
tensor-core kernels K7 and K8 read (`pack_weights`), their persistent grids
(`k7_blocks`, `k8_blocks`), the build's hash over included headers, and the
plain K7 and K8 against the JAX package's interpreted Pallas kernels at
inputs that saturate the TruncExp clamps or switch every h1 off."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.ops import field_pallas as jfp
from ngp_pl_torch import _build
from ngp_pl_torch.ops import field_tail as tft
from ngp_pl_torch.ops.sh import sh_encode

torch.set_num_threads(2)

SHAPES = ((64, 16), (32, 64), (64, 64), (64, 3))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
            for s in SHAPES]


def _operand(name, w2, wr1, wr2, wr3):
    """The (K, N) operand B of each fragment set, zero-padded, numpy."""
    wr3p = np.zeros((64, 8), np.float32)
    wr3p[:, :3] = wr3
    wr3t = np.zeros((16, 64), np.float32)
    wr3t[:3] = wr3.T
    return {"w2": w2, "wr1": wr1, "wr2": wr2, "wr3": wr3p, "wr3_t": wr3t,
            "wr2_t": wr2.T, "wr1h_t": wr1[16:].T, "w2_t": w2.T}[name]


# (name, first fragment, k-chunks, n-tiles), as in csrc/field_tail_mma.cuh
SETS = (("w2", 0, 4, 2), ("wr1", 8, 2, 8), ("wr2", 24, 4, 8),
        ("wr3", 56, 4, 1), ("wr3_t", 60, 1, 8), ("wr2_t", 68, 4, 8),
        ("wr1h_t", 100, 4, 2), ("w2_t", 108, 1, 8))


@pytest.mark.parametrize("name,first,KC,NT", SETS)
def test_pack_weights_lays_out_mma_b_fragments(name, first, KC, NT):
    """Lane l of fragment (nt, kc) holds B[k][n] at n = 8 nt + l // 4 and
    k = 16 kc + 2 (l % 4) + (0, 1, 8, 9): registers b0, b1 of
    mma.m16n8k16, the lower k in the low half; bf16 of the weights."""
    ws = _weights()
    packed = tft.pack_weights(*ws).float().numpy()
    assert packed.shape == (116, 32, 4)
    B = _operand(name, *(w.bfloat16().float().numpy() for w in ws))
    assert B.shape == (16 * KC, 8 * NT)
    for nt in range(NT):
        for kc in range(KC):
            frag = packed[first + nt * KC + kc]
            for lane in range(32):
                g, t = lane // 4, lane % 4
                want = [B[16 * kc + 2 * t + o, 8 * nt + g] for o in (0, 1, 8, 9)]
                np.testing.assert_array_equal(frag[lane], want)
    # K7 reads the forward's four sets, the first FRAGS_FWD fragments
    assert (first + KC * NT <= tft.FRAGS_FWD) == (first < tft.FRAGS_FWD)


def test_pack_weights_is_bf16_exact_and_pads_wr3_with_zeros():
    ws = _weights(1)
    packed = tft.pack_weights(*ws)
    assert packed.dtype == torch.bfloat16
    values = set(packed.float().numpy().ravel().tolist())
    for w in ws:
        assert set(w.bfloat16().float().numpy().ravel().tolist()) <= values
    # Wr3 (64, 3) padded to 8 columns: n-tile 0, lanes whose n = l // 4 >= 3
    wr3 = packed[56:60].float()
    assert torch.count_nonzero(wr3[:, 12:]) == 0
    assert torch.count_nonzero(wr3[:, :12]) == wr3[:, :12].numel()
    # Wr3^T (3, 64) padded to 16 rows: only k = 2 (l % 4) + (0, 1) < 3 live
    wr3t = packed[60:68].float()
    live = torch.zeros((32, 4), dtype=torch.bool)
    for lane in range(32):
        for e, o in enumerate((0, 1, 8, 9)):
            live[lane, e] = 2 * (lane % 4) + o < 3
    assert torch.count_nonzero(wr3t[:, ~live]) == 0
    assert torch.count_nonzero(wr3t[:, live]) == wr3t[:, live].numel()


def test_pack_weights_cached_until_a_weight_changes():
    ws = _weights(2)
    first = tft.pack_weights(*ws)
    assert tft.pack_weights(*ws) is first
    assert tft.pack_weights(*(w.detach() for w in ws)) is first
    with torch.no_grad():
        ws[2].mul_(2.0)                    # in place: version counter bumps
    second = tft.pack_weights(*ws)
    assert second is not first
    torch.testing.assert_close(second[24:56].float(),
                               2.0 * first[24:56].float(), rtol=0, atol=0)
    other = [w.clone() for w in ws]        # new storage, same values
    third = tft.pack_weights(*other)
    assert third is not second
    assert torch.equal(third, second)


@pytest.mark.parametrize("P", [0, 1, 15, 16, 17, 127, 128, 129, 1000, 65537,
                               393216, 1048576])
def test_persistent_grids_cover_every_sample_once(P):
    """The kernels' walks: K7's warp w of block b takes the groups of 16
    samples b * 8 + w, + 8 k7_blocks, ...; K8's block b the tiles of 128
    samples b, + k8_blocks, ..., and writes partial row b."""
    sms = 132
    n7, n8 = tft.k7_blocks(P, sms), tft.k8_blocks(P, sms)
    if P == 0:
        assert n7 == 0 and n8 == 0
        return
    assert 1 <= n7 <= 2 * sms and 1 <= n8 <= sms
    seen = np.zeros(P, np.int64)
    stride = n7 * tft.WARPS
    for first in range(stride):
        for grp in range(first, -(-P // tft.K7_GROUP), stride):
            seen[grp * 16:(grp + 1) * 16] += 1
    assert (seen == 1).all()
    assert (n7 - 1) * tft.WARPS * tft.K7_GROUP < P   # every block has one
    seen[:] = 0
    for b in range(n8):
        for tile in range(b, -(-P // tft.K8_TILE), n8):
            seen[tile * 128:(tile + 1) * 128] += 1
    assert (seen == 1).all()
    assert (n8 - 1) * tft.K8_TILE < P        # every block has a tile


def test_lib_path_follows_included_headers(tmp_path, monkeypatch):
    """A changed header rebuilds the kernels that include it, and only
    those."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\nint b;\n")
    (tmp_path / "common.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("a")] == [
        "a.cu", "common.cuh", "inner.cuh"]
    before = _build.lib_path("a"), _build.lib_path("b")
    (tmp_path / "inner.cuh").write_text("// v2\n")
    after = _build.lib_path("a"), _build.lib_path("b")
    assert after[0] != before[0] and after[1] == before[1]


def test_field_tail_sources_include_the_shared_mma_header():
    for name in ("field_tail_fwd", "field_tail_bwd"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "field_tail_mma.cuh"]


def _tail(P, seed, kind):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.3, s).astype(np.float32) for s in SHAPES]
    h1 = rng.normal(0, 2, (P, 64)).astype(np.float32)
    if kind == "clamp":
        # h[0] = relu(h1) W2[:, 0] far above +30 and below -30
        sign = np.sign(ws[0][:, 0])
        h1[0] = np.abs(h1[0]) * 100.0 * sign
        h1[1] = np.abs(h1[1]) * 100.0 * -sign
        h1[2] = np.abs(h1[2]) * 10.0 * sign      # past +15 only
    else:                                        # every unit of h1 off
        h1 = -np.abs(h1)
    d = rng.normal(size=(P, 3)).astype(np.float32)
    sh = sh_encode(torch.from_numpy(
        (d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5)).numpy()
    g_sigma = rng.normal(0, 1e-2, P).astype(np.float32)
    g_rgb = rng.normal(0, 1, (P, 3)).astype(np.float32)
    return h1, sh, ws, g_sigma, g_rgb


def _rel(a, b):
    b = np.asarray(b)
    scale = np.abs(b).max()
    err = np.abs(np.asarray(a) - b).max()
    return err / scale if scale else err


@pytest.mark.parametrize("kind", ["clamp", "h1_off"])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_plain_k7_matches_interpreted_pallas_at_edges(kind, acc):
    """sigma rtol 1e-5, rgb 4e-3 absolute (as the existing K7 parity test),
    with f32 sums and with float64 sums (`acc`)."""
    h1, sh, ws, _, _ = _tail(256, 5, kind)
    out = np.asarray(jfp._field_tail_impl(
        128, jnp.asarray(h1), jnp.asarray(sh.T), *map(jnp.asarray, ws[:3]),
        jnp.asarray(np.pad(ws[3], ((0, 0), (0, 5)))), interpret=True))
    sigma, rgb = tft.field_tail_plain(*map(torch.from_numpy, (h1, sh, *ws)),
                                      acc=acc)
    assert sigma.dtype == rgb.dtype == torch.float32
    np.testing.assert_allclose(sigma.numpy(), out[0], rtol=1e-5, atol=0)
    np.testing.assert_allclose(rgb.numpy(), out[1:4].T, rtol=0, atol=4e-3)
    if kind == "clamp":
        assert sigma[0] == pytest.approx(np.exp(30.0), rel=1e-6)
        assert sigma[1] == pytest.approx(np.exp(-30.0), rel=1e-6)
    else:
        assert torch.equal(sigma, torch.ones_like(sigma))


@pytest.mark.parametrize("kind", ["clamp", "h1_off"])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_plain_k8_matches_interpreted_pallas_at_edges(monkeypatch, kind, acc):
    """dh1 and the weight gradients within 1e-5 of max of the interpreted
    `_field_tail_bwd`, with f32 sums and with float64 sums (`acc`)."""
    monkeypatch.setattr(jfp, "_FORCE_INTERPRET", True)
    h1, sh, ws, g_sigma, g_rgb = _tail(256, 6, kind)
    g = np.zeros((8, 256), np.float32)
    g[0], g[1:4] = g_sigma, g_rgb.T
    res = (jnp.asarray(h1), jnp.asarray(sh.T), *map(jnp.asarray, ws[:3]),
           jnp.asarray(np.pad(ws[3], ((0, 0), (0, 5)))))
    out = jfp._field_tail_bwd(256, res, jnp.asarray(g))
    ref = [out[0], out[2], out[3], out[4], np.asarray(out[5])[:, :3]]
    got = tft.field_tail_bwd_plain(*map(torch.from_numpy, (
        h1, sh, g_sigma, g_rgb, *ws)), acc=acc)
    for name, a, b in zip(("dh1", "dW2", "dWr1", "dWr2", "dWr3"), got, ref):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), b) <= 1e-5, name
    if kind == "h1_off":
        assert torch.count_nonzero(got[0]) == 0
        assert torch.count_nonzero(got[1]) == 0
