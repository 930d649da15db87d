"""DWAA and DWAB OpenEXR input (`ngp_pl_torch/datasets/exr.py`'s `_dwa`
and the host library's `ngp_dwa_dct_decode`) against the test writer's
encoder (`tests/exr_writer.py`'s `dwa_block`, written from OpenEXR's
ImfDwaCompressor.cpp and dwaLookups.cpp).  DWA is lossy, but its decoder
is deterministic: the writer works out what its bytes decode to through
a float64 inverse DCT and colour transform, rounded once to half (the
nonlinear value), then its own table to linear.  The reader must return
RLE and UNKNOWN channels exactly, and each LOSSY_DCT value as the table's
value at the writer's nonlinear half or at one of its two neighbours (1
half ulp where DWA rounds, before the table: the reader sums in float as
OpenEXR's decoder does).  Frames of constant 8x8 blocks (DC only: the
table and the colour transform alone), then full frames: HALF and FLOAT,
RGB and RGBA, layers and other channels, both AC methods, rule tables of
version 2 and the legacy rules of version 1, pLinear, odd sizes, data
windows off the origin, both line orders; random frames; cut and corrupt
blocks; the RTMV script against the JAX repository's."""
import importlib.util
import shutil
import struct
import tempfile
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ngp_pl_torch import native
from ngp_pl_torch.datasets import exr
from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.misc import prepare_rtmv
from tests.exr_writer import (DWA_LOSSY_DCT, ZIGZAG, _dct_matrices,
                              dwa_to_linear, encode_exr)

REPO = Path(__file__).resolve().parent.parent


def _frame(h, w, names="RGBA", dtype=np.float16, seed=0, noise=0.05):
    """Smooth radiance in [0, 2) with noise and a step; alpha in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ch = {}
    for k, n in enumerate(names):
        a = np.sin(5 * x * (k + 1) + seed) * np.cos(3 * y) + 1.0
        a = a + noise * rng.standard_normal((h, w)) + (x > 0.6) * 0.5
        if n.endswith("A"):
            a = np.clip(a / 2, 0, 1)
        ch[n] = a.astype(dtype)
    return ch


def _within(got: np.ndarray, enc, name: str) -> np.ndarray:
    """Where `got` is the writer's value, or (on LOSSY_DCT channels) the
    table's value at a half neighbour of the writer's nonlinear one."""
    want = enc.held[name].astype(np.float32)
    ok = got == want
    if name in enc.nonlinear:
        nl = enc.nonlinear[name]
        lut = dwa_to_linear()
        for v in (np.nextafter(nl, np.float16(np.inf)),
                  np.nextafter(nl, np.float16(-np.inf))):
            ok |= got == lut[v.view(np.uint16)].view(np.float16).astype(
                np.float32)
    return ok


def _check(tmp_path, ch, comp, names, **kw):
    """Write, read, and hold each channel: exact off LOSSY_DCT, within 1
    half ulp of the nonlinear value on it; returns (Encoded, the share of
    LOSSY_DCT values that are not exact)."""
    enc = encode_exr(ch, comp, **kw)
    path = tmp_path / "f.exr"
    path.write_bytes(enc.data)
    got = read_exr(path)
    assert got.dtype == np.float32 and got.shape[-1] == len(names)
    off = []
    for i, n in enumerate(names):
        want = enc.held[n].astype(np.float32)
        if n in enc.nonlinear:
            assert _within(got[..., i], enc, n).all(), n
            off.append(np.mean(got[..., i] != want))
        else:
            np.testing.assert_array_equal(got[..., i].view(np.uint32),
                                          want.view(np.uint32))
    return enc, max(off, default=0.0)


def test_to_linear_table():
    """The reader's table is the writer's (both from dwaLookups.cpp):
    1 -> 1, 0 and -0 -> 0, the sign kept, e^2.2 at 2, infinities and NaNs
    -> 0, and it rises with its input."""
    table = exr.dwa_to_linear()
    np.testing.assert_array_equal(table, dwa_to_linear())
    x = np.array([1.0, 0.0, -0.0, -1.0, 2.0, np.inf, np.nan], np.float16)
    got = table[x.view(np.uint16)].view(np.float16).astype(np.float32)
    np.testing.assert_allclose(got, [1, 0, 0, -1, np.exp(2.2), 0, 0],
                               rtol=1e-3)
    pos = table[:0x7C00].view(np.float16).astype(np.float32)
    assert (pos[1:] >= pos[:-1]).all()


# R, G and B each LOSSY_DCT alone: no colour transform
LONE_RULES = [(n, DWA_LOSSY_DCT, 1, -1, False) for n in "RGB"]


@pytest.mark.parametrize("comp", ["DWAA", "DWAB"])
@pytest.mark.parametrize("names,rules", [
    ("RGB", None), ("RGBA", None), ("RGB", LONE_RULES)])
@pytest.mark.parametrize("hw", [(8, 8), (24, 40), (37, 21)])
def test_constant_blocks(tmp_path, comp, names, rules, hw):
    """Each 8x8 block one value (and the edge blocks cut): only DC is set,
    so each block is its DC value times 3.535536e-01f twice, then the
    colour transform (an R, G, B set; not for lone channels) and the
    table.  This isolates both from the inverse DCT."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    ch = {}
    for n in names:
        v = rng.random((-(-h // 8), -(-w // 8))) * 3 - 0.5
        ch[n] = np.kron(v, np.ones((8, 8)))[:h, :w].astype(np.float16)
    enc, _ = _check(tmp_path, ch, comp, names, dwa=dict(rules=rules))
    assert all(enc.packed)


@pytest.mark.parametrize("comp", ["DWAA", "DWAB"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("names", ["RGB", "RGBA"])
@pytest.mark.parametrize("hw,origin,order", [
    ((1, 1), (0, 0), "INCREASING_Y"), ((5, 3), (2, -1), "DECREASING_Y"),
    ((37, 21), (-5, 7), "DECREASING_Y"), ((70, 45), (0, 0), "INCREASING_Y"),
    ((300, 17), (3, 3), "INCREASING_Y")])
def test_round_trip(tmp_path, comp, dtype, names, hw, origin, order):
    """HALF and FLOAT colour channels (a set, with the colour transform)
    and alpha (RLE); blocks of 32 (DWAA) and 256 (DWAB) lines with a
    short last one; every width and height mod 8."""
    enc, off = _check(tmp_path, _frame(*hw, names, dtype, seed=sum(hw)),
                      comp, names, origin=origin, line_order=order)
    if hw[0] >= 37:
        assert any(enc.packed), "no block was stored compressed"
        assert off < 0.01


@pytest.mark.parametrize("comp", ["DWAA", "DWAB"])
@pytest.mark.parametrize("ac_method", ["HUFFMAN", "DEFLATE"])
@pytest.mark.parametrize("version", [1, 2])
def test_ac_methods_and_versions(tmp_path, comp, ac_method, version):
    """AC through OpenEXR's Huffman code or zlib; version 2 carries its
    rules, version 1 means the legacy ones."""
    enc, _ = _check(tmp_path, _frame(40, 48, seed=7), comp, "RGBA",
                    dwa=dict(ac_method=ac_method, version=version))
    assert all(enc.packed)


@pytest.mark.parametrize("comp", ["DWAA", "DWAB"])
def test_layers_and_other_channels(tmp_path, comp):
    """Two layers' R, G, B sets, decoded in their prefixes' order
    ("diffuse" before the unnamed one), a lone "Y" (LOSSY_DCT without the
    colour transform), a FLOAT "Z" and a UINT "id" (UNKNOWN: zlib) and an
    alpha (RLE): the top layer's R, G, B and A read back."""
    ch = _frame(33, 27, "RGBA", seed=1)
    ch.update({f"diffuse.{n}": a for n, a in _frame(
        33, 27, "RGB", seed=2).items()})
    ch["Y"] = _frame(33, 27, "Y", seed=3)["Y"]
    ch["Z"] = _frame(33, 27, "Z", np.float32, seed=4)["Z"]
    ch["id"] = np.arange(33 * 27, dtype=np.uint32).reshape(33, 27)
    enc, _ = _check(tmp_path, ch, comp, "RGBA")
    assert set(enc.nonlinear) == {"R", "G", "B", "Y", "diffuse.R",
                                  "diffuse.G", "diffuse.B"}
    for n in ("Z", "id"):
        np.testing.assert_array_equal(enc.held[n], ch[n])


def test_rule_tables(tmp_path):
    """A version-2 table of other rules: R, G and B each LOSSY_DCT alone
    (no colour transform), and case-insensitive suffixes."""
    rules = [(n.lower(), DWA_LOSSY_DCT, 1, -1, True) for n in "RGB"]
    enc, _ = _check(tmp_path, _frame(24, 30, "RGB", seed=5), "DWAA", "RGB",
                    dwa=dict(rules=rules))
    assert set(enc.nonlinear) == set("RGB")
    # the table holds the three rules: suffix, byte 0x05, type 1
    body = b"".join(n.encode() + b"\0\x05\x01" for n in "rgb")
    assert struct.pack("<H", 2 + len(body)) + body in enc.data


@pytest.mark.parametrize("rules", [LONE_RULES, None])
def test_plinear(tmp_path, rules):
    """A lone pLinear channel skips both tables; a colour set goes through
    them whatever pLinear says."""
    enc, _ = _check(tmp_path, _frame(24, 24, "RGB", seed=6), "DWAB", "RGB",
                    linear=tuple("RGB"), dwa=dict(rules=rules))
    skipped = np.array_equal(enc.held["R"], enc.nonlinear["R"])
    assert skipped == (rules is not None)


def test_dct_decode_against_float64():
    """The host library's inverse DCT on random coefficients against the
    float64 product with the same constants: within float sums' error."""
    rng = np.random.default_rng(0)
    n = 64
    coef = rng.standard_normal((n, 64)) * np.exp(-np.arange(64) / 12)
    coef[:, 0] *= 8
    halves = coef.astype(np.float16)
    zig = halves[:, ZIGZAG].view(np.uint16)
    ac = zig[:, 1:].reshape(-1)         # 63 values a block, no run code
    planes, used = native.dwa_dct_decode(ac, zig[:, 0].copy(), 1, 8 * n, 8)
    assert used == ac.size
    _, m = _dct_matrices()
    want = m @ halves.astype(np.float64).reshape(n, 8, 8) @ m.T
    want = want.transpose(1, 0, 2).reshape(8, 8 * n)
    got = planes[0].view(np.float16).astype(np.float64)
    ulp = np.abs(want) * 2.0 ** -10 + 2.0 ** -24
    assert (np.abs(got - want) <= ulp).all()


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2 ** 32 - 1),
       st.sampled_from(["DWAA", "DWAB"]))
def test_random_frames(h, w, seed, comp):
    """Random half frames, smooth or noisy (wide AC: long and short runs,
    lone zeros, full blocks)."""
    noise = 0.05 if seed % 2 else 0.5
    ch = _frame(h, w, "RGBA", seed=seed % 1000, noise=noise)
    with tempfile.TemporaryDirectory() as tmp:
        _check(Path(tmp), ch, comp, "RGBA")


def _first_block(data: bytes):
    """(offset of block 0's data, its size) in a single-part file."""
    pos = 8
    while data[pos] != 0:
        pos = data.index(b"\0", pos) + 1
        pos = data.index(b"\0", pos) + 1
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4 + size
    (off,) = struct.unpack("<Q", data[pos + 1:pos + 9])
    (size,) = struct.unpack("<i", data[off + 4:off + 8])
    return off + 8, size


@pytest.mark.parametrize("damage,match", [
    ("truncate", "DWA block at y=0"), ("version", "version 3"),
    ("ac_count", "AC"), ("dc_count", "DC values"),
    ("corrupt_rle", "RLE|inflate")])
def test_bad_blocks_raise(tmp_path, damage, match):
    """A block cut inside its sections, of an unknown version, with too
    few AC or DC values for its blocks, or with a corrupt RLE section,
    raises a ValueError naming the file and the block."""
    enc = encode_exr(_frame(32, 40), "DWAA")
    data = bytearray(enc.data)
    start, size = _first_block(bytes(data))
    counters = list(struct.unpack_from("<11Q", data, start))
    if damage == "truncate":
        data[start - 4:start] = struct.pack("<i", size - 20)
        data = data[:start + size - 20]
    elif damage == "corrupt_rle":
        end = start + size
        data[end - 4:end] = b"\xff\xff\xff\xff"
    else:
        at = {"version": 0, "ac_count": 8, "dc_count": 9}[damage]
        counters[at] = 3 if damage == "version" else counters[at] // 2
        struct.pack_into("<11Q", data, start, *counters)
    bad = tmp_path / "bad.exr"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match) as e:
        read_exr(bad)
    assert str(bad) in str(e.value)


def _jax_prepare_rtmv():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepare_rtmv_matches_jax_script(tmp_path, monkeypatch):
    """DWAA and DWAB frames (half and float): the JAX script, its imageio
    read replaced by what the port reads (each value within the 1-ulp
    rule of the writer's), and the port's script write pixel-equal
    PNGs."""
    kinds = [("DWAA", np.float16), ("DWAB", np.float16),
             ("DWAA", np.float32)]
    frames = {}
    (tmp_path / "jax" / "scene").mkdir(parents=True)
    for i, (comp, dtype) in enumerate(kinds):
        ch = _frame(23, 31, "RGBA", dtype, seed=i)
        path = tmp_path / "jax" / "scene" / f"{i:05d}.exr"
        enc = encode_exr(ch, comp, origin=(i, -i))
        path.write_bytes(enc.data)
        got = read_exr(path)
        for k, n in enumerate("RGBA"):
            assert _within(got[..., k], enc, n).all()
        frames[str(path)] = got
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.setattr(imageio, "imread", lambda p: frames[str(p)].copy())
    _jax_prepare_rtmv().main(str(tmp_path / "jax"))
    monkeypatch.undo()
    prepare_rtmv.main(str(tmp_path / "port"))
    pngs = sorted((tmp_path / "jax").glob("*/images/*.png"))
    assert len(pngs) == len(kinds)
    for p in pngs:
        q = tmp_path / "port" / p.relative_to(tmp_path / "jax")
        np.testing.assert_array_equal(read_png(q), np.asarray(
            imageio.imread(p)))
