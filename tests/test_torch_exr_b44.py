"""B44 and B44A OpenEXR input (`ngp_pl_torch/datasets/exr.py`'s `_b44`)
against the test writer's encoder (`tests/exr_writer.py`'s `b44_block`,
written from OpenEXR's ImfB44Compressor.cpp and b44ExpLogTable.cpp).  All
of B44's rounding happens in the encoder, so the reader must return
exactly the values the writer says its blocks hold: HALF channels with
pLinear off and on, FLOAT and UINT channels stored as they are, 3-byte
flat blocks, edge blocks of every width and height mod 4, data windows
off the origin, both line orders, infinities and NaNs (packed as 0),
random frames, and cut or corrupt blocks.  Then the RTMV script on B44
frames against the JAX repository's."""
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

from ngp_pl_torch.datasets import exr
from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.misc import prepare_rtmv
from tests.exr_writer import b44_exp_table, encode_exr

REPO = Path(__file__).resolve().parent.parent


def _frame(h, w, names="RGBA", dtype=np.float16, seed=0):
    """Smooth radiance in [0, 2) with noise, a flat patch and a step, so
    that blocks take several shifts, and B44A finds flat blocks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ch = {}
    for k, n in enumerate(names):
        a = np.sin(5 * x * (k + 1) + seed) * np.cos(3 * y) + 1.0
        a = a + 0.05 * rng.standard_normal((h, w)) + (x > 0.6) * 0.5
        a[: h // 3, : w // 3] = 0.25 * (k + 1)
        if dtype == np.uint32:
            ch[n] = (np.abs(a) * 1000).astype(np.uint32)
        else:
            ch[n] = a.astype(dtype)
    return ch


def _check(tmp_path, ch, comp, names, **kw):
    """Write, read, and hold the result to what the writer says the file
    holds, bit for bit; returns the Encoded record."""
    enc = encode_exr(ch, comp, **kw)
    path = tmp_path / "f.exr"
    path.write_bytes(enc.data)
    got = read_exr(path)
    want = np.stack([enc.held[n].astype(np.float32) for n in names], -1)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    return enc


@pytest.mark.parametrize("comp", ["B44", "B44A"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32])
@pytest.mark.parametrize("names", ["RGB", "RGBA"])
@pytest.mark.parametrize("hw,origin,order", [
    ((1, 1), (0, 0), "INCREASING_Y"), ((5, 3), (2, -1), "DECREASING_Y"),
    ((37, 21), (-5, 7), "DECREASING_Y"), ((70, 34), (0, 0), "INCREASING_Y")])
def test_round_trip(tmp_path, comp, dtype, names, hw, origin, order):
    """Every channel type; a block of 32 lines and a short last one;
    widths and heights of every remainder mod 4."""
    enc = _check(tmp_path, _frame(*hw, names, dtype, seed=sum(hw)), comp,
                 names, origin=origin, line_order=order)
    if dtype == np.float16 and hw[0] >= 37:
        assert any(enc.packed), "no block was stored compressed"


@pytest.mark.parametrize("comp", ["B44", "B44A"])
@pytest.mark.parametrize("linear", [(), ("R", "B"), ("R", "G", "B", "A")])
def test_plinear(tmp_path, comp, linear):
    """pLinear channels go through logTable before packing and expTable
    after unpacking (the encoder then keeps tMax only to its step); the
    others keep tMax exactly."""
    ch = _frame(40, 44, "RGBA", seed=3)
    enc = _check(tmp_path, ch, comp, "RGBA", linear=linear)
    data = enc.data
    assert all(enc.packed)
    # the chlist's pLinear bytes say which channels are linear
    for n in "ABGR":
        at = data.index(n.encode() + b"\0\1\0\0\0")
        assert data[at + 6] == (n in linear)
    lossless = [n for n in "RGBA" if n not in linear]
    for n in lossless:
        # a channel's largest value of each 4x4 block is kept exactly
        a = ch[n][:40, :44].astype(np.float32).reshape(10, 4, 11, 4)
        b = enc.held[n].astype(np.float32).reshape(10, 4, 11, 4)
        np.testing.assert_array_equal(a.max((1, 3)), b.max((1, 3)))


def test_exp_table():
    """The reader's expTable is the writer's (both from
    b44ExpLogTable.cpp); 0 -> 1, 8 ln 2 -> 2, HALF_MAX past 8 ln(HALF_MAX),
    infinities and NaNs -> 0."""
    table = exr._b44_exp_table()
    np.testing.assert_array_equal(table, b44_exp_table())
    h = np.array([0.0, 8 * np.log(2), 89.0, np.inf, -np.inf, np.nan],
                 np.float16).view(np.uint16)
    got = table[h].view(np.float16).astype(np.float32)
    np.testing.assert_allclose(got[:2], [1.0, 2.0], rtol=1e-3)
    np.testing.assert_array_equal(got[2:], [65504.0, 0.0, 0.0, 0.0])


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


def test_flat_blocks(tmp_path):
    """B44A stores a 4x4 block of one value in 3 bytes (third byte 0xfc,
    a shift no 14-byte block can have); B44 never does.  A frame of one
    value but a few pixels: both read back exactly, B44A much smaller."""
    a = np.full((32, 64), 0.5, np.float16)
    a[3, 5] = a[17, 40] = 1.5
    ch = {"R": a, "G": a * 2, "B": a / 2}
    sizes = {}
    for comp in ("B44", "B44A"):
        enc = _check(tmp_path, ch, comp, "RGB")
        sizes[comp] = _first_block(enc.data)[1]
    assert sizes["B44"] == 3 * 128 * 14
    assert sizes["B44A"] == 3 * (126 * 3 + 2 * 14)


def test_special_values(tmp_path):
    """Infinities and NaNs are packed as 0 (ordered 0x8000), which the
    block's shift then rounds as any value; -0, a subnormal and HALF_MAX
    go through as the writer says its blocks hold them."""
    a = _frame(8, 8, "R")["R"]
    a[0, 0], a[0, 1], a[1, 0] = np.inf, -np.inf, np.nan
    a[4, 4], a[4, 5] = -0.0, np.float16(6e-8)
    a[7, 7] = 65504.0
    ch = {"R": a, "G": a.copy(), "B": np.zeros_like(a)}
    enc = _check(tmp_path, ch, "B44A", "RGB")
    special = enc.held["R"].astype(np.float32)[[0, 0, 1], [0, 1, 0]]
    assert np.isfinite(special).all() and (np.abs(special) < 1e-3).all()
    assert enc.held["R"][7, 7] == 65504.0


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2 ** 32 - 1),
       st.sampled_from(["B44", "B44A"]), st.booleans())
def test_random_half_frames(h, w, seed, comp, linear):
    """Random half frames, smooth or wild (any finite half, so every
    shift), pLinear or not."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        ch = _frame(h, w, "RGBA", seed=seed % 1000)
    else:
        bits = rng.integers(0, 1 << 16, (4, h, w)).astype(np.uint16)
        bits[(bits & 0x7C00) == 0x7C00] &= 0xBFFF
        ch = dict(zip("RGBA", bits.view(np.float16)))
    with tempfile.TemporaryDirectory() as tmp:
        _check(Path(tmp), ch, comp, "RGBA",
               linear=("R", "G") if linear else ())


@pytest.mark.parametrize("comp", ["B44", "B44A"])
@pytest.mark.parametrize("damage", ["truncate", "extra"])
def test_bad_blocks_raise(tmp_path, comp, damage):
    """A block cut inside a 4x4 block, or with bytes past its channels,
    raises a ValueError that names the file and the block."""
    enc = encode_exr(_frame(40, 64, "RGB"), comp)
    data = bytearray(enc.data)
    start, size = _first_block(bytes(data))
    if damage == "truncate":
        new = size - 5
        data[start - 4:start] = struct.pack("<i", new)
        data = data[:start + new]
    else:
        data[start - 4:start] = struct.pack("<i", size - 2)
        data[start:start + size] = data[start + 2:start + size] + b"\0\0"
        # the same bytes minus the first two: the blocks misalign
    bad = tmp_path / "bad.exr"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="B44") as e:
        read_exr(bad)
    assert str(bad) in str(e.value)


def _jax_prepare_rtmv():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepare_rtmv_matches_jax_script(tmp_path, monkeypatch):
    """B44 and B44A frames (half, float, pLinear): the JAX script, its
    imageio read replaced by what the files hold, and the port's script
    write pixel-equal PNGs."""
    kinds = [("B44", np.float16, ()), ("B44A", np.float16, ()),
             ("B44A", np.float32, ()), ("B44", np.float16, ("R", "G", "B"))]
    frames = {}
    (tmp_path / "jax" / "scene").mkdir(parents=True)
    for i, (comp, dtype, linear) in enumerate(kinds):
        ch = _frame(23, 31, "RGBA", dtype, seed=i)
        path = tmp_path / "jax" / "scene" / f"{i:05d}.exr"
        enc = encode_exr(ch, comp, origin=(i, -i), linear=linear,
                         line_order=("DECREASING_Y" if i % 2
                                     else "INCREASING_Y"))
        path.write_bytes(enc.data)
        frames[str(path)] = np.stack([enc.held[n].astype(np.float32)
                                      for n in "RGBA"], -1)
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
