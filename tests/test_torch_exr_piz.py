"""PIZ and PXR24 OpenEXR input (`ngp_pl_torch/datasets/exr.py` and the
host library's PIZ stages) against the test writer's encoders
(`tests/exr_writer.py`, written from OpenEXR's ImfPizCompressor.cpp,
ImfHuf.cpp, ImfWav.cpp and ImfPxr24Compressor.cpp).  The decoder is held
against this encoder, code of its own written from the same sources,
because no independent PIZ reader or writer exists on this machine: its
cv2 has no EXR codec and there is no OpenEXR module.  Round trips of
HALF, FLOAT and UINT, RGB and RGBA, odd sizes, data windows off the
origin and both line orders; both wavelet modes; all-zero, one-value and
long constant blocks; random half frames; corrupt blocks; and the RTMV
script on PIZ and PXR24 frames against the JAX repository's."""
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

from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.misc import prepare_rtmv
from tests.exr_writer import float24, write_exr

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
LINES = {"PIZ": 32, "PXR24": 16}


def _smooth(h, w, names, dtype, seed=0):
    """A frame that compresses: smooth radiance in [0, 2) with a step,
    float32 values cut to 7 bits of significand (their low halves 0, so
    PIZ's bitmap stays short), UINT as thousandths."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ch = {}
    for k, n in enumerate(names):
        a = np.sin(3 * x * (k + 1) + seed) * np.cos(2 * y) + 1.0
        a = (a + (x > 0.5) * 0.25).astype(np.float32)
        if dtype == np.uint32:
            ch[n] = (a * 1000).astype(np.uint32)
        else:
            ch[n] = (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(
                np.float32).astype(dtype)
    return ch


def _stored(ch, names, comp, packed):
    """What the file holds, (H, W, C) float32: PXR24 FLOAT blocks that
    were compressed hold the 24-bit values."""
    want = np.stack([ch[n].astype(np.float32) for n in names], -1)
    if comp == "PXR24" and ch[names[0]].dtype == np.float32:
        for b, p in enumerate(packed):
            rows = slice(b * LINES[comp], (b + 1) * LINES[comp])
            if p:
                want[rows] = float24(want[rows])
    return want


def _round_trip(path, ch, comp, names, **kw):
    packed = write_exr(path, ch, comp, **kw)
    got = read_exr(path)
    want = _stored(ch, names, comp, packed)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return packed


@pytest.mark.parametrize("comp", ["PIZ", "PXR24"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32])
@pytest.mark.parametrize("names", ["RGB", "RGBA"])
@pytest.mark.parametrize("hw,origin,order", [
    ((1, 1), (0, 0), "INCREASING_Y"), ((5, 3), (2, -1), "DECREASING_Y"),
    ((37, 21), (-5, 7), "DECREASING_Y"), ((70, 33), (0, 0), "INCREASING_Y")])
def test_round_trip(tmp_path, comp, dtype, names, hw, origin, order):
    """Bit-exact against what the writer stored: blocks shorter than one
    (5 lines) and longer, with a short last block (37, 70 lines)."""
    ch = _smooth(*hw, names, dtype, seed=sum(hw))
    packed = _round_trip(tmp_path / "f.exr", ch, comp, names,
                         origin=origin, line_order=order)
    if hw[0] >= 37:
        assert any(packed), "no block was stored compressed"


def test_wavelet_modes(tmp_path):
    """Fewer than 16,384 distinct values take the 14-bit wavelet, more the
    16-bit modular one; both read back exactly."""
    y, x = np.mgrid[0:40, 0:600]
    few = {n: ((x + 3 * y) % 512 / 64).astype(np.float16) for n in "RGB"}
    many = {n: (np.arange(40 * 600).reshape(40, 600) * 3 + k).astype(
        np.uint32) for k, n in enumerate("RGB")}
    assert np.unique(few["R"].view(np.uint16)).size < 1 << 14
    assert np.unique(np.stack(list(many.values())).view(np.uint16)).size \
        > 1 << 14
    for ch in (few, many):
        assert all(_round_trip(tmp_path / "w.exr", ch, "PIZ", "RGB"))


@pytest.mark.parametrize("fill", [0.0, 0.5])
def test_constant_blocks(tmp_path, fill):
    """An all-zero block (no bitmap bytes) and a one-value block: the
    Huffman data is mostly the run code (runs of 256)."""
    ch = {n: np.full((64, 300), fill, np.float16) for n in "RGBA"}
    path = tmp_path / "c.exr"
    assert all(_round_trip(path, ch, "PIZ", "RGBA"))
    data = path.read_bytes()
    start, _ = _block(data)
    lo, hi = struct.unpack("<HH", data[start:start + 4])
    bits = np.float16(fill).view(np.uint16) >> 3
    assert (lo > hi) if fill == 0 else (lo == hi == bits)


def test_long_constant_run(tmp_path):
    """A frame that is one value but for a few pixels: long runs go
    through the run code, short ones explicitly."""
    a = np.full((40, 520), 0.25, np.float16)
    a[3, 7] = a[20, 400] = a[39, 519] = 1.5
    ch = {"R": a, "G": a.copy(), "B": a.copy()}
    assert all(_round_trip(tmp_path / "r.exr", ch, "PIZ", "RGB"))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2 ** 32 - 1),
       st.sampled_from(["PIZ", "PXR24"]))
def test_random_half_frames(h, w, seed, comp):
    """Random half frames, smooth or not, compressed or stored."""
    rng = np.random.default_rng(seed)
    smooth = seed % 2 == 0
    ch = (_smooth(h, w, "RGBA", np.float16, seed) if smooth else
          {n: rng.standard_normal((h, w)).astype(np.float16)
           for n in "RGBA"})
    with tempfile.TemporaryDirectory() as tmp:
        _round_trip(Path(tmp) / "h.exr", ch, comp, "RGBA")


def _block(data: bytes, index: int = 0):
    """(offset of the block's data, its size) of block `index`."""
    pos = 8                 # the header ends at an empty attribute name
    while data[pos] != 0:
        pos = data.index(b"\0", pos) + 1          # name
        pos = data.index(b"\0", pos) + 1          # type
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4 + size
    (off,) = struct.unpack("<Q", data[pos + 1 + 8 * index:pos + 9
                                      + 8 * index])
    (size,) = struct.unpack("<i", data[off + 4:off + 8])
    return off + 8, size


@pytest.mark.parametrize("comp", ["PIZ", "PXR24"])
@pytest.mark.parametrize("damage", ["truncate", "corrupt"])
def test_bad_blocks_raise(tmp_path, comp, damage):
    """A block cut short, or with its data overwritten, raises a
    ValueError that names the file."""
    ch = _smooth(40, 64, "RGB", np.float16)
    good = tmp_path / "good.exr"
    assert all(write_exr(good, ch, comp))
    data = bytearray(good.read_bytes())
    start, size = _block(bytes(data))
    if damage == "truncate":
        data[start - 4:start] = struct.pack("<i", size // 2)
        data = data[:start + size // 2] + data[start + size:]
        # the later blocks moved: cut the file after the first block
        data = data[:start + size // 2]
    else:
        data[start + size // 2:start + size] = bytes(
            (b * 37 + 11) & 0xFF for b in range(size - size // 2))
    bad = tmp_path / "bad.exr"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError) as e:
        read_exr(bad)
    assert str(bad) in str(e.value)


def _jax_prepare_rtmv():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepare_rtmv_matches_jax_script(tmp_path, monkeypatch):
    """PIZ (half and float) and PXR24 (half and float) frames: the JAX
    script, its imageio read replaced by what the files hold, and the
    port's script write pixel-equal PNGs."""
    kinds = [("PIZ", np.float16), ("PIZ", np.float32),
             ("PXR24", np.float16), ("PXR24", np.float32)]
    frames = {}
    (tmp_path / "jax" / "scene").mkdir(parents=True)
    for i, (comp, dtype) in enumerate(kinds):
        ch = _smooth(23, 31, "RGBA", dtype, seed=i)
        path = tmp_path / "jax" / "scene" / f"{i:05d}.exr"
        packed = write_exr(path, ch, comp, origin=(i, -i),
                           line_order=("DECREASING_Y" if i % 2
                                       else "INCREASING_Y"))
        assert all(packed)
        frames[str(path)] = _stored(ch, "RGBA", comp, packed)
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


def test_committed_piz_tree(tmp_path):
    """The committed PIZ/PXR24 tree (chip_smoke.py's `exr` phase reads it
    too): the port's script on a copy writes the PNGs the JAX script
    wrote for the same frames."""
    root = tmp_path / "rtmv"
    shutil.copytree(FIXTURES / "rtmv_exr_piz", root)
    prepare_rtmv.main(str(root))
    pngs = sorted(root.glob("*/images/*.png"))
    assert len(pngs) == len(list(root.glob("*/*.exr"))) == 3
    for got in pngs:
        want = got.parent.parent / "expected" / got.name
        np.testing.assert_array_equal(read_png(got), read_png(want))
