"""Tiled and multi-part OpenEXR input (`ngp_pl_torch/datasets/exr.py`'s
`_part0`, `_levels` and `_chunks`) against the test writer
(`tests/exr_writer.py`'s `encode_exr(tiles=...)` and `encode_multipart`).
Level 0 of ONE_LEVEL, MIPMAP and RIPMAP parts, rounding down and up, in
every method (exact for the lossless ones and B44, within DWA's 1-ulp
rule for DWA), with tiles clipped at the data window's right and bottom
edges, tiles larger than the frame, data windows off the origin and every
line order; part 0 of multi-part files, scanline or tiled, beside parts
of other kinds; the level counts against the writer's; what still raises
(deep part 0, a wrong chunkCount, a chunk of another part, subsampled
channels); and the committed RTMV tree of B44, B44A, DWAA, DWAB, tiled
and multi-part frames against the PNGs the JAX script wrote."""
import shutil
import struct
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ngp_pl_torch.datasets import exr
from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.misc import prepare_rtmv
from tests import exr_writer
from tests.exr_writer import dwa_to_linear, encode_exr, encode_multipart

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
LOSSLESS = ["NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A"]


def _frame(h, w, names="RGBA", seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    return {n: (np.sin(5 * x * (k + 1) + seed) * np.cos(3 * y) + 1.0
                + 0.05 * rng.standard_normal((h, w))).astype(np.float16)
            for k, n in enumerate(names)}


def _read_and_hold(tmp_path, enc, names="RGBA"):
    """read_exr of the encoded file, held to what the writer says part 0
    holds: exactly, or by DWA's rule (the table's value at the writer's
    nonlinear half or at a neighbour) on its LOSSY_DCT channels."""
    path = tmp_path / "f.exr"
    path.write_bytes(enc.data)
    got = read_exr(path)
    for i, n in enumerate(names):
        want = enc.held[n].astype(np.float32)
        if n not in enc.nonlinear:
            np.testing.assert_array_equal(got[..., i].view(np.uint32),
                                          want.view(np.uint32))
            continue
        ok = got[..., i] == want
        for v in (np.nextafter(enc.nonlinear[n], np.float16(np.inf)),
                  np.nextafter(enc.nonlinear[n], np.float16(-np.inf))):
            ok |= got[..., i] == dwa_to_linear()[v.view(np.uint16)].view(
                np.float16).astype(np.float32)
        assert ok.all(), n
    return got


@pytest.mark.parametrize("comp", LOSSLESS + ["DWAA", "DWAB"])
@pytest.mark.parametrize("tiles,origin,order", [
    ((16, 16, "ONE_LEVEL", "DOWN"), (0, 0), "INCREASING_Y"),
    ((8, 12, "MIPMAP", "UP"), (2, -3), "DECREASING_Y"),
    ((10, 7, "RIPMAP", "DOWN"), (-4, 5), "RANDOM_Y"),
    ((64, 64, "MIPMAP", "DOWN"), (0, 0), "INCREASING_Y")])
def test_tiled_round_trip(tmp_path, comp, tiles, origin, order):
    """37 x 29 in tiles that end short at the right and bottom (or one
    tile past both edges): level 0 read back, the other levels' tiles
    written between them and skipped.  (DWA stores tiles of fewer than
    256 pixels as they are: its counters outweigh them.)"""
    enc = encode_exr(_frame(37, 29, seed=len(comp)), comp, tiles=tiles,
                     origin=origin, line_order=order)
    got = _read_and_hold(tmp_path, enc)
    assert got.shape == (37, 29, 4)
    if comp not in ("NONE", "PIZ") and tiles[0] * tiles[1] >= 256:
        assert any(enc.packed)


@pytest.mark.parametrize("mode", ["ONE_LEVEL", "MIPMAP", "RIPMAP"])
@pytest.mark.parametrize("rounding", ["DOWN", "UP"])
def test_one_pixel_tiles(tmp_path, mode, rounding):
    """1x1 tiles: every pixel its own chunk, every level's chunks
    counted."""
    enc = encode_exr(_frame(5, 6, "RGB"), "ZIP",
                     tiles=(1, 1, mode, rounding))
    _read_and_hold(tmp_path, enc, "RGB")


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 5000), st.integers(1, 5000), st.integers(0, 2),
       st.integers(0, 1))
def test_level_sizes_match_writer(w, h, level, rounding):
    """The reader's levels (bit lengths) against the writer's (the loops
    of ImfTiledMisc.cpp's floorLog2 and ceilLog2)."""
    modes = ["ONE_LEVEL", "MIPMAP", "RIPMAP"]
    want = [(lw, lh) for _, _, lw, lh in exr_writer._levels(
        w, h, modes[level], ["DOWN", "UP"][rounding])]
    assert exr._levels("f", w, h, level | rounding << 4) == want


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 30), st.integers(1, 30), st.integers(1, 17),
       st.integers(1, 17), st.sampled_from(["ONE_LEVEL", "MIPMAP", "RIPMAP"]),
       st.sampled_from(["DOWN", "UP"]), st.sampled_from(LOSSLESS))
def test_random_tiled_frames(h, w, tw, th, mode, rounding, comp):
    ch = _frame(h, w, seed=h * w)
    with tempfile.TemporaryDirectory() as tmp:
        _read_and_hold(Path(tmp), encode_exr(ch, comp,
                                             tiles=(tw, th, mode, rounding)))


@pytest.mark.parametrize("comp", LOSSLESS + ["DWAA"])
@pytest.mark.parametrize("first", ["scanline", "tiled"])
def test_multipart_part0(tmp_path, comp, first):
    """Part 0 (scanline, or tiled with MIPMAP levels) of a file whose
    other parts are another size, compression, layout and line order."""
    tiles = (8, 8, "MIPMAP", "DOWN") if first == "tiled" else None
    parts = [dict(channels=_frame(21, 30, seed=1), compression=comp,
                  tiles=tiles, origin=(3, -2), name="beauty"),
             dict(channels=_frame(10, 12, "RGB", seed=2), compression="PIZ",
                  tiles=(4, 4, "RIPMAP", "UP"), name="small",
                  line_order="DECREASING_Y"),
             dict(channels=_frame(40, 9, "RGBA", seed=3),
                  compression="RLE", name="tall")]
    got = _read_and_hold(tmp_path, encode_multipart(parts))
    assert got.shape == (21, 30, 4)


def _table(data: bytes) -> int:
    """Where a single-part file's offset table starts."""
    pos = 8
    while data[pos] != 0:
        pos = data.index(b"\0", pos) + 1
        pos = data.index(b"\0", pos) + 1
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4 + size
    return pos + 1


def test_multipart_refusals(tmp_path):
    """A deep part 0, a part 0 whose chunkCount misses its levels' tiles,
    and a chunk in part 0's table that belongs to part 1 raise, naming the
    file and the cause."""
    parts = [dict(channels=_frame(20, 16, seed=1), name="a",
                  tiles=(8, 8, "MIPMAP", "DOWN")),
             dict(channels=_frame(8, 8, seed=2), name="b")]
    count = b"chunkCount\0int\0"
    cases = []
    data = bytearray(encode_multipart(parts).data)
    at = data.index(b"tiledimage")
    cases.append((data[:at] + b"deeptile\0\0" + data[at + 10:], "deep"))
    data = bytearray(encode_multipart(parts).data)
    at = data.index(count) + len(count) + 4          # part 0's value
    (n,) = struct.unpack("<i", data[at:at + 4])
    data[at:at + 4] = struct.pack("<i", n + 1)
    cases.append((data, "chunkCount"))
    data = bytearray(encode_multipart(parts).data)
    # after the last part's chunkCount: its header's end, the list's end
    table = data.rindex(count) + len(count) + 8 + 2
    (off,) = struct.unpack("<Q", data[table:table + 8])
    data[off:off + 4] = struct.pack("<i", 1)
    cases.append((data, "part 1"))
    for i, (bad, match) in enumerate(cases):
        path = tmp_path / f"bad{i}.exr"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=match) as e:
            read_exr(path)
        assert str(path) in str(e.value)


@pytest.mark.parametrize("tiles", [None, (8, 8, "ONE_LEVEL", "DOWN")])
def test_subsampled_channels_raise(tmp_path, tiles):
    """A channel sampled every second pixel (a luminance/chroma file)
    raises, naming the channel."""
    data = bytearray(encode_exr(_frame(8, 8, "RGB"), "ZIP",
                                tiles=tiles).data)
    at = data.index(b"G\0") + 2 + 8           # G's xSampling
    data[at:at + 4] = struct.pack("<i", 2)
    path = tmp_path / "sub.exr"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="channel G is subsampled") as e:
        read_exr(path)
    assert str(path) in str(e.value)


def test_tile_coordinates_checked(tmp_path):
    """A tile whose chunk header holds other coordinates than its place in
    the offset table raises."""
    data = bytearray(encode_exr(_frame(16, 16, "RGB"), "ZIP",
                                tiles=(8, 8, "ONE_LEVEL", "DOWN")).data)
    table = _table(bytes(data))
    (off,) = struct.unpack("<Q", data[table:table + 8])
    data[off:off + 4] = struct.pack("<i", 1)  # tile x 1, not 0
    path = tmp_path / "coords.exr"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"tile \(0, 0\)") as e:
        read_exr(path)
    assert str(path) in str(e.value)


def test_committed_more_tree(tmp_path):
    """The committed tree of B44, B44A, DWAA, DWAB, a tiled ZIP frame
    (MIPMAP) and a multi-part frame (chip_smoke.py's `exr` phase reads it
    too): the port's script on a copy writes the PNGs that the JAX script
    wrote for what the frames hold."""
    root = tmp_path / "rtmv"
    shutil.copytree(FIXTURES / "rtmv_exr_more", root)
    prepare_rtmv.main(str(root))
    pngs = sorted(root.glob("*/images/*.png"))
    assert len(pngs) == len(list(root.glob("*/*.exr"))) == 6
    for got in pngs:
        want = got.parent.parent / "expected" / got.name
        np.testing.assert_array_equal(read_png(got), read_png(want))
