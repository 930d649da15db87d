"""The port's image input (`ngp_pl_torch/datasets/color_utils.py`) against
what the JAX package reads with imageio, cv2 and PIL:
- the PNG decoder against `imageio.v2.imread`, bit for bit, on
  Pillow-written files of every supported colour type, on files whose rows
  carry each of the five filters, and on files split into many IDAT
  chunks; the files it refuses (interlaced, 16-bit, sub-byte palette, a
  bad filter byte, a bad CRC) raise naming the file and the type;
- JPEGs through Pillow as imageio reads them, and the error without it;
- image sizes from the header against PIL's;
- `resize` against `cv2.resize` (the IPP resize of OpenCV's wheels, which
  the JAX package runs) at scales 2, 4, 0.5 and 1.6 and at sizes that do
  not divide, within 2e-7;
- `read_image` against JAX's: blend onto white, premultiply, grey, palette,
  RGB, with and without a resize; and two defects of JAX's reproduced or
  refused (ROADMAP, reference defects)."""
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ngp_pl_tpu.datasets import color_utils as jcolor
from ngp_pl_torch.datasets import color_utils

# a palette of 200 entries keeps Pillow at bit depth 8
N_PLTE = 200


def _pillow_png(path, kind, h, w, seed):
    """A Pillow-written 8-bit PNG of one colour type."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if kind in ("P", "P+tRNS"):
        im = Image.fromarray(a[..., 0] % N_PLTE, "P")
        im.putpalette(rng.integers(0, 256, 3 * N_PLTE).astype(int).tolist())
        extra = ({"transparency": bytes(rng.integers(0, 256, N_PLTE).astype(
            np.uint8))} if kind == "P+tRNS" else {})
        im.save(path, **extra)
        return
    mode_channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[kind]
    px = a[..., :mode_channels]
    Image.fromarray(px[..., 0] if mode_channels == 1 else px, kind).save(path)


class _quiet:
    """Pillow warns on a palette with byte transparency; imageio still
    reads it as RGB."""

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("ignore")

    def __exit__(self, *a):
        return self._cm.__exit__(*a)


@settings(max_examples=20, deadline=None)
@given(kind=st.sampled_from(["L", "LA", "RGB", "RGBA", "P", "P+tRNS"]),
       h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 999))
def test_png_matches_imageio(tmp_path_factory, kind, h, w, seed):
    path = str(tmp_path_factory.mktemp("png") / "x.png")
    _pillow_png(path, kind, h, w, seed)
    with _quiet():
        want = imageio.imread(path)
    got = color_utils.read_png(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert color_utils.image_size(path) == Image.open(path).size == (w, h)


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filtered_png(px, ctype, filters, n_idat=1, interlace=0, depth=8):
    """PNG bytes of `px` (h, w, c) uint8 with row y under filter
    filters[y % len(filters)], the deflated data cut into n_idat IDATs."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][f]
        out.append(np.concatenate([[f], (cur - pred) % 256]))
    data = zlib.compress(np.concatenate(out).astype(np.uint8).tobytes())
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    return (color_utils.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + b"".join(_chunk(b"IDAT", data[a:b])
                       for a, b in zip(cuts[:-1], cuts[1:]))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("n_idat", [1, 3, 7])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("ctype,c", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_row_filters_and_idat_chunks(tmp_path, filters, n_idat, ctype,
                                         c):
    px = np.random.default_rng(len(filters) * 7 + n_idat).integers(
        0, 256, (13, 17, c)).astype(np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(px, ctype, filters, n_idat))
    want = imageio.imread(path)
    np.testing.assert_array_equal(want, px[..., 0] if c == 1 else px)
    np.testing.assert_array_equal(color_utils.read_png(path), want)


def test_png_refuses_what_it_does_not_decode(tmp_path):
    px = np.zeros((4, 5, 3), np.uint8)
    cases = {
        "interlaced": (_filtered_png(px, 2, (0,), interlace=1),
                       "PNG RGB at bit depth 8, interlaced"),
        "depth16": (_filtered_png(np.zeros((4, 5, 6), np.uint8), 2, (0,),
                                  depth=16), "PNG RGB at bit depth 16"),
        "ctype5": (_filtered_png(px, 5, (0,)), "colour type 5"),
    }
    for name, (data, match) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match) as e:
            color_utils.read_png(str(path))
        assert str(path) in str(e.value)
    # Pillow writes a 16-colour palette at bit depth 4, and 16-bit grey
    im = Image.fromarray(np.arange(20, dtype=np.uint8).reshape(4, 5) % 16,
                         "P")
    im.putpalette(list(range(48)))
    im.save(tmp_path / "p4.png")
    with pytest.raises(ValueError, match="PNG palette at bit depth 4"):
        color_utils.read_png(str(tmp_path / "p4.png"))
    # a filter byte past 4 and a corrupted chunk
    raw = zlib.compress(bytes([5] + [0] * 15) * 4)
    bad = (color_utils.PNG_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", raw) + _chunk(b"IEND", b""))
    (tmp_path / "f5.png").write_bytes(bad)
    with pytest.raises(ValueError, match="row 0 has filter type 5"):
        color_utils.read_png(str(tmp_path / "f5.png"))
    good = bytearray(_filtered_png(px, 2, (0,)))
    good[40] ^= 0xFF                             # inside IDAT's data
    (tmp_path / "crc.png").write_bytes(bytes(good))
    with pytest.raises(ValueError, match="CRC"):
        color_utils.read_png(str(tmp_path / "crc.png"))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_and_image_size(tmp_path, mode, progressive):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (23, 31, 3)).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(a if mode == "RGB" else a[..., 0], mode).save(
        path, quality=85, progressive=progressive)
    np.testing.assert_array_equal(color_utils.read_raw(path),
                                  imageio.imread(path))
    assert color_utils.image_size(path) == Image.open(path).size == (31, 23)


def test_jpeg_without_pillow_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs Pillow") as e:
        color_utils.read_image(path, (4, 4))
    assert path in str(e.value)


# (source h, w) -> (target w, h): scales 2, 4, 0.5, 1.6 and sizes that do
# not divide, down and up
RESIZES = [((64, 48), (24, 32)), ((64, 48), (12, 16)), ((32, 24), (48, 64)),
           ((80, 64), (40, 50)), ((37, 23), (16, 11)), ((23, 37), (9, 17)),
           ((800, 800), (400, 400)), ((17, 9), (40, 41))]


# OpenCV's wheels resize through IPP, which the port follows (its
# fractions in double); the largest reading on [0, 1) images over 300
# random sizes was 1.79e-7
RESIZE_ATOL = 2e-7


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_opencv(src, dst):
    img = np.random.default_rng(sum(src)).random(src + (3,)).astype(
        np.float32)
    got = color_utils.resize(img, dst)
    want = cv2.resize(img, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@settings(max_examples=15, deadline=None)
@given(h=st.integers(2, 60), w=st.integers(2, 60), th=st.integers(1, 60),
       tw=st.integers(1, 60), seed=st.integers(0, 99))
def test_resize_matches_opencv_at_any_size(h, w, th, tw, seed):
    img = np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(color_utils.resize(img, (tw, th)),
                               cv2.resize(img, (tw, th)), rtol=0,
                               atol=RESIZE_ATOL)


@pytest.mark.parametrize("kind,blend", [
    ("RGBA", True), ("RGBA", False), ("RGB", True), ("L", True),
    ("P", True), ("P+tRNS", False)])
@pytest.mark.parametrize("size", [(11, 9), (6, 5), (20, 16)])
def test_read_image_matches_jax(tmp_path, kind, blend, size):
    """Bit-equal at the file's size; within RESIZE_ATOL of JAX's cv2 where
    it resizes."""
    path = str(tmp_path / "x.png")
    _pillow_png(path, kind, 9, 11, 4)
    with _quiet():
        want = jcolor.read_image(path, size, blend)
    got = color_utils.read_image(path, size, blend)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (size[0] * size[1], 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0 if size == (11, 9) else RESIZE_ATOL)


def test_grey_alpha_defect_reproduced(tmp_path):
    """JAX's `read_image` hands a grey+alpha image to the u8 library with
    two channels, which reads blue from the next pixel's grey: reproduced
    (the last pixel apart, which JAX reads past its array)."""
    path = str(tmp_path / "la.png")
    _pillow_png(path, "LA", 6, 7, 2)
    want = jcolor.read_image(path, (7, 6))
    got = color_utils.read_image(path, (7, 6))
    np.testing.assert_array_equal(got[:-1], want[:-1])
    grey = imageio.imread(path)[..., 0].reshape(-1)
    np.testing.assert_array_equal(
        got[:-1, 2], grey[1:].astype(np.float32) * np.float32(1 / 255))


def test_16_bit_png_refused_where_jax_divides_by_255(tmp_path):
    """JAX's `read_image` divides a 16-bit PNG by 255 (values up to 257);
    the port refuses the file."""
    path = str(tmp_path / "g16.png")
    Image.fromarray(np.full((3, 4), 40000, np.uint16)).save(path)
    assert jcolor.read_image(path, (4, 3)).max() > 1.0
    with pytest.raises(ValueError, match="bit depth 16"):
        color_utils.read_image(path, (4, 3))


def test_srgb_curves_match_jax():
    x = np.linspace(0.0, 1.2, 1001).astype(np.float32)
    np.testing.assert_array_equal(color_utils.srgb_to_linear(x),
                                  jcolor.srgb_to_linear(x))
    np.testing.assert_array_equal(color_utils.linear_to_srgb(x),
                                  jcolor.linear_to_srgb(x))
