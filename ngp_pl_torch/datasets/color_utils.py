"""Image input of the disk loaders (counterpart of
ngp_pl_tpu/datasets/color_utils.py; reference datasets/color_utils.py).

The JAX package reads images with imageio, resizes them with cv2 and reads
sizes with PIL; the card's machine has none of the three, so the port keeps
its own readers:
- `read_png`: 8-bit grey, grey + alpha, RGB, palette and RGBA, the array
  `imageio.v2.imread` gives (a palette image comes out as the RGB of its
  palette, its tRNS ignored, as imageio's Pillow plugin converts it).  The
  chunks are checked against their CRCs, the IDAT chunks concatenated and
  inflated with zlib, and the five row filters reversed in the host
  library (`ngp_pl_torch.native.png_unfilter`).  Any other bit depth or
  colour type, and interlaced files, raise: nothing is decoded
  approximately.
- `read_jpeg`: through Pillow, imported when a JPEG is met (imageio's own
  JPEG path); without Pillow it raises, naming the file.
- `image_size`: (width, height) from the PNG IHDR or the JPEG SOF header.
- `resize`: `cv2.resize(img, (w, h))` of a float32 (H, W, 3) image at its
  default INTER_LINEAR, with OpenCV's rules: the half-pixel source
  coordinate, clamped at the edges, and INTER_AREA's 2x2 box when both
  factors are exactly 2.  OpenCV's pip wheels run Intel IPP's resize, which
  takes each tap's fraction in double precision before rounding it to
  float32; so does this one, and it stays within 1.8e-7 of that cv2 on
  [0, 1) images (OpenCV's own code, with IPP off, rounds the coordinate to
  float32 first and lands up to 4.9e-6 away from it).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (name, samples per pixel); bit depth 8 only
_PNG_TYPES = {0: ("grey", 1), 2: ("RGB", 3), 3: ("palette", 1),
              4: ("grey+alpha", 2), 6: ("RGBA", 4)}


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    img = np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055, 12.92 * img)
    return np.minimum(img, 1.0)  # "clamp" tonemapper


def _png_chunks(path, data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {tag!r} is truncated or "
                             f"fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends without IEND")


def _png_ihdr(path, data: bytes):
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">IIBBBBB", data[16:29])


def read_png(path) -> np.ndarray:
    """(H, W) or (H, W, C) uint8, as `imageio.v2.imread` reads the file."""
    from ngp_pl_torch import native

    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, comp, filt, interlace = _png_ihdr(path, data)
    name, spp = _PNG_TYPES.get(ctype, (f"colour type {ctype}", 0))
    if depth != 8 or not spp or interlace or comp or filt:
        raise ValueError(
            f"{path}: PNG {name} at bit depth {depth}"
            f"{', interlaced' if interlace else ''}"
            f"{', compression or filter method not 0' if comp or filt else ''}"
            f" is not supported (8-bit grey, grey+alpha, RGB, palette and "
            f"RGBA, not interlaced)")
    idat, plte = [], None
    for tag, body in _png_chunks(path, data):
        if tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        px = native.png_unfilter(raw, h, w * spp, spp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if ctype == 3:
        if plte is None or int(px.max(initial=0)) >= len(plte):
            raise ValueError(f"{path}: PNG palette index past its PLTE")
        return plte[px.reshape(h, w)]
    return px.reshape(h, w) if spp == 1 else px.reshape(h, w, spp)


def read_jpeg(path) -> np.ndarray:
    """A JPEG through Pillow, as `imageio.v2.imread` reads it (no EXIF
    rotation); raises when Pillow is missing."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading JPEG images needs Pillow, which is not "
            f"installed; convert the images to PNG") from e
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert(im.palette.mode)
        return np.asarray(im)


def read_raw(path) -> np.ndarray:
    """A PNG or a JPEG, told apart by the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:3] == b"\xff\xd8\xff":
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def image_size(path) -> tuple:
    """(width, height) of a PNG or a JPEG from its header, without decoding
    (what `PIL.Image.open(path).size` gives)."""
    with open(path, "rb") as f:
        data = f.read(33)
        if data[:8] == PNG_SIGNATURE:
            return _png_ihdr(path, data)[:2]
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
        f.seek(2)
        while True:
            b = f.read(1)
            while b and b != b"\xff":        # skip to a marker
                b = f.read(1)
            while b == b"\xff":              # fill bytes
                b = f.read(1)
            if not b:
                raise ValueError(f"{path}: JPEG without a frame header")
            marker = b[0]
            if marker in (0x01, *range(0xD0, 0xDA)):   # no length field
                continue
            (n,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                _, hh, ww = struct.unpack(">BHH", f.read(5))
                return ww, hh
            f.seek(n - 2, 1)


def _linear_taps(src: int, dst: int):
    """INTER_LINEAR taps along one axis: source coordinate
    (d + 0.5) * scale - 0.5 in double, its floor, and its fraction rounded
    to float32, clamped to the first and last pixel (fraction 0 there)."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    f[s < 0] = 0
    s[s < 0] = 0
    last = s >= src - 1
    f[last] = 0
    s[last] = src - 1
    return s, np.minimum(s + 1, src - 1), (np.float32(1) - f), f, last


def resize(img: np.ndarray, wh) -> np.ndarray:
    """`cv2.resize(img, wh)` of a float32 (H, W, 3) image at INTER_LINEAR
    (see the module note)."""
    w, h = (int(v) for v in wh)
    if img.dtype != np.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) float32 image, got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    sx, sy = 1.0 / (w / W), 1.0 / (h / H)
    eps = np.finfo(np.float64).eps
    if abs(sx - 2) < eps and abs(sy - 2) < eps:
        # INTER_AREA's fast 2x2 path: ((a + b) + c) + d over the rows of a
        # cell, then x 0.25
        cell = img[:2 * h, :2 * w]
        acc = cell[0::2, 0::2] + cell[0::2, 1::2]
        acc = acc + cell[1::2, 0::2]
        acc = acc + cell[1::2, 1::2]
        return acc * np.float32(0.25)
    x0, x1, ax0, ax1, xlast = _linear_taps(W, w)
    y0, y1, by0, by1, _ = _linear_taps(H, h)
    rows = img[:, x0] * ax0[:, None] + img[:, x1] * ax1[:, None]
    rows[:, xlast] = img[:, x0[xlast]]
    return rows[y0] * by0[:, None, None] + rows[y1] * by1[:, None, None]


def read_image(img_path, img_wh, blend_a=True) -> np.ndarray:
    """An image as (H*W, 3) float32 in [0, 1] at `img_wh` (w, h)
    (ngp_pl_tpu/datasets/color_utils.py:19-49): grey repeated to three
    channels; uint8 samples through the host library (x 1.0f/255.0f), RGBA
    blended onto white (`blend_a`) or premultiplied; resized when the file
    is not `img_wh`.  With `NGP_PL_TORCH_NO_NATIVE` set, the numpy branch
    divides by 255 (up to one ulp apart), as the JAX package's numpy branch
    does."""
    from ngp_pl_torch import native

    raw = read_raw(img_path)
    if raw.ndim == 2:
        raw = np.repeat(raw[..., None], 3, axis=-1)
    h, w = raw.shape[:2]
    img = None
    if raw.dtype == np.uint8 and not native.native_disabled():
        img = native.u8_to_rays(
            np.ascontiguousarray(raw.reshape(h * w, raw.shape[-1])),
            blend_a=blend_a, premultiply=not blend_a).reshape(h, w, 3)
    if img is None:
        img = raw.astype(np.float32) / 255.0
        if img.shape[-1] == 4:
            if blend_a:
                img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
            else:
                img = img[..., :3] * img[..., -1:]
    if (img.shape[1], img.shape[0]) != tuple(img_wh):
        img = resize(img, img_wh)
    return img.reshape(-1, 3)
