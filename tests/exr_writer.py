"""A writer of single-part scanline OpenEXR files, from the OpenEXR
specification ("OpenEXR File Layout", "Technical Introduction"): the magic
number and version field, the header's attributes, the line offset table,
and blocks of scanlines stored uncompressed or with RLE, ZIPS or ZIP.  The
compressors split each block into its even and odd bytes, replace each byte
by its difference from the one before plus 128, and then run-length or
zlib code the result; a block that does not shrink is stored as it is.  It
imports no JAX, so the chip's smoke script can use the files it wrote."""
from __future__ import annotations

import struct
import zlib

import numpy as np

COMPRESSION = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1), "ZIP": (3, 16),
               "PIZ": (4, 32)}
PIXEL_TYPE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
              np.dtype(np.float32): 2}
LINE_ORDER = {"INCREASING_Y": 0, "DECREASING_Y": 1}


def _attr(name: str, kind: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def _predict(raw: bytes) -> bytes:
    """The compressors' byte reorder (even bytes, then odd) and predictor."""
    t = np.frombuffer(raw, np.uint8)
    t = np.concatenate([t[0::2], t[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def _rle(buf: bytes) -> bytes:
    """Runs of 3 to 128 equal bytes as (count - 1, byte); the rest as
    (-n, n literal bytes), n <= 127."""
    out, i, n = bytearray(), 0, len(buf)
    lit = bytearray()

    def flush():
        for k in range(0, len(lit), 127):
            part = lit[k:k + 127]
            out.extend(struct.pack("b", -len(part)))
            out.extend(part)
        lit.clear()

    while i < n:
        j = i + 1
        while j < n and buf[j] == buf[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            flush()
            out.extend(struct.pack("b", j - i - 1) + buf[i:i + 1])
        else:
            lit.extend(buf[i:j])
        i = j
    flush()
    return bytes(out)


def write_exr(path, channels: dict, compression: str = "ZIP",
              origin=(0, 0), line_order: str = "INCREASING_Y",
              version_flags: int = 0) -> None:
    """`channels`: name -> (H, W) array of float16, float32 or uint32, all
    one size.  `origin` is the data window's (xmin, ymin); `version_flags`
    adds bits to the version field (0x200 tiled, 0x1000 multi-part) for
    files a reader must refuse."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    comp, lines = COMPRESSION[compression]
    x0, y0 = origin
    chlist = b"".join(
        n.encode() + b"\0" + struct.pack(
            "<iB3xii", PIXEL_TYPE[np.asarray(channels[n]).dtype], 0, 1, 1)
        for n in names) + b"\0"
    box = struct.pack("<4i", x0, y0, x0 + w - 1, y0 + h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2 | version_flags)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([comp]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder",
                      bytes([LINE_ORDER[line_order]]))
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    blocks = []
    for b, r0 in enumerate(range(0, h, lines)):
        rows = range(r0, min(r0 + lines, h))
        raw = b"".join(np.ascontiguousarray(
            channels[n][r], channels[n].dtype.newbyteorder("<")).tobytes()
            for r in rows for n in names)
        packed = raw
        if compression == "RLE":
            packed = _rle(_predict(raw))
        elif compression in ("ZIPS", "ZIP"):
            packed = zlib.compress(_predict(raw))
        if len(packed) >= len(raw):
            packed = raw
        blocks.append(struct.pack("<ii", y0 + r0, len(packed)) + packed)
    order = list(range(len(blocks)))
    if line_order == "DECREASING_Y":
        order.reverse()
    offsets = [0] * len(blocks)
    pos = len(header) + 8 * len(blocks)
    for b in order:
        offsets[b] = pos
        pos += len(blocks[b])
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(blocks)}Q", *offsets)
                + b"".join(blocks[b] for b in order))
