"""OpenEXR input without imageio: the HDR frames of RTMV scenes, which
`ngp_pl_torch.misc.prepare_rtmv` turns into the PNGs the `rtmv` loader
reads.

`read_exr` reads a single-part scanline OpenEXR file (the layout of the
OpenEXR specification, "OpenEXR File Layout") whose channels are HALF,
FLOAT or UINT, one sample per pixel, stored uncompressed or compressed with
RLE, ZIPS (zlib, one scanline a block) or ZIP (zlib, 16 scanlines a block,
the OpenEXR library's default).  RLE and the zlib methods undo the byte
predictor and then the split of each block into its even and odd bytes.
Channels are stored in name order (B, G, R, A); the result is (H, W, C)
float32 in R, G, B(, A) order over the data window, wherever that window
starts, whichever line order the file was written in: what imageio hands
the JAX package's script for a HALF or FLOAT file.  Other channels are
left out.  PIZ, PXR24, B44, B44A, DWAA, DWAB and HTJ2K compression, tiled,
multi-part and deep files, and subsampled channels raise, naming the file
and what it holds.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000
# compression id -> (name, scanlines per block)
COMPRESSION = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1), 3: ("ZIP", 16),
               4: ("PIZ", 32), 5: ("PXR24", 16), 6: ("B44", 32),
               7: ("B44A", 32), 8: ("DWAA", 32), 9: ("DWAB", 256),
               10: ("HTJ2K", 16)}
READ = ("NONE", "RLE", "ZIPS", "ZIP")
# pixel type -> numpy little-endian dtype
PIXEL = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _cstr(data: bytes, pos: int):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _header(path, data: bytes):
    """(attributes by name as (type, bytes), the offset table's start)."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    (version,) = struct.unpack("<I", data[4:8])
    for flag, what in ((MULTIPART, "multi-part"), (DEEP, "deep"),
                       (TILED, "tiled")):
        if version & flag:
            raise ValueError(f"{path}: {what} OpenEXR files are not read "
                             f"(single-part scanline only)")
    attrs, pos = {}, 8
    while data[pos:pos + 1] != b"\0":
        name, pos = _cstr(data, pos)
        kind, pos = _cstr(data, pos)
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        attrs[name] = (kind, data[pos + 4:pos + 4 + size])
        pos += 4 + size
        if pos > len(data):
            raise ValueError(f"{path}: truncated OpenEXR header")
    return attrs, pos + 1


def _channels(path, raw: bytes):
    """[(name, dtype)] of a chlist, in the file's (name) order."""
    out, pos = [], 0
    while raw[pos:pos + 1] != b"\0":
        name, pos = _cstr(raw, pos)
        ptype, _, xs, ys = struct.unpack("<iB3xii", raw[pos:pos + 16])
        pos += 16
        if ptype not in PIXEL:
            raise ValueError(f"{path}: channel {name} has pixel type "
                             f"{ptype}")
        if xs != 1 or ys != 1:
            raise ValueError(f"{path}: channel {name} is subsampled "
                             f"({xs}x{ys}); not read")
        out.append((name, PIXEL[ptype]))
    return out


def _rle(path, src: bytes, size: int) -> bytes:
    """OpenEXR's run-length code: a signed count byte, then count + 1
    copies of one byte (count >= 0) or -count literal bytes."""
    out, i = bytearray(), 0
    while i < len(src):
        n = struct.unpack("b", src[i:i + 1])[0]
        if n < 0:
            out += src[i + 1:i + 1 - n]
            i += 1 - n
        else:
            out += src[i + 1:i + 2] * (n + 1)
            i += 2
    if len(out) != size:
        raise ValueError(f"{path}: RLE block inflates to {len(out)} bytes, "
                         f"{size} expected")
    return bytes(out)


def _unpredict(buf: bytes) -> bytes:
    """Undo the byte predictor (each byte stored as its difference from the
    one before, + 128), then put the two halves of the block back in turn
    (first half at the even offsets, second at the odd)."""
    t = np.frombuffer(buf, np.uint8).astype(np.int64)
    t[1:] -= 128
    t = np.cumsum(t) & 0xFF
    out = np.empty(t.size, np.uint8)
    half = (t.size + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path) -> np.ndarray:
    """(H, W, C) float32, C = R, G, B and A where present (see the module
    note)."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _header(path, data)
    for need in ("channels", "compression", "dataWindow"):
        if need not in attrs:
            raise ValueError(f"{path}: OpenEXR header without {need}")
    comp = attrs["compression"][1][0]
    name, lines = COMPRESSION.get(comp, (f"compression {comp}", 0))
    if name not in READ:
        raise ValueError(f"{path}: {name} compression is not read (NONE, "
                         f"RLE, ZIPS and ZIP are)")
    channels = _channels(path, attrs["channels"][1])
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    line_bytes = sum(w * dt.itemsize for _, dt in channels)
    n_chunks = -(-h // lines)
    offsets = struct.unpack(f"<{n_chunks}Q", data[pos:pos + 8 * n_chunks])
    planes = {n: np.empty((h, w), dt) for n, dt in channels}
    seen = np.zeros(h, bool)
    for off in offsets:
        y, size = struct.unpack("<ii", data[off:off + 8])
        block = data[off + 8:off + 8 + size]
        rows = min(lines, ymax - y + 1)
        want = rows * line_bytes
        if y < ymin or rows <= 0 or len(block) != size:
            raise ValueError(f"{path}: bad or truncated block at y={y}")
        if size < want and name == "RLE":
            block = _unpredict(_rle(path, block, want))
        elif size < want and name in ("ZIPS", "ZIP"):
            block = _unpredict(zlib.decompress(block))
        if len(block) != want:
            raise ValueError(f"{path}: block at y={y} holds {len(block)} "
                             f"bytes, {want} expected")
        at = 0
        for r in range(y - ymin, y - ymin + rows):
            for n, dt in channels:
                k = w * dt.itemsize
                planes[n][r] = np.frombuffer(block[at:at + k], dt)
                at += k
            seen[r] = True
    if not seen.all():
        raise ValueError(f"{path}: scanlines missing from the offset table")
    names = [c for c in ("R", "G", "B", "A") if c in planes]
    if names[:3] != ["R", "G", "B"]:
        raise ValueError(f"{path}: channels {sorted(planes)}; R, G and B "
                         f"are read")
    return np.stack([planes[c].astype(np.float32) for c in names], axis=-1)
