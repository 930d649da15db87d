"""OpenEXR input without imageio: the HDR frames of RTMV scenes, which
`ngp_pl_torch.misc.prepare_rtmv` turns into the PNGs the `rtmv` loader
reads.

`read_exr` reads a single-part scanline OpenEXR file (the layout of the
OpenEXR specification, "OpenEXR File Layout") whose channels are HALF,
FLOAT or UINT, one sample per pixel, stored uncompressed or compressed with
RLE, ZIPS (zlib, one scanline a block), ZIP (zlib, 16 scanlines a block,
the OpenEXR library's default), PIZ (wavelet and Huffman, 32 scanlines a
block) or PXR24 (zlib of byte planes, 16 scanlines a block; lossy for
FLOAT, whose values it stores to 24 bits).  RLE and the zlib methods undo
the byte predictor and then the split of each block into its even and odd
bytes.  The PIZ and PXR24 decoders follow OpenEXR's ImfPizCompressor.cpp,
ImfHuf.cpp, ImfWav.cpp and ImfPxr24Compressor.cpp; PIZ's Huffman and
wavelet stages run in the port's host library (`ngp_pl_torch.native`),
the rest in numpy (`_piz`, `_pxr24`).  Channels are stored in name order
(B, G, R, A); the result is (H, W, C) float32 in R, G, B(, A) order over
the data window, wherever that window starts, whichever line order the
file was written in: what imageio hands the JAX package's script for a
HALF or FLOAT file.  Other channels are left out.  B44, B44A, DWAA, DWAB
and HTJ2K compression, tiled, multi-part and deep files, and subsampled
channels raise, naming the file and what it holds.
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
READ = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24")
# pixel type -> numpy little-endian dtype
PIXEL = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
PIZ_BITMAP = 8192               # bytes of PIZ's bitmap of the u16 values
PXR24_BYTES = {"u": 4, "f2": 2, "f4": 3}   # byte planes by channel kind


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


def _inflate(path, y: int, block: bytes) -> bytes:
    try:
        return zlib.decompress(block)
    except zlib.error as e:
        raise ValueError(f"{path}: block at y={y} does not inflate: "
                         f"{e}") from None


def _piz(path, y: int, block: bytes, rows: int, w: int, channels) -> bytes:
    """A PIZ block (ImfPizCompressor.cpp's uncompress) as its scanlines'
    bytes.  The block holds the u16 range's bitmap (bytes minNonZero ..
    maxNonZero of 8192; none when min > max), the Huffman-coded length
    and data, which decode to each channel's rows x w values as u16 planes
    (1 for HALF, 2 interleaved for FLOAT and UINT) one channel after the
    other; each plane goes through the inverse wavelet, then every value
    through the bitmap's table (rank k -> the k-th value present, 0
    always first)."""
    from ngp_pl_torch import native

    def bad(what):
        return ValueError(f"{path}: PIZ block at y={y} {what}")

    if len(block) < 8:
        raise bad("ends early")
    lo, hi = struct.unpack("<HH", block[:4])
    if hi >= PIZ_BITMAP:
        raise bad(f"has a bitmap range up to {hi}")
    bitmap = np.zeros(PIZ_BITMAP, np.uint8)
    pos = 4
    if lo <= hi:
        bitmap[lo:hi + 1] = np.frombuffer(block, np.uint8, hi - lo + 1, pos)
        pos += hi - lo + 1
    present = np.unpackbits(bitmap, bitorder="little").astype(bool)
    present[0] = True
    lut = np.zeros(1 << 16, np.uint16)
    values = np.flatnonzero(present).astype(np.uint16)
    lut[:values.size] = values
    max_value = values.size - 1
    if len(block) < pos + 4:
        raise bad("ends early")
    (length,) = struct.unpack("<i", block[pos:pos + 4])
    pos += 4
    if length < 0 or pos + length > len(block):
        raise bad(f"holds {len(block) - pos} bytes of Huffman data, "
                  f"{length} announced")
    sizes = [dt.itemsize // 2 for _, dt in channels]
    try:
        data = native.piz_huf_decode(block[pos:pos + length],
                                     rows * w * sum(sizes))
    except ValueError as e:
        raise bad(str(e)) from None
    start = 0
    for size in sizes:
        for j in range(size):
            native.piz_wav2_decode(data, start + j, w, size, rows, w * size,
                                   max_value)
        start += rows * w * size
    data = lut[data]
    planes, start = [], 0
    for size in sizes:
        n = rows * w * size
        planes.append(data[start:start + n].reshape(rows, w * size))
        start += n
    return np.concatenate(planes, axis=1).astype("<u2").tobytes()


def _pxr24(path, y: int, block: bytes, rows: int, w: int, channels) -> bytes:
    """A PXR24 block (ImfPxr24Compressor.cpp's uncompress) as its
    scanlines' bytes: zlib-inflated, each line's channels in turn hold
    their values' differences from the value before (0 before the first)
    as byte planes, most significant first: 2 for HALF, 4 for UINT and 3
    for FLOAT, whose value is the 24 bits << 8."""
    raw = np.frombuffer(_inflate(path, y, block), np.uint8)
    kinds = [dt.kind + (str(dt.itemsize) if dt.kind == "f" else "")
             for _, dt in channels]
    line = sum(w * PXR24_BYTES[k] for k in kinds)
    if raw.size != rows * line:
        raise ValueError(f"{path}: PXR24 block at y={y} inflates to "
                         f"{raw.size} bytes, {rows * line} expected")
    raw = raw.reshape(rows, line)
    out, at = [], 0
    for kind in kinds:
        nb = PXR24_BYTES[kind]
        planes = raw[:, at:at + nb * w].reshape(rows, nb, w).astype(np.uint32)
        at += nb * w
        top = 8 if nb == 2 else 24         # the first plane's shift
        diff = np.zeros((rows, w), np.uint32)
        for b in range(nb):
            diff |= planes[:, b] << np.uint32(top - 8 * b)
        if nb == 2:
            vals = np.cumsum(diff.astype(np.uint16), axis=1, dtype=np.uint16)
            out.append(vals.astype("<u2").view(np.uint8))
        else:
            vals = np.cumsum(diff, axis=1, dtype=np.uint32)
            out.append(vals.astype("<u4").view(np.uint8))
    return np.concatenate(out, axis=1).tobytes()


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
                         f"RLE, ZIPS, ZIP, PIZ and PXR24 are)")
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
            block = _unpredict(_inflate(path, y, block))
        elif size < want and name == "PIZ":
            block = _piz(path, y, block, rows, w, channels)
        elif size < want and name == "PXR24":
            block = _pxr24(path, y, block, rows, w, channels)
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
