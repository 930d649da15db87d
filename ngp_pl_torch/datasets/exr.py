"""OpenEXR input without imageio: the HDR frames of RTMV scenes, which
`ngp_pl_torch.misc.prepare_rtmv` turns into the PNGs the `rtmv` loader
reads.

`read_exr` reads part 0 of an OpenEXR file (the layout of the OpenEXR
specification, "OpenEXR File Layout"), as OpenEXR's RgbaInputFile does for
imageio: a scanline part, or level 0 of a tiled one (ONE_LEVEL, MIPMAP or
RIPMAP), in a single-part or a multi-part file, whose channels are HALF,
FLOAT or UINT, one sample per pixel, stored uncompressed or compressed
with RLE, ZIPS (zlib, one scanline a block), ZIP (zlib, 16 scanlines a
block, the OpenEXR library's default), PIZ (wavelet and Huffman, 32),
PXR24 (zlib of byte planes, 16; lossy for FLOAT, whose values it stores
to 24 bits), B44 or B44A (4x4 blocks of HALF in 14 bytes, or 3 for a flat
one in B44A; 32; lossy) or DWAA or DWAB (a DCT of 8x8 blocks of HALF and
FLOAT colour channels, 32 and 256; lossy).  A tile is one block of its
rows and columns, clipped at the data window's edge, in every method.
RLE and the zlib methods undo the byte predictor and then the split of
each block into its even and odd bytes.  The other decoders follow
OpenEXR's ImfPizCompressor.cpp, ImfHuf.cpp, ImfWav.cpp,
ImfPxr24Compressor.cpp, ImfB44Compressor.cpp and ImfDwaCompressor.cpp:
PIZ's Huffman and wavelet stages and DWA's per-block AC decode, inverse
DCT and colour transform run in the port's host library
(`ngp_pl_torch.native`), the rest in numpy.  Channels are stored in name
order (B, G, R, A); the result is (H, W, C) float32 in R, G, B(, A) order
over the data window, wherever that window starts, whichever line order
the file was written in: what imageio hands the JAX package's script for
a HALF or FLOAT file.  Other channels are left out.  HTJ2K compression,
deep parts and subsampled channels raise, naming the file and what it
holds, as does anything malformed.
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import NamedTuple

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000
# compression id -> (name, scanlines per block)
COMPRESSION = {0: ("NONE", 1), 1: ("RLE", 1), 2: ("ZIPS", 1), 3: ("ZIP", 16),
               4: ("PIZ", 32), 5: ("PXR24", 16), 6: ("B44", 32),
               7: ("B44A", 32), 8: ("DWAA", 32), 9: ("DWAB", 256),
               10: ("HTJ2K", 16)}
# pixel type -> numpy little-endian dtype
PIXEL = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
PIXEL_TYPE = {dt: k for k, dt in PIXEL.items()}
PIZ_BITMAP = 8192               # bytes of PIZ's bitmap of the u16 values
PXR24_BYTES = {"u": 4, "f2": 2, "f4": 3}   # byte planes by channel kind
# a tiled part's level modes (the low 4 bits of the tiledesc's mode byte;
# the high 4 are the rounding mode, 0 down and 1 up)
LEVEL_MODES = ("ONE_LEVEL", "MIPMAP", "RIPMAP")
PART_TYPES = ("scanlineimage", "tiledimage")
DEEP_TYPES = ("deepscanline", "deeptile")
B44_FLAT = 13 << 2      # a third byte this large starts a 3-byte block
HALF_MAX_LOG8 = 8 * np.log(np.float32(65504.0))    # b44ExpLogTable.cpp
# DWA (ImfDwaCompressor.cpp): its block's 11 u64 counters, its schemes,
# and the channel rules of a version-1 block, which carries none:
# (suffix, scheme, pixel type, index in an R, G, B set, case-insensitive)
DWA_COUNTERS = struct.Struct("<11Q")
DWA_UNKNOWN, DWA_LOSSY_DCT, DWA_RLE = 0, 1, 2
DWA_HUFFMAN, DWA_DEFLATE = 0, 1
DWA_LEGACY_RULES = tuple(
    (suffix, DWA_LOSSY_DCT, ptype, csc, True)
    for names, csc in ((("r", "red"), 0), (("g", "grn", "green"), 1),
                       (("b", "blu", "blue"), 2), (("y", "by", "ry"), -1))
    for suffix in names for ptype in (1, 2)) + tuple(
    ("a", DWA_RLE, ptype, -1, True) for ptype in (0, 1, 2))


class Channel(NamedTuple):
    name: str
    dtype: np.dtype
    linear: bool            # the chlist's pLinear flag


class Chunk(NamedTuple):
    """One block of part 0's level 0: its place in the data window and
    the coordinates its chunk header must hold."""
    row: int
    col: int
    rows: int
    cols: int
    coords: tuple


def _cstr(path, data: bytes, pos: int, end: int = None):
    stop = data.find(b"\0", pos, len(data) if end is None else end)
    if stop < 0:
        raise ValueError(f"{path}: truncated OpenEXR header")
    return data[pos:stop].decode("latin-1"), stop + 1


def _attributes(path, data: bytes, pos: int):
    """One header's attributes by name as (type, bytes), and the position
    after the null byte that ends it."""
    attrs = {}
    while data[pos:pos + 1] != b"\0":
        name, pos = _cstr(path, data, pos)
        kind, pos = _cstr(path, data, pos)
        if pos + 4 > len(data):
            raise ValueError(f"{path}: truncated OpenEXR header")
        (size,) = struct.unpack_from("<i", data, pos)
        if size < 0 or pos + 4 + size > len(data):
            raise ValueError(f"{path}: truncated OpenEXR header")
        attrs[name] = (kind, data[pos + 4:pos + 4 + size])
        pos += 4 + size
    if pos >= len(data):
        raise ValueError(f"{path}: truncated OpenEXR header")
    return attrs, pos + 1


def _int(attrs, name) -> int:
    return struct.unpack("<i", attrs[name][1][:4])[0]


def _part0(path, data: bytes):
    """(part 0's attributes, whether it is tiled, whether the file is
    multi-part, where part 0's offset table starts, where the last part's
    ends).  In a multi-part file the headers end at an empty one and the
    offset tables follow in part order, each of its part's chunkCount."""
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    (version,) = struct.unpack("<I", data[4:8])
    if not version & MULTIPART:
        if version & DEEP:
            raise ValueError(f"{path}: deep OpenEXR files are not read")
        attrs, table = _attributes(path, data, 8)
        tiled = bool(version & TILED)
        if tiled and "tiles" not in attrs:
            raise ValueError(f"{path}: the tiled flag is set but the header "
                             f"has no tiles attribute")
        return attrs, tiled, False, table, None
    headers, pos = [], 8
    while data[pos:pos + 1] != b"\0":
        attrs, pos = _attributes(path, data, pos)
        headers.append(attrs)
    if not headers:
        raise ValueError(f"{path}: the multi-part flag is set but the file "
                         f"has no part headers")
    for i, attrs in enumerate(headers):
        for need in ("name", "type", "chunkCount"):
            if need not in attrs:
                raise ValueError(f"{path}: multi-part file whose part {i} "
                                 f"has no {need} attribute")
    attrs = headers[0]
    kind = attrs["type"][1].split(b"\0")[0].decode("latin-1")
    if kind in DEEP_TYPES:
        raise ValueError(f"{path}: part 0 is deep ({kind}); deep OpenEXR "
                         f"parts are not read")
    if kind not in PART_TYPES:
        raise ValueError(f"{path}: part 0 has type {kind!r}")
    tiled = kind == "tiledimage"
    if tiled and "tiles" not in attrs:
        raise ValueError(f"{path}: part 0 is tiled but has no tiles "
                         f"attribute")
    counts = [_int(a, "chunkCount") for a in headers]
    if min(counts) < 0:
        raise ValueError(f"{path}: a part has chunkCount {min(counts)}")
    return attrs, tiled, True, pos + 1, pos + 1 + 8 * sum(counts)


def _levels(path, w: int, h: int, mode: int):
    """(width, height) of every level of a tiled part, in the offset
    table's order (ImfTiledMisc.cpp: levelSize, and the level counts of
    roundLog2 + 1, floor or ceiling by the rounding mode; RIPMAP's levels
    x fastest)."""
    level, rounding = mode & 0xF, mode >> 4
    if level >= len(LEVEL_MODES) or rounding > 1:
        raise ValueError(f"{path}: tiles have level mode {level}, rounding "
                         f"mode {rounding}")

    def count(n):
        return (n - 1).bit_length() + 1 if rounding else n.bit_length()

    def size(n, l):
        s = n >> l
        return max(s + (rounding and s << l < n), 1)

    if level == 0:
        return [(w, h)]
    if level == 1:
        return [(size(w, l), size(h, l)) for l in range(count(max(w, h)))]
    return [(size(w, lx), size(h, ly)) for ly in range(count(h))
            for lx in range(count(w))]


def _chunks(path, attrs, tiled: bool, w: int, h: int, ymin: int,
            lines: int):
    """(level 0's chunks in the offset table's order, the chunk count of
    every level).  A scanline block of `lines` rows holds its first row's
    y; a tile (tx, ty, 0, 0), rows first."""
    if not tiled:
        out = [Chunk(r, 0, min(lines, h - r), w, (ymin + r,))
               for r in range(0, h, lines)]
        return out, len(out)
    raw = attrs["tiles"][1]
    if len(raw) < 9:
        raise ValueError(f"{path}: tiles attribute of {len(raw)} bytes")
    tw, th, mode = struct.unpack("<IIB", raw[:9])
    if tw < 1 or th < 1:
        raise ValueError(f"{path}: tiles of {tw}x{th}")
    total = sum(-(-lw // tw) * -(-lh // th)
                for lw, lh in _levels(path, w, h, mode))
    out = [Chunk(ty * th, tx * tw, min(th, h - ty * th), min(tw, w - tx * tw),
                 (tx, ty, 0, 0))
           for ty in range(-(-h // th)) for tx in range(-(-w // tw))]
    return out, total


def _channels(path, raw: bytes):
    """[Channel] of a chlist, in the file's (name) order."""
    out, pos = [], 0
    while raw[pos:pos + 1] != b"\0":
        name, pos = _cstr(path, raw, pos)
        if pos + 16 > len(raw):
            raise ValueError(f"{path}: truncated channel list")
        ptype, linear, _, xs, ys = struct.unpack("<iB3sii",
                                                 raw[pos:pos + 16])
        pos += 16
        if ptype not in PIXEL:
            raise ValueError(f"{path}: channel {name} has pixel type "
                             f"{ptype}")
        if xs != 1 or ys != 1:
            raise ValueError(f"{path}: channel {name} is subsampled "
                             f"({xs}x{ys}); not read")
        out.append(Channel(name, PIXEL[ptype], bool(linear)))
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
        raise ValueError(f"{path}: RLE data inflates to {len(out)} bytes, "
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


def _inflate(path, where: str, block: bytes) -> bytes:
    try:
        return zlib.decompress(block)
    except zlib.error as e:
        raise ValueError(f"{path}: {where} does not inflate: {e}") from None


def _line_bytes(w: int, channels) -> int:
    return sum(w * c.dtype.itemsize for c in channels)


def _rle_block(path, where, block, rows, w, channels) -> np.ndarray:
    return np.frombuffer(_unpredict(
        _rle(path, block, rows * _line_bytes(w, channels))), np.uint8)


def _zip_block(path, where, block, rows, w, channels) -> np.ndarray:
    return np.frombuffer(_unpredict(_inflate(path, where, block)), np.uint8)


def _piz(path, where, block: bytes, rows: int, w: int, channels):
    """A PIZ block (ImfPizCompressor.cpp's uncompress) as its scanlines'
    u16 values.  The block holds the u16 range's bitmap (bytes minNonZero
    .. maxNonZero of 8192; none when min > max), the Huffman-coded length
    and data, which decode to each channel's rows x w values as u16 planes
    (1 for HALF, 2 interleaved for FLOAT and UINT) one channel after the
    other; each plane goes through the inverse wavelet, then every value
    through the bitmap's table (rank k -> the k-th value present, 0
    always first)."""
    from ngp_pl_torch import native

    def bad(what):
        return ValueError(f"{path}: PIZ {where} {what}")

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
    sizes = [c.dtype.itemsize // 2 for c in channels]
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
    return np.concatenate(planes, axis=1).astype("<u2")


def _pxr24(path, where, block: bytes, rows: int, w: int, channels):
    """A PXR24 block (ImfPxr24Compressor.cpp's uncompress) as its
    scanlines' bytes: zlib-inflated, each line's channels in turn hold
    their values' differences from the value before (0 before the first)
    as byte planes, most significant first: 2 for HALF, 4 for UINT and 3
    for FLOAT, whose value is the 24 bits << 8."""
    raw = np.frombuffer(_inflate(path, where, block), np.uint8)
    kinds = [c.dtype.kind + (str(c.dtype.itemsize) if c.dtype.kind == "f"
                             else "") for c in channels]
    line = sum(w * PXR24_BYTES[k] for k in kinds)
    if raw.size != rows * line:
        raise ValueError(f"{path}: PXR24 {where} inflates to {raw.size} "
                         f"bytes, {rows * line} expected")
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
    return np.concatenate(out, axis=1)


# --- B44 and B44A (ImfB44Compressor.cpp) -----------------------------------


@functools.lru_cache(maxsize=1)
def _b44_exp_table() -> np.ndarray:
    """b44ExpLogTable.cpp's expTable, which a pLinear channel's values go
    through: half bits -> half(exp(h / 8)); HALF_MAX from 8 ln(HALF_MAX)
    up, 0 for infinities and NaNs.  Read-only."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    f = h.astype(np.float32)
    finite = np.isfinite(f)
    with np.errstate(over="ignore"):
        e = np.exp(np.where(finite, f, 0).astype(np.float64) / 8)
        out = e.astype(np.float32).astype(np.float16)
    out[f >= HALF_MAX_LOG8] = np.float16(65504.0)
    out[~finite] = 0
    out = out.view(np.uint16)
    out.flags.writeable = False
    return out


def _b44_starts(path, where, buf: np.ndarray, start: int, n: int):
    """Where each of n 4x4 blocks from `start` begins, and where the last
    ends: 14 bytes each, or 3 where the third byte is at least B44_FLAT.
    When every block is one size that is one stride; otherwise each
    block's successor is known at every byte of the stretch, so the chain
    is found by pointer doubling (log2 n gathers), not a loop over
    blocks."""
    size = buf.size
    for step in (14, 3):
        starts = start + step * np.arange(n)
        if starts[-1] + 3 <= size and np.array_equal(
                buf[starts + 2] >= B44_FLAT, np.full(n, step == 3)):
            break
    else:
        stop = min(size, start + 14 * n)
        at = np.arange(start, stop + 1)
        third = np.zeros(at.size, bool)
        third[at + 2 < size] = buf[at[at + 2 < size] + 2] >= B44_FLAT
        nxt = np.minimum(at + np.where(third, 3, 14), stop) - start
        starts, jump = np.array([0]), nxt
        while starts.size < n:
            starts = np.concatenate([starts, jump[starts]])
            jump = jump[jump]
        starts = starts[:n] + start
    third = buf[np.minimum(starts + 2, size - 1)] >= B44_FLAT
    end = int(starts[-1] + (3 if third[-1] else 14))
    if end > size:
        raise ValueError(f"{path}: B44 {where} ends inside a 4x4 block")
    return starts, end


def _b44_paths() -> np.ndarray:
    """(15, 16) 0/1: the differences summed from the first value to each
    of the 16 (the first column down to the value's row, then across)."""
    paths = np.zeros((15, 16))
    for row in range(4):
        for col in range(4):
            paths[:row, 4 * row + col] = 1
            paths[[3 + 4 * k + row for k in range(col)], 4 * row + col] = 1
    return paths


B44_PATHS = _b44_paths()


def _b44_unpack(blocks: np.ndarray) -> np.ndarray:
    """unpack14 and unpack3 on (n, 14) bytes: (n, 16) u16 values, rows of
    the 4x4 block in turn.  14 bytes hold the first value (16 bits), then
    in four groups of 3 bytes four 6-bit fields each: a shift and 15
    differences + 32 (the column of the first value down, then each row
    across), scaled by 2^shift; the values are then mapped back from their
    ordered form (sign bit set: positive).  The sums of at most six
    differences stay below 2^22, so a float64 product (B44_PATHS) gives
    them exactly."""
    n = len(blocks)
    g = blocks[:, 2:14].reshape(n, 4, 3).astype(np.int64)
    v = g[..., 0] << 16 | g[..., 1] << 8 | g[..., 2]
    f = ((v[..., None] >> np.array([18, 12, 6, 0])) & 63).reshape(n, 16)
    flat = blocks[:, 2:3] >= B44_FLAT
    d = (f[:, 1:] - 0x20) << np.where(flat, 0, f[:, :1])
    s0 = blocks[:, :1].astype(np.int64) << 8 | blocks[:, 1:2]
    s = s0 + (d.astype(np.float64) @ B44_PATHS).astype(np.int64)
    s = np.where(flat, s0, s) & 0xFFFF
    return np.where(s & 0x8000, s & 0x7FFF, ~s & 0xFFFF).astype(np.uint16)


def _b44(path, where, block: bytes, rows: int, w: int, channels):
    """A B44 or B44A block (ImfB44Compressor.cpp's uncompress) as its
    scanlines' bytes.  Channel by channel: FLOAT and UINT as they are;
    HALF as ceil(rows / 4) x ceil(w / 4) blocks, row by row, cut back at
    the right and bottom edges (where the encoder repeated the last column
    and row), through expTable where pLinear is set.  Both methods share
    the decoder: a 3-byte block can only be B44A's."""
    buf = np.frombuffer(block, np.uint8)
    padded = np.concatenate([buf, np.zeros(14, np.uint8)])
    out, pos = [], 0
    for c in channels:
        if c.dtype != np.float16:
            n = rows * w * c.dtype.itemsize
            if pos + n > buf.size:
                raise ValueError(f"{path}: B44 {where} ends inside channel "
                                 f"{c.name}")
            out.append(buf[pos:pos + n].reshape(rows, -1))
            pos += n
            continue
        by, bx = -(-rows // 4), -(-w // 4)
        starts, pos = _b44_starts(path, where, buf, pos, by * bx)
        s = _b44_unpack(padded[starts[:, None] + np.arange(14)])
        if c.linear:
            s = _b44_exp_table()[s]
        s = s.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(
            4 * by, 4 * bx)[:rows, :w]
        out.append(s.astype("<u2").view(np.uint8))
    if pos != buf.size:
        raise ValueError(f"{path}: B44 {where} holds {buf.size - pos} bytes "
                         f"past its channels")
    return np.concatenate(out, axis=1)


# --- DWAA and DWAB (ImfDwaCompressor.cpp) ----------------------------------


@functools.lru_cache(maxsize=1)
def dwa_to_linear() -> np.ndarray:
    """dwaLookups.cpp's dwaCompressorToLinear: a nonlinear half's bits ->
    its linear half's; |h| <= 1 as |h|^2.2f, above as logBase^(|h| - 1)
    with logBase = float(e^2.2), the sign kept, each power in float (here
    rounded to float from float64) and then to half; infinities and NaNs
    to 0.  Read-only."""
    f = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(
        np.float32)
    log_base = np.float64(np.float32(2.7182818 ** 2.2))
    with np.errstate(over="ignore", invalid="ignore"):
        a = np.abs(f).astype(np.float64)
        low = np.power(a, np.float64(np.float32(2.2)))
        high = np.power(log_base, (np.abs(f) - np.float32(1.0)).astype(
            np.float64))
        p = np.where(a <= 1.0, low, high).astype(np.float32)
        out = (np.where(f < 0, -p, p)).astype(np.float16).view(np.uint16)
    out[(np.arange(1 << 16) & 0x7C00) == 0x7C00] = 0
    out.flags.writeable = False
    return out


def _dwa_rules(path, where, block: bytes, pos: int):
    """A version-2 block's channel rules (Classifier's write: the suffix
    and its null byte, a byte of csc index + 1 << 4 | scheme << 2 |
    case-insensitive, a byte of pixel type), after their u16 byte count
    (the count included); and the position after them."""
    if pos + 2 > len(block):
        raise ValueError(f"{path}: DWA {where} ends in its header")
    (size,) = struct.unpack_from("<H", block, pos)
    end = pos + size
    if size < 2 or end > len(block):
        raise ValueError(f"{path}: DWA {where} has a rule table of {size} "
                         f"bytes")
    rules, pos = [], pos + 2
    while pos < end:
        suffix, pos = _cstr(path, block, pos, end)
        if pos + 2 > end:
            raise ValueError(f"{path}: DWA {where} has a cut rule")
        value, ptype = block[pos], block[pos + 1]
        csc, scheme = (value >> 4) - 1, (value >> 2) & 3
        if csc > 2 or scheme > DWA_RLE or ptype not in PIXEL:
            raise ValueError(f"{path}: DWA {where} has a rule of byte "
                             f"{value:#04x}, type {ptype}")
        rules.append((suffix, scheme, ptype, csc, bool(value & 1)))
        pos += 2
    return rules, end


def _dwa_classify(channels, rules):
    """Each channel's scheme, and the R, G, B sets in the order of their
    prefixes (classifyChannels: the name after its last dot is matched
    against every rule of its pixel type, the last match deciding; a set
    is kept where all three colour indices were found)."""
    schemes, sets = [], {}
    for i, c in enumerate(channels):
        prefix, _, suffix = c.name.rpartition(".")
        idx = sets.setdefault(prefix, [-1, -1, -1])
        scheme = DWA_UNKNOWN
        for rule, sch, ptype, csc, fold in rules:
            if ptype == PIXEL_TYPE[c.dtype] and rule == (
                    suffix.lower() if fold else suffix):
                scheme = sch
                if csc >= 0:
                    idx[csc] = i
        schemes.append(scheme)
    return schemes, [idx for _, idx in sorted(sets.items()) if min(idx) >= 0]


def _dwa(path, where, block: bytes, rows: int, w: int, channels):
    """A DWAA or DWAB block (DwaCompressor::uncompress) as its scanlines'
    bytes.  After the counters (version; UNKNOWN's raw and compressed
    sizes; AC's, DC's and RLE's compressed sizes; RLE's size after zlib
    and after its run-length code; the AC and DC value counts; the AC
    method) and, in version 2, the channel rules, four sections follow:
    UNKNOWN channels (zlib of each one's rows), AC (OpenEXR's Huffman code
    or zlib of u16 values), DC (zlib with the ZIP predictor, u16 values)
    and RLE channels (zlib, then the run-length code, each channel's byte
    planes).  LOSSY_DCT channels decode in the host library: each R, G, B
    set, then each other one alone, taking their blocks' DC values plane
    by plane and their AC values in turn; every value then goes through
    `dwa_to_linear` (but a lone pLinear channel's), and a FLOAT channel
    widens its halves."""
    from ngp_pl_torch import native

    def bad(what):
        return ValueError(f"{path}: DWA {where} {what}")

    if len(block) < DWA_COUNTERS.size:
        raise bad("ends in its counters")
    (version, unk_raw, unk_size, ac_size, dc_size, rle_size, rle_coded,
     rle_raw, ac_count, dc_count, ac_method) = DWA_COUNTERS.unpack_from(block)
    if version > 2:
        raise bad(f"has version {version}")
    rules, pos = DWA_LEGACY_RULES, DWA_COUNTERS.size
    if version == 2:
        rules, pos = _dwa_rules(path, where, block, pos)
    sections = []
    for size in (unk_size, ac_size, dc_size, rle_size):
        if size > len(block) - pos:
            raise bad(f"holds {len(block) - pos} bytes for a section of "
                      f"{size}")
        sections.append(block[pos:pos + size])
        pos += size
    unk, ac, dc, rle = sections
    schemes, sets = _dwa_classify(channels, rules)
    n_px = rows * w
    want = {s: sum(n_px * c.dtype.itemsize
                   for c, sch in zip(channels, schemes) if sch == s)
            for s in (DWA_UNKNOWN, DWA_RLE)}
    if want[DWA_UNKNOWN]:
        unk = _inflate(path, f"DWA {where}'s UNKNOWN section", unk)
        if len(unk) != unk_raw or unk_raw != want[DWA_UNKNOWN]:
            raise bad(f"holds {len(unk)} bytes of UNKNOWN channels, "
                      f"{want[DWA_UNKNOWN]} expected")
    if want[DWA_RLE]:
        rle = _inflate(path, f"DWA {where}'s RLE section", rle)
        if len(rle) != rle_coded or rle_raw != want[DWA_RLE]:
            raise bad(f"holds {rle_raw} bytes of RLE channels, "
                      f"{want[DWA_RLE]} expected")
        rle = _rle(path, rle, rle_raw)
    if ac_size:
        if ac_method == DWA_HUFFMAN:
            try:
                ac = native.piz_huf_decode(ac, ac_count)
            except ValueError as e:
                raise bad(f"AC section: {e}") from None
        elif ac_method == DWA_DEFLATE:
            ac = _inflate(path, f"DWA {where}'s AC section", ac)
            if len(ac) != 2 * ac_count:
                raise bad(f"holds {len(ac) // 2} AC values, {ac_count} "
                          f"announced")
            ac = np.frombuffer(ac, "<u2").astype(np.uint16)
        else:
            raise bad(f"has AC method {ac_method}")
    else:
        ac = np.zeros(0, np.uint16)
    if dc_size:
        dc = _unpredict(_inflate(path, f"DWA {where}'s DC section", dc))
        if len(dc) != 2 * dc_count:
            raise bad(f"holds {len(dc) // 2} DC values, {dc_count} "
                      f"announced")
    dc = np.frombuffer(dc, "<u2").astype(np.uint16)
    n_blocks = -(-rows // 8) * -(-w // 8)
    halves, ac_at, dc_at = {}, 0, 0
    lone = [[i] for i, s in enumerate(schemes) if s == DWA_LOSSY_DCT
            and not any(i in s3 for s3 in sets)]
    for group in sets + lone:
        for i in group:
            if channels[i].dtype == np.uint32:
                raise bad(f"codes UINT channel {channels[i].name} as "
                          f"LOSSY_DCT")
        if dc_at + len(group) * n_blocks > dc.size:
            raise bad("runs out of DC values")
        try:
            planes, used = native.dwa_dct_decode(
                ac[ac_at:], dc[dc_at:dc_at + len(group) * n_blocks],
                len(group), w, rows)
        except ValueError as e:
            raise bad(str(e)) from None
        ac_at += used
        dc_at += len(group) * n_blocks
        for i, plane in zip(group, planes):
            linear = len(group) == 1 and channels[i].linear
            halves[i] = plane if linear else dwa_to_linear()[plane]
    out, at = [], {DWA_UNKNOWN: 0, DWA_RLE: 0}
    for i, (c, scheme) in enumerate(zip(channels, schemes)):
        size = c.dtype.itemsize
        if i in halves:
            h = halves[i].view(np.float16)
            out.append((h if size == 2 else h.astype(np.float32))
                       .astype(c.dtype).view(np.uint8))
        elif scheme == DWA_RLE:
            planes = np.frombuffer(rle, np.uint8, size * n_px, at[scheme])
            out.append(planes.reshape(size, rows, w).transpose(1, 2, 0)
                       .reshape(rows, w * size))
            at[scheme] += size * n_px
        else:
            out.append(np.frombuffer(unk, np.uint8, size * n_px, at[scheme])
                       .reshape(rows, w * size))
            at[scheme] += size * n_px
    return np.concatenate(out, axis=1)


# compression -> decode(path, where, block, rows, width, channels), which
# returns the block's scanlines' bytes as an array (rows x the channels'
# widths); NONE has no decoder, and a block no shorter than its scanlines
# is stored as it is in every method
DECODE = {"NONE": None, "RLE": _rle_block, "ZIPS": _zip_block,
          "ZIP": _zip_block, "PIZ": _piz, "PXR24": _pxr24, "B44": _b44,
          "B44A": _b44, "DWAA": _dwa, "DWAB": _dwa}


def read_exr(path) -> np.ndarray:
    """(H, W, C) float32, C = R, G, B and A where present (see the module
    note)."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, tiled, multi, table, tables_end = _part0(path, data)
    for need in ("channels", "compression", "dataWindow"):
        if need not in attrs:
            raise ValueError(f"{path}: OpenEXR header without {need}")
    comp = attrs["compression"][1][0]
    name, lines = COMPRESSION.get(comp, (f"compression {comp}", 0))
    if name not in DECODE:
        raise ValueError(f"{path}: {name} compression is not read "
                         f"({', '.join(DECODE)} are)")
    decode = DECODE[name]
    channels = _channels(path, attrs["channels"][1])
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    if w < 1 or h < 1:
        raise ValueError(f"{path}: data window of {w}x{h}")
    chunks, total = _chunks(path, attrs, tiled, w, h, ymin, lines)
    if multi and total != _int(attrs, "chunkCount"):
        raise ValueError(f"{path}: part 0's chunkCount is "
                         f"{_int(attrs, 'chunkCount')}, its levels hold "
                         f"{total} chunks")
    if tables_end is None:
        tables_end = table + 8 * total
    if tables_end > len(data):
        raise ValueError(f"{path}: truncated offset table")
    offsets = struct.unpack_from(f"<{len(chunks)}Q", data, table)
    head = struct.Struct("<" + "i" * (multi + len(chunks[0].coords) + 1))
    planes = {c.name: np.empty((h, w), c.dtype) for c in channels}
    for off, ck in zip(offsets, chunks):
        where = (f"tile {ck.coords[:2]}" if tiled
                 else f"block at y={ck.coords[0]}")
        if off < tables_end or off + head.size > len(data):
            raise ValueError(f"{path}: {where} has offset {off}, outside "
                             f"the file's chunks")
        fields = head.unpack_from(data, off)
        if multi and fields[0] != 0:
            raise ValueError(f"{path}: {where}'s chunk is of part "
                             f"{fields[0]}")
        coords, size = fields[multi:-1], fields[-1]
        if coords != ck.coords:
            raise ValueError(f"{path}: {where}'s chunk holds {coords}")
        block = data[off + head.size:off + head.size + size]
        if size < 0 or len(block) != size:
            raise ValueError(f"{path}: bad or truncated {where}")
        want = ck.rows * _line_bytes(ck.cols, channels)
        raw = np.frombuffer(block, np.uint8)
        if size < want and decode is not None:
            raw = decode(path, where, block, ck.rows, ck.cols,
                         channels).reshape(-1).view(np.uint8)
        if raw.size != want:
            raise ValueError(f"{path}: {where} holds {raw.size} bytes, "
                             f"{want} expected")
        # the block's scanlines as one (rows, bytes) array, split by channel
        raw, at = raw.reshape(ck.rows, -1), 0
        for c in channels:
            k = ck.cols * c.dtype.itemsize
            planes[c.name][ck.row:ck.row + ck.rows, ck.col:ck.col + ck.cols] \
                = raw[:, at:at + k].view(c.dtype)
            at += k
    names = [c for c in ("R", "G", "B", "A") if c in planes]
    if names[:3] != ["R", "G", "B"]:
        raise ValueError(f"{path}: channels {sorted(planes)}; R, G and B "
                         f"are read")
    return np.stack([planes[c].astype(np.float32) for c in names], axis=-1)
