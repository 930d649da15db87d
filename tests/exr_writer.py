"""A writer of OpenEXR files, from the OpenEXR specification ("OpenEXR
File Layout", "Technical Introduction"): the magic number and version
field, the header's attributes, the offset tables, and blocks of
scanlines or tiles stored uncompressed or with RLE, ZIPS, ZIP, PIZ,
PXR24, B44, B44A, DWAA or DWAB; scanline or tiled parts (ONE_LEVEL,
MIPMAP or RIPMAP levels, either rounding), single-part or multi-part.
RLE and the zlib methods split each block into its even and odd bytes,
replace each byte by its difference from the one before plus 128, and
then run-length or zlib code the result.  The other methods are written
from OpenEXR's ImfPizCompressor.cpp, ImfHuf.cpp, ImfWav.cpp,
ImfPxr24Compressor.cpp, ImfB44Compressor.cpp and ImfDwaCompressor.cpp
(`piz_block`, `pxr24_block`, `b44_block`, `dwa_block`).  A block that
does not shrink is stored as it is.  `encode_exr` and `encode_multipart`
return, beside the file's bytes, what it holds: the values written, or
for a lossy method what its blocks decode to, which the writer works out
by its own means (B44's from the encoder's differences; DWA's through a
float64 inverse DCT and colour transform rounded once to half, then its
own table to linear).  It imports no JAX and nothing of the port, so the
chip's smoke script can use it and the port's reader is held against
code of its own."""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

COMPRESSION = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1), "ZIP": (3, 16),
               "PIZ": (4, 32), "PXR24": (5, 16), "B44": (6, 32),
               "B44A": (7, 32), "DWAA": (8, 32), "DWAB": (9, 256),
               "HTJ2K": (10, 16)}
PIXEL_TYPE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
              np.dtype(np.float32): 2}
MAGIC = b"\x76\x2f\x31\x01"
LINE_ORDER = {"INCREASING_Y": 0, "DECREASING_Y": 1, "RANDOM_Y": 2}
LEVEL_MODE = {"ONE_LEVEL": 0, "MIPMAP": 1, "RIPMAP": 2}
ROUNDING = {"DOWN": 0, "UP": 1}


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


# --- PIZ (ImfPizCompressor.cpp, ImfWav.cpp, ImfHuf.cpp) --------------------

HUF_ENCSIZE = (1 << 16) + 1
SHORT_ZEROCODE_RUN, LONG_ZEROCODE_RUN = 59, 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN


def _wenc14(a, b):
    """wenc14 on int arrays of u16 values: (l, h) as u16 values."""
    a16, b16 = a.astype(np.int16).astype(np.int32), b.astype(
        np.int16).astype(np.int32)
    return ((a16 + b16) >> 1) & 0xFFFF, (a16 - b16) & 0xFFFF


def _wenc16(a, b):
    """wenc16, the modular transform of full 16-bit values."""
    ao = (a + (1 << 15)) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    m = np.where(d < 0, (m + (1 << 15)) & 0xFFFF, m)
    return m, d & 0xFFFF


def wav2_encode(plane: np.ndarray, max_value: int) -> None:
    """wav2Encode in place on an (ny, nx) int32 plane of u16 values; each
    level's pairs are disjoint, so a level is one array step."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = plane.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        r0 = slice(0, ny - p2 + 1, p2)
        r1 = slice(p, ny - p2 + 1 + p, p2)
        c0 = slice(0, nx - p2 + 1, p2)
        c1 = slice(p, nx - p2 + 1 + p, p2)
        i00, i01 = enc(plane[r0, c0], plane[r0, c1])
        i10, i11 = enc(plane[r1, c0], plane[r1, c1])
        plane[r0, c0], plane[r1, c0] = enc(i00, i10)
        plane[r0, c1], plane[r1, c1] = enc(i01, i11)
        if nx & p:                      # the odd column, in the rows' loop
            ce = (nx // p2) * p2
            plane[r0, ce], plane[r1, ce] = enc(plane[r0, ce], plane[r1, ce])
        if ny & p:                      # the odd line, in the columns' loop
            re = (ny // p2) * p2
            plane[re, c0], plane[re, c1] = enc(plane[re, c0], plane[re, c1])
        p, p2 = p2, p2 << 1


def _code_lengths(freq: np.ndarray) -> np.ndarray:
    """hufBuildEncTable's code lengths: Huffman's merge of the two least
    frequent subtrees until one is left (two queues: the symbols by
    frequency, the merged subtrees in the order made), each symbol's
    length its depth.  Ties may merge in another order than the OpenEXR
    library's heap; any canonical decoder reads either."""
    syms = np.flatnonzero(freq)
    leaves = syms[np.argsort(freq[syms], kind="stable")]
    wts = freq[leaves].tolist()
    k = len(leaves)
    parent, merged = [0] * (2 * k - 1), []
    i = j = 0
    for t in range(k - 1):
        pair = []
        for _ in range(2):
            if i < k and (j >= len(merged) or wts[i] <= merged[j]):
                pair.append((i, wts[i]))
                i += 1
            else:
                pair.append((k + j, merged[j]))
                j += 1
        for node, _ in pair:
            parent[node] = k + t
        merged.append(pair[0][1] + pair[1][1])
    depth = [0] * (2 * k - 1)
    for node in range(2 * k - 3, -1, -1):
        depth[node] = depth[parent[node]] + 1
    length = np.zeros(HUF_ENCSIZE, np.int64)
    length[leaves] = depth[:k]
    assert length.max() <= 58
    return length


def canonical_codes(length: np.ndarray) -> np.ndarray:
    """hufCanonicalCodeTable: lengths 58 down to 1 take consecutive codes,
    each length's after the next length's, in symbol order within one."""
    n = np.bincount(length, minlength=59).astype(np.int64)
    first, c = np.zeros(59, np.int64), 0
    for l in range(58, 0, -1):
        first[l], c = c, (c + n[l]) >> 1
    code = np.zeros(length.size, np.uint64)
    for l in range(1, 59):
        s = np.flatnonzero(length == l)
        code[s] = first[l] + np.arange(s.size)
    return code


def _pack_bits(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Each value's low `width` bits, most significant first, one after
    the other; the last byte padded with zeros."""
    values = values.astype(np.uint64)
    widths = widths.astype(np.int64)
    bits = np.zeros(int(widths.sum()), np.uint8)
    start = np.cumsum(widths) - widths
    for j in range(int(widths.max(initial=0))):
        sel = np.flatnonzero(widths > j)
        shift = (widths[sel] - 1 - j).astype(np.uint64)
        bits[start[sel] + j] = (values[sel] >> shift) & np.uint64(1)
    return np.packbits(bits).tobytes()


def huf_compress(raw: np.ndarray) -> bytes:
    """hufCompress of u16 values: the five-field header, the packed table
    of code lengths im..iM (iM the run symbol, one past the largest value),
    then hufEncode's data: each run of up to 256 equal values as its
    codes, or, where sendCode finds it shorter, as the value's code, the
    run symbol's code and the repeat count in 8 bits."""
    if raw.size == 0:
        return b""
    freq = np.bincount(raw, minlength=HUF_ENCSIZE).astype(np.int64)
    im = int(np.flatnonzero(freq)[0])
    rlc = int(np.flatnonzero(freq)[-1]) + 1
    freq[rlc] = 1
    length = _code_lengths(freq)
    code = canonical_codes(length)
    # the packed table (hufPackEncTable)
    vals, wds, i = [], [], im
    while i <= rlc:
        l = int(length[i])
        if l == 0:
            zerun = 1
            while i < rlc and zerun < LONGEST_LONG_RUN and length[i + 1] == 0:
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    vals += [LONG_ZEROCODE_RUN, zerun - SHORTEST_LONG_RUN]
                    wds += [6, 8]
                else:
                    vals.append(SHORT_ZEROCODE_RUN + zerun - 2)
                    wds.append(6)
                i += 1
                continue
        vals.append(l)
        wds.append(6)
        i += 1
    table = _pack_bits(np.array(vals), np.array(wds))
    # the runs (hufEncode): pieces of at most 256 equal values
    starts = np.flatnonzero(np.r_[True, raw[1:] != raw[:-1]])
    lens = np.diff(np.r_[starts, raw.size])
    n_pieces = -(-lens // 256)
    piece = np.full(int(n_pieces.sum()), 256, np.int64)
    piece[np.cumsum(n_pieces) - 1] = lens - 256 * (n_pieces - 1)
    first = np.repeat(raw[starts], n_pieces)
    ls, lr = length[first], int(length[rlc])
    use_run = ls + lr + 8 < ls * (piece - 1)
    counts = np.where(use_run, 3, piece)
    tok_v = np.repeat(code[first], counts)
    tok_w = np.repeat(ls, counts)
    at = np.r_[0, np.cumsum(counts)[:-1]]
    tok_v[at[use_run] + 1] = code[rlc]
    tok_w[at[use_run] + 1] = lr
    tok_v[at[use_run] + 2] = (piece[use_run] - 1).astype(np.uint64)
    tok_w[at[use_run] + 2] = 8
    data = _pack_bits(tok_v, tok_w)
    n_bits = int(tok_w.sum())
    return (struct.pack("<5I", im, rlc, len(table), n_bits, 0) + table
            + data)


def piz_block(raw: bytes, rows: int, w: int, dtypes) -> bytes:
    """A PIZ block (PizCompressor::compress) from its scanlines' bytes:
    each channel's rows as u16 planes, the bitmap of the values present
    (0 left out) and the forward table to their ranks, wav2Encode on every
    plane, then the Huffman code."""
    lines = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    planes, at = [], 0
    for dt in dtypes:
        k = w * dt.itemsize
        planes.append(np.ascontiguousarray(lines[:, at:at + k]).view("<u2")
                      .astype(np.int64).reshape(rows, -1))
        at += k
    data = np.concatenate([p.reshape(-1) for p in planes])
    present = np.zeros(1 << 16, bool)
    present[data] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.flatnonzero(bitmap)
    lo, hi = (int(nz[0]), int(nz[-1])) if nz.size else (len(bitmap) - 1, 0)
    present[0] = True
    lut = np.cumsum(present) - 1
    max_value = int(lut[-1])
    out = []
    for dt, plane in zip(dtypes, planes):
        plane = lut[plane]
        size = dt.itemsize // 2
        for j in range(size):
            sub = plane[:, j::size]
            wav2_encode(sub, max_value)
            plane[:, j::size] = sub
        out.append(plane.reshape(-1))
    huf = huf_compress(np.concatenate(out).astype(np.int64))
    head = struct.pack("<HH", lo, hi)
    if lo <= hi:
        head += bitmap[lo:hi + 1].tobytes()
    return head + struct.pack("<i", len(huf)) + huf


# --- PXR24 (ImfPxr24Compressor.cpp) ----------------------------------------


def float24(a: np.ndarray) -> np.ndarray:
    """floatToFloat24 and back: float32 values as PXR24 stores them (the
    significand rounded to 15 bits, or cut where rounding would overflow;
    a NaN keeps a bit set)."""
    i = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    s, e, m = i & 0x80000000, i & 0x7F800000, i & 0x007FFFFF
    rounded = ((e | m) + (m & 0x80)) >> 8
    rounded = np.where(rounded >= 0x7F8000, (e | m) >> 8, rounded)
    special = np.where(m != 0, (e >> 8) | (m >> 8) | ((m >> 8) == 0),
                       e >> 8)
    i24 = (s >> 8) | np.where(e == 0x7F800000, special, rounded)
    return (i24 << 8).astype(np.uint32).view(np.float32)


def pxr24_block(raw: bytes, rows: int, w: int, dtypes) -> bytes:
    """A PXR24 block: per line and channel the differences of each value
    from the one before (HALF bits, UINT, FLOAT's 24 bits) as byte planes,
    most significant first; then zlib."""
    lines = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    out, at = [], 0
    for dt in dtypes:
        k = w * dt.itemsize
        cell = np.ascontiguousarray(lines[:, at:at + k])
        at += k
        if dt == np.float16:
            v, nb = cell.view("<u2").astype(np.uint32), 2
        elif dt == np.uint32:
            v, nb = cell.view("<u4").astype(np.uint64), 4
        else:
            v = float24(cell.view("<f4")).view(np.uint32).astype(np.uint64)
            v, nb = v >> 8, 3
        prev = np.concatenate([np.zeros((rows, 1), v.dtype), v[:, :-1]], 1)
        diff = (v - prev) & ((1 << (8 * nb)) - 1)
        out += [((diff >> (8 * (nb - 1 - b))) & 0xFF).astype(np.uint8)
                for b in range(nb)]
    return zlib.compress(np.concatenate(out, axis=1).tobytes())


# --- B44 and B44A (ImfB44Compressor.cpp, b44ExpLogTable.cpp) --------------


def _half_table(fn) -> np.ndarray:
    """fn on the float64 value of every half (finite ones; 0 elsewhere),
    rounded to float32 and then to half: a table of half bits."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16).astype(
        np.float64)
    finite = np.isfinite(h)
    with np.errstate(all="ignore"):
        out = fn(np.where(finite, h, 0.0)).astype(np.float32).astype(
            np.float16).view(np.uint16)
    out[~finite] = 0
    return out


def b44_exp_table() -> np.ndarray:
    """expTable: half(exp(h / 8)), HALF_MAX from 8 ln(HALF_MAX) up."""
    lim = np.float64(np.float32(8) * np.log(np.float32(65504)))
    return _half_table(lambda h: np.where(h >= lim, 65504.0, np.exp(h / 8)))


def b44_log_table() -> np.ndarray:
    """logTable: half(8 ln h) for h >= 0 (so -inf for 0), 0 below."""
    with np.errstate(divide="ignore"):
        return _half_table(lambda h: np.where(h < 0, 0.0, 8 * np.log(h)))


def _b44_pack(s: np.ndarray, flat_ok: bool, exact_max: bool):
    """pack() on (n, 16) u16 values of 4x4 blocks, rows in turn: the
    bytes of each block (14, or 3 for a flat one where `flat_ok`) and the
    (n, 16) values the block decodes to.  The values in ordered form t
    (sign bit set for positive values, all bits flipped for negative,
    0x8000 for infinities and NaNs) are stored as tMax minus differences
    d, shifted right by the least shift whose 15 running differences
    (first column down, then each row across) fit in 6 bits with a bias
    of 32; with `exact_max` t[0] is moved so that tMax decodes exactly."""
    s = s.astype(np.int64)
    t = np.where((s & 0x7C00) == 0x7C00, 0x8000,
                 np.where(s & 0x8000, ~s & 0xFFFF, s | 0x8000))
    t_max = t.max(1, keepdims=True)
    pairs = [(4 * k, 4 * k + 4) for k in range(3)] + [
        (4 * row + j, 4 * row + j + 1) for j in range(3) for row in range(4)]
    first, second = np.array(pairs).T
    shifts = np.arange(16)[:, None, None]
    x = (t_max - t)[None] << 1
    d_all = (x + (1 << shifts) - 1 + ((x >> (shifts + 1)) & 1)) >> (
        shifts + 1)
    r_all = d_all[:, :, first] - d_all[:, :, second] + 0x20
    fits = (r_all.min(2) >= 0) & (r_all.max(2) <= 0x3F)
    shift = fits.argmax(0)
    rows = np.arange(len(s))
    d, r = d_all[shift, rows], r_all[shift, rows]
    flat = flat_ok & (r == 0x20).all(1)
    t0 = np.where(exact_max, t_max[:, 0] - (d[:, 0] << shift), t[:, 0])
    t0 = np.where(flat, t[:, 0], t0)
    held = (t0[:, None] + ((d[:, :1] - d) << shift[:, None])) & 0xFFFF
    held = np.where(flat[:, None], t0[:, None], held)
    held = np.where(held & 0x8000, held & 0x7FFF, ~held & 0xFFFF)
    fields = np.concatenate([shift[:, None], r], 1)
    bits = (fields[:, :, None] >> np.arange(5, -1, -1)) & 1
    body = np.packbits(bits.reshape(len(s), 96).astype(np.uint8), axis=1)
    head = np.stack([t0 >> 8, t0 & 0xFF], 1).astype(np.uint8)
    out = [bytes([h0, h1, 0xFC]) if f else bytes([h0, h1]) + b.tobytes()
           for (h0, h1), b, f in zip(head.tolist(), body, flat)]
    return out, held.astype(np.uint16)


def b44_block(planes, linear, flat_ok: bool):
    """A B44 (or, with `flat_ok`, B44A) block of (rows, cols) channel
    planes in file order: FLOAT and UINT channels as they are, HALF ones
    as 4x4 blocks row by row (the edges padded by repeating the last
    column and row; pLinear ones through logTable first, and then exact
    only to the nearest step of tMax).  Returns the bytes and each
    channel's values as the block holds them."""
    out, held = [], []
    for plane, lin in zip(planes, linear):
        if plane.dtype != np.float16:
            out.append(plane.astype(plane.dtype.newbyteorder("<")).tobytes())
            held.append(plane)
            continue
        rows, cols = plane.shape
        s = plane.view(np.uint16)
        if lin:
            s = b44_log_table()[s]
        by, bx = -(-rows // 4), -(-cols // 4)
        s = np.pad(s, ((0, 4 * by - rows), (0, 4 * bx - cols)), mode="edge")
        blocks = s.reshape(by, 4, bx, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
        packed, got = _b44_pack(blocks, flat_ok, not lin)
        if lin:
            got = b44_exp_table()[got]
        out += packed
        held.append(got.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(
            4 * by, 4 * bx)[:rows, :cols].view(np.float16))
    return b"".join(out), held


# --- DWAA and DWAB (ImfDwaCompressor.cpp, dwaLookups.cpp) ------------------

DWA_UNKNOWN, DWA_LOSSY_DCT, DWA_RLE = 0, 1, 2
# (suffix, scheme, pixel type, index in an R, G, B set, case-insensitive):
# the encoder's default rules, which a version-2 block carries, and the
# rules a version-1 block means
DWA_DEFAULT_RULES = tuple(
    (suffix, DWA_LOSSY_DCT, ptype, csc, False)
    for suffix, csc in (("R", 0), ("G", 1), ("B", 2), ("Y", -1), ("BY", -1),
                        ("RY", -1)) for ptype in (1, 2)) + tuple(
    ("A", DWA_RLE, ptype, -1, False) for ptype in (0, 1, 2))
DWA_LEGACY_RULES = tuple(
    (suffix, DWA_LOSSY_DCT, ptype, csc, True)
    for names, csc in ((("r", "red"), 0), (("g", "grn", "green"), 1),
                       (("b", "blu", "blue"), 2), (("y", "by", "ry"), -1))
    for suffix in names for ptype in (1, 2)) + tuple(
    ("a", DWA_RLE, ptype, -1, True) for ptype in (0, 1, 2))
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                   28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                   37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                   54, 47, 55, 62, 63])      # zigzag position -> raster
JPEG_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58,
                      60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
                      51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24,
                      35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121,
                      120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def dwa_to_linear() -> np.ndarray:
    """dwaCompressorToLinear as dwaLookups.cpp makes it: nonlinear half
    bits -> linear half bits, |h|^2.2f up to 1 and float(e^2.2)^(|h| - 1)
    above, the sign kept, infinities and NaNs to 0."""
    base = np.float64(np.float32(np.power(2.7182818, 2.2)))
    exp = np.float64(np.float32(2.2))
    return _half_table(lambda h: np.sign(h) * np.where(
        np.abs(h) <= 1, np.abs(h) ** exp, base ** (np.abs(h) - 1)))


def dwa_to_nonlinear() -> np.ndarray:
    """The encoder's way in: |h|^(1/2.2) up to 1, ln|h| / 2.2 + 1 above."""
    with np.errstate(divide="ignore"):
        return _half_table(lambda h: np.sign(h) * np.where(
            np.abs(h) <= 1, np.abs(h) ** (1 / 2.2),
            np.log(np.abs(h)) / 2.2 + 1))


def _dct_matrices():
    """(C, M): the orthonormal 8-point DCT-II the encoder uses, and the
    inverse the decoder computes, from its float constants (ImfDwa-
    CompressorSimd.h's: 0.5 cos of multiples of pi / 16 to seven digits),
    in float64: x = M X M^T."""
    a, b, cc, d, e, f, g = (np.float64(np.float32(v)) for v in (
        3.535536e-01, 4.903927e-01, 4.619398e-01, 4.157349e-01, 2.777855e-01,
        1.913422e-01, 9.754573e-02))
    half = np.array([[a, b, cc, d, a, e, f, g],
                     [a, d, f, -g, -a, -b, -cc, -e],
                     [a, e, -f, -b, -a, g, cc, d],
                     [a, g, -cc, -e, a, d, -f, -b]])
    sign = np.array([1, -1, 1, -1, 1, -1, 1, -1])
    m = np.concatenate([half, (half * sign)[::-1]])
    k, n = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    cmat = np.sqrt(np.where(k == 0, 1, 2) / 8) * np.cos(
        (2 * n + 1) * k * np.pi / 16)
    return cmat, m


def _dwa_classify(names, dtypes, rules):
    """Each channel's scheme and the R, G, B sets by prefix order, as
    classifyChannels: the last rule matching a name's suffix and type."""
    schemes, sets = [], {}
    for i, (name, dt) in enumerate(zip(names, dtypes)):
        prefix, _, suffix = name.rpartition(".")
        idx = sets.setdefault(prefix, [-1, -1, -1])
        scheme = DWA_UNKNOWN
        for rule, sch, ptype, csc, fold in rules:
            if ptype == PIXEL_TYPE[dt] and rule == (
                    suffix.lower() if fold else suffix):
                scheme = sch
                if csc >= 0:
                    idx[csc] = i
        schemes.append(scheme)
    return schemes, [idx for _, idx in sorted(sets.items()) if min(idx) >= 0]


def _mirror(n: int, size: int) -> np.ndarray:
    """The encoder's edge rule: past the last value, back the other way."""
    i = np.arange(size)
    i = np.where(i >= n, n - (i - (n - 1)), i)
    return np.where(i < 0, n - 1, i)


def _dwa_ac_tokens(zig: np.ndarray) -> np.ndarray:
    """rleAc on (n, 63) AC half bits in zigzag order: a nonzero value as
    it is, a lone zero as 0, a longer run of zeros as 0xff00 | its length,
    or 0xff00 alone where it runs to the end of the block."""
    z = zig == 0
    run = np.zeros((zig.shape[0], 64), np.int64)
    for j in range(62, -1, -1):
        run[:, j] = np.where(z[:, j], run[:, j + 1] + 1, 0)
    run = run[:, :63]
    start = z & ~np.concatenate([np.zeros((len(z), 1), bool), z[:, :-1]], 1)
    to_end = run + np.arange(63) == 63
    tok = np.where(~z, zig, np.where(run == 1, 0, np.where(
        to_end, 0xFF00, 0xFF00 | run)))
    return tok[~z | start].astype(np.uint16)


def _dwa_dct(planes, csc: bool, nonlinear: bool, level: float):
    """One LOSSY_DCT group (a channel, or an R, G, B set): its DC values
    (each component's plane of blocks), its AC tokens (blocks in turn,
    components in turn within one), and what the decoder makes of them:
    each component's nonlinear values rounded once to half, from a
    float64 inverse DCT (a block with no AC token but ends and runs is
    its DC value times 3.535536e-01f twice) and colour transform."""
    cmat, m = _dct_matrices()
    rows, cols = planes[0].shape
    by, bx = -(-rows // 8), -(-cols // 8)
    ry, rx = _mirror(rows, 8 * by), _mirror(cols, 8 * bx)
    to_nl = dwa_to_nonlinear()
    x = []
    for p in planes:
        h = np.clip(p.astype(np.float32), -65504, 65504).astype(np.float16)
        bits = h.view(np.uint16)
        if nonlinear:
            bits = to_nl[bits]
        x.append(bits.view(np.float16)[ry][:, rx].astype(np.float64))
    x = np.stack(x)                                 # (comp, 8 by, 8 bx)
    if csc:
        r, g, b = x
        x = np.stack([0.2126 * r + 0.7152 * g + 0.0722 * b,
                      -0.1146 * r - 0.3854 * g + 0.5000 * b,
                      0.5000 * r - 0.4542 * g - 0.0458 * b])
    blocks = x.reshape(len(planes), by, 8, bx, 8).transpose(1, 3, 0, 2, 4)
    coef = cmat @ blocks @ cmat.T                   # (by, bx, comp, 8, 8)
    step = level / 1e5 * JPEG_LUMA.reshape(8, 8)
    q = np.where(np.arange(64).reshape(8, 8) == 0, coef,
                 np.round(coef / step) * step) + 0.0
    qh = q.astype(np.float16)
    zig = qh.reshape(by, bx, len(planes), 64)[..., ZIGZAG].view(np.uint16)
    dc = zig[..., 0].transpose(2, 0, 1).reshape(-1)
    ac = zig[..., 1:].reshape(-1, 63)
    tokens = _dwa_ac_tokens(ac)
    dc_only = (ac == 0).all(1).reshape(by, bx, len(planes))
    s = np.float64(np.float32(3.535536e-01))
    full = m @ qh.astype(np.float64) @ m.T
    flat = qh[..., :1, :1].astype(np.float64) * s * s
    y = np.where(dc_only[..., None, None], flat, full)
    if csc:
        yy, cb, cr = np.moveaxis(y, 2, 0)
        k = [np.float64(np.float32(v)) for v in (1.5747, 0.1873, 0.4682,
                                                 1.8556)]
        y = np.stack([yy + k[0] * cr, yy - k[1] * cb - k[2] * cr,
                      yy + k[3] * cb], 2)
    y = y.transpose(2, 0, 3, 1, 4).reshape(len(planes), 8 * by, 8 * bx)
    return dc, tokens, y[:, :rows, :cols].astype(np.float16)


def dwa_block(names, planes, linear, version: int = 2,
              ac_method: str = "HUFFMAN", rules=None, level: float = 45.0):
    """A DWAA or DWAB block of (rows, cols) channel planes in file order:
    its bytes, each channel's values as the block holds them, and for the
    LOSSY_DCT channels their nonlinear values (rounded once) before the
    decoder's table to linear.  Version 2 carries the rules that match a
    channel (`rules`, by default the encoder's); version 1 carries none
    and means the legacy ones.  AC as OpenEXR's Huffman code or zlib."""
    rows, cols = planes[0].shape
    dtypes = [p.dtype for p in planes]
    if rules is None:
        rules = DWA_DEFAULT_RULES if version == 2 else DWA_LEGACY_RULES
    schemes, sets = _dwa_classify(names, dtypes, rules)
    lone = [[i] for i, s in enumerate(schemes) if s == DWA_LOSSY_DCT
            and not any(i in st for st in sets)]
    to_lin = dwa_to_linear()
    held, nonlinear = list(planes), {}
    dcs, acs = [], []
    for group in sets + lone:
        nl = len(group) == 3 or not linear[group[0]]
        dc, tokens, y = _dwa_dct([planes[i] for i in group], len(group) == 3,
                                 nl, level)
        dcs.append(dc)
        acs.append(tokens)
        for i, yi in zip(group, y):
            nonlinear[names[i]] = yi
            lin = to_lin[yi.view(np.uint16)] if nl else yi.view(np.uint16)
            held[i] = lin.view(np.float16).astype(dtypes[i])
    raw = {s: [] for s in (DWA_UNKNOWN, DWA_RLE)}
    for p, s in zip(planes, schemes):
        le = np.ascontiguousarray(p, p.dtype.newbyteorder("<"))
        if s == DWA_RLE:
            raw[s].append(le.view(np.uint8).reshape(rows, cols, -1)
                          .transpose(2, 0, 1).tobytes())
        elif s == DWA_UNKNOWN:
            raw[s].append(le.tobytes())
    unk, rle = b"".join(raw[DWA_UNKNOWN]), b"".join(raw[DWA_RLE])
    unk_z = zlib.compress(unk) if unk else b""
    rle_coded = _rle(rle) if rle else b""
    rle_z = zlib.compress(rle_coded) if rle else b""
    ac = np.concatenate(acs) if acs else np.zeros(0, np.uint16)
    dc = np.concatenate(dcs) if dcs else np.zeros(0, np.uint16)
    if not ac.size:
        ac_z = b""
    elif ac_method == "HUFFMAN":
        ac_z = huf_compress(ac.astype(np.int64))
    else:
        ac_z = zlib.compress(ac.astype("<u2").tobytes())
    dc_z = zlib.compress(_predict(dc.astype("<u2").tobytes())) if dc.size \
        else b""
    table = b""
    if version == 2:
        used = [r for r in rules if any(
            PIXEL_TYPE[dt] == r[2] and r[0] == (
                n.rpartition(".")[2].lower() if r[4]
                else n.rpartition(".")[2]) for n, dt in zip(names, dtypes))]
        body = b"".join(
            r[0].encode() + b"\0" + bytes([((r[3] + 1) & 15) << 4
                                           | (r[1] & 3) << 2 | r[4], r[2]])
            for r in used)
        table = struct.pack("<H", 2 + len(body)) + body
    counters = struct.pack(
        "<11Q", version, len(unk), len(unk_z), len(ac_z), len(dc_z),
        len(rle_z), len(rle_coded), len(rle), ac.size, dc.size,
        0 if ac_method == "HUFFMAN" else 1)
    return (counters + table + unk_z + ac_z + dc_z + rle_z, held, nonlinear)


# --- the container --------------------------------------------------------


class Encoded(NamedTuple):
    """A file's bytes; for part 0's level 0, whether each block was
    stored compressed (in offset-table order), each channel's (H, W)
    values as the file holds them, and the nonlinear values of DWA's
    LOSSY_DCT channels (rounded once) before the table to linear."""
    data: bytes
    packed: list
    held: dict
    nonlinear: dict


def _levels(w, h, mode: str, rounding: str):
    """(lx, ly, width, height) of every level, in offset-table order."""
    up = ROUNDING[rounding]

    def count(n):
        y, r = 0, 0
        while n > 1:
            r |= n & 1
            y, n = y + 1, n >> 1
        return y + (r if up else 0) + 1

    def size(n, l):
        s = n // (1 << l)
        if up and s * (1 << l) < n:
            s += 1
        return max(s, 1)

    if mode == "ONE_LEVEL":
        return [(0, 0, w, h)]
    if mode == "MIPMAP":
        return [(l, l, size(w, l), size(h, l))
                for l in range(count(max(w, h)))]
    return [(lx, ly, size(w, lx), size(h, ly)) for ly in range(count(h))
            for lx in range(count(w))]


def _encode_block(names, planes, linear, compression, dwa):
    """(the block's stored bytes, whether compressed, each channel's
    values as stored, DWA's nonlinear values)."""
    rows, cols = planes[0].shape
    dtypes = [p.dtype for p in planes]
    raw = b"".join(np.ascontiguousarray(
        p[r], p.dtype.newbyteorder("<")).tobytes()
        for r in range(rows) for p in planes)
    packed, held, nonlinear = raw, list(planes), {}
    if compression == "RLE":
        packed = _rle(_predict(raw))
    elif compression in ("ZIPS", "ZIP"):
        packed = zlib.compress(_predict(raw))
    elif compression == "PIZ":
        packed = piz_block(raw, rows, cols, dtypes)
    elif compression == "PXR24":
        packed = pxr24_block(raw, rows, cols, dtypes)
        held = [float24(p) if p.dtype == np.float32 else p for p in planes]
    elif compression in ("B44", "B44A"):
        packed, held = b44_block(planes, linear, compression == "B44A")
    elif compression in ("DWAA", "DWAB"):
        packed, held, nonlinear = dwa_block(names, planes, linear, **dwa)
    if len(packed) >= len(raw):
        return raw, False, list(planes), {}
    return packed, True, held, nonlinear


def _part_attrs(names, dtypes, linear, compression, origin, hw,
                line_order):
    """The attributes every part's header needs, in name order."""
    chlist = b"".join(
        n.encode() + b"\0" + struct.pack(
            "<iB3xii", PIXEL_TYPE[np.dtype(dt)], int(l), 1, 1)
        for n, dt, l in zip(names, dtypes, linear)) + b"\0"
    (x0, y0), (h, w) = origin, hw
    box = struct.pack("<4i", x0, y0, x0 + w - 1, y0 + h - 1)
    return [_attr("channels", "chlist", chlist),
            _attr("compression", "compression",
                  bytes([COMPRESSION[compression][0]])),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", bytes([LINE_ORDER[line_order]])),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))]


def _single_part(attrs, chunks, line_order: str, flags: int) -> bytes:
    """A single-part file of a header's attributes and its chunks
    ((coordinates, stored bytes) in offset-table order)."""
    header = MAGIC + struct.pack("<I", 2 | flags) + b"".join(attrs) + b"\0"
    blocks = [struct.pack(f"<{len(c)}i", *c) + struct.pack("<i", len(d)) + d
              for c, d in chunks]
    offsets, pos = [0] * len(blocks), len(header) + 8 * len(blocks)
    order = _order(len(blocks), line_order)
    for b in order:
        offsets[b] = pos
        pos += len(blocks[b])
    return (header + struct.pack(f"<{len(blocks)}Q", *offsets)
            + b"".join(blocks[b] for b in order))


def _encode_part(channels, compression, origin, line_order, tiles, linear,
                 dwa):
    """A part's header attributes, its chunks (each as (coordinates, stored
    bytes)) in offset-table order, and its level 0's Encoded fields."""
    names = sorted(channels)
    arrays = [np.asarray(channels[n]) for n in names]
    lin = [n in linear for n in names]
    h, w = arrays[0].shape
    lines = COMPRESSION[compression][1]
    x0, y0 = origin
    attrs = _part_attrs(names, [a.dtype for a in arrays], lin, compression,
                        origin, (h, w), line_order)
    if tiles is None:
        rects = [((y0 + r,), None, r, 0, w, min(lines, h - r))
                 for r in range(0, h, lines)]
    else:
        tw, th, mode, rounding = tiles
        attrs.append(_attr("tiles", "tiledesc", struct.pack(
            "<IIB", tw, th, LEVEL_MODE[mode] | ROUNDING[rounding] << 4)))
        rects = [((tx, ty, lx, ly), (lx, ly) if lx or ly else None,
                  ty * th, tx * tw, min(tw, lw - tx * tw),
                  min(th, lh - ty * th))
                 for lx, ly, lw, lh in _levels(w, h, mode, rounding)
                 for ty in range(-(-lh // th)) for tx in range(-(-lw // tw))]
    chunks, packed = [], []
    held = {n: np.empty_like(a) for n, a in zip(names, arrays)}
    nonlinear = {}
    for coords, level, r0, c0, cols, rows in rects:
        if level:       # another level: every value of this one, subsampled
            lx, ly = level
            src = [a[np.minimum(np.arange(r0, r0 + rows) << ly, h - 1)][
                :, np.minimum(np.arange(c0, c0 + cols) << lx, w - 1)]
                for a in arrays]
        else:
            src = [a[r0:r0 + rows, c0:c0 + cols] for a in arrays]
        data, was_packed, got, nl = _encode_block(names, src, lin,
                                                  compression, dwa or {})
        chunks.append((coords, data))
        if level:
            continue
        packed.append(was_packed)
        for n, g in zip(names, got):
            held[n][r0:r0 + rows, c0:c0 + cols] = g
        for n, g in nl.items():
            nonlinear.setdefault(n, np.zeros((h, w), np.float16))[
                r0:r0 + rows, c0:c0 + cols] = g
    return attrs, chunks, Encoded(b"", packed, held, nonlinear)


def _order(n: int, line_order: str) -> list:
    """The order chunks are written in (their offsets keep table order)."""
    if line_order == "DECREASING_Y":
        return list(range(n))[::-1]
    if line_order == "RANDOM_Y":
        return np.random.default_rng(n).permutation(n).tolist()
    return list(range(n))


def encode_exr(channels: dict, compression: str = "ZIP", origin=(0, 0),
               line_order: str = "INCREASING_Y", version_flags: int = 0,
               tiles=None, linear=(), dwa=None) -> Encoded:
    """A single-part file.  `channels`: name -> (H, W) array of float16,
    float32 or uint32, all one size.  `origin` is the data window's (xmin,
    ymin); `tiles` (tile width, height, "ONE_LEVEL" | "MIPMAP" | "RIPMAP",
    "DOWN" | "UP") makes it tiled; `linear` names the channels with
    pLinear set; `dwa` holds dwa_block's options (version, ac_method,
    rules, level); `version_flags` adds bits to the version field (0x200
    tiled, 0x800 deep, 0x1000 multi-part) for files a reader must
    refuse."""
    attrs, chunks, enc = _encode_part(channels, compression, origin,
                                      line_order, tiles, linear, dwa)
    flags = version_flags | (0x200 if tiles else 0)
    return enc._replace(data=_single_part(attrs, chunks, line_order, flags))


def encode_multipart(parts) -> Encoded:
    """A multi-part file of `parts`, each a dict of encode_exr's arguments
    (channels, compression, origin, line_order, tiles, linear, dwa) and
    its name; its headers with name, type and chunkCount, then the empty
    header, one offset table per part, and the chunks, each led by its
    part number.  The Encoded fields but `data` are part 0's."""
    heads, tables, first = [], [], None
    for i, part in enumerate(parts):
        kw = dict(part)
        name = kw.pop("name", f"part{i}")
        kw.setdefault("compression", "ZIP")
        kw.setdefault("origin", (0, 0))
        kw.setdefault("line_order", "INCREASING_Y")
        attrs, chunks, enc = _encode_part(kw.pop("channels"), **{
            k: kw.get(k) for k in ("compression", "origin", "line_order")},
            tiles=kw.get("tiles"), linear=kw.get("linear", ()),
            dwa=kw.get("dwa"))
        first = enc if first is None else first
        kind = b"tiledimage" if kw.get("tiles") else b"scanlineimage"
        heads.append(b"".join(attrs) + _attr("name", "string", name.encode())
                     + _attr("type", "string", kind)
                     + _attr("chunkCount", "int",
                             struct.pack("<i", len(chunks))) + b"\0")
        tables.append([struct.pack("<i", i) + struct.pack(
            f"<{len(c)}i", *c) + struct.pack("<i", len(d)) + d
            for c, d in chunks])
    header = MAGIC + struct.pack("<I", 2 | 0x1000) + b"".join(heads) + b"\0"
    pos = len(header) + 8 * sum(len(t) for t in tables)
    offsets, body = [], []
    for table, part in zip(tables, parts):
        offs = [0] * len(table)
        for b in _order(len(table), part.get("line_order", "INCREASING_Y")):
            offs[b] = pos
            body.append(table[b])
            pos += len(table[b])
        offsets += offs
    data = header + struct.pack(f"<{len(offsets)}Q", *offsets) + b"".join(
        body)
    return first._replace(data=data)


def write_exr(path, channels: dict, compression: str = "ZIP",
              origin=(0, 0), line_order: str = "INCREASING_Y",
              version_flags: int = 0, **kw) -> list:
    """encode_exr's file written to `path`; returns, block by block from
    the top (tile by tile of level 0 in a tiled file), whether the block
    was stored compressed (else as it is)."""
    enc = encode_exr(channels, compression, origin, line_order,
                     version_flags, **kw)
    with open(path, "wb") as f:
        f.write(enc.data)
    return enc.packed


def dwa_table_probe(nonlinear_bits: np.ndarray, cols: int = 192):
    """A single-part DWAB file whose R, G and B are LOSSY_DCT channels
    each alone (a version-2 rule table without colour sets) and whose 8x8
    blocks hold a DC value only: one block for each of `nonlinear_bits`
    (half bits of nonlinear values; blocks of channel B, then G, then R,
    rows of `cols` blocks), its DC value eight times the value where that
    is a finite normal half, else the value itself.  A decoder makes each
    block DC times 3.535536e-01f twice, rounded to half, then looks it up
    in its table to linear, so the file reads OpenEXR's table where the
    values are the table's inputs.  Returns the file's bytes and the
    (H, W, 3) nonlinear half bits each pixel of R, G, B holds."""
    n = -(-len(nonlinear_bits) // (3 * cols)) * 3 * cols
    t = np.resize(nonlinear_bits.astype(np.uint16), n)
    v = t.view(np.float16).astype(np.float32)
    with np.errstate(all="ignore"):
        d8 = (v * 8).astype(np.float16)
        usable = np.isfinite(d8) & (np.abs(v) >= 2.0 ** -14)
    dc = np.where(usable, d8.view(np.uint16), t)
    s = np.float32(3.535536e-01)
    with np.errstate(all="ignore"):
        held = ((dc.view(np.float16).astype(np.float32) * s) * s).astype(
            np.float16).view(np.uint16)
    nby = n // (3 * cols)
    planes = dc.reshape(3, nby, cols)
    rows, width = 8 * nby, 8 * cols
    rules = b"".join(c.encode() + b"\0" + bytes([DWA_LOSSY_DCT << 2, 1])
                     for c in "RGB")
    table = struct.pack("<H", 2 + len(rules)) + rules
    chunks = []
    for r0 in range(0, rows, 256):
        dcs = planes[:, r0 // 8:(r0 + 256) // 8].reshape(-1)
        ac = np.full(dcs.size, 0xFF00, np.uint16)
        ac_z = zlib.compress(ac.astype("<u2").tobytes())
        dc_z = zlib.compress(_predict(dcs.astype("<u2").tobytes()))
        chunks.append(((r0,), struct.pack(
            "<11Q", 2, 0, 0, len(ac_z), len(dc_z), 0, 0, 0, ac.size, dcs.size,
            1) + table + ac_z + dc_z))
    attrs = _part_attrs("BGR", [np.float16] * 3, [False] * 3, "DWAB", (0, 0),
                        (rows, width), "INCREASING_Y")
    data = _single_part(attrs, chunks, "INCREASING_Y", 0)
    per_block = held.reshape(3, nby, cols)[::-1]            # R, G, B
    pixels = np.repeat(np.repeat(per_block, 8, 1), 8, 2)
    return data, pixels.transpose(1, 2, 0)
