"""A writer of single-part scanline OpenEXR files, from the OpenEXR
specification ("OpenEXR File Layout", "Technical Introduction"): the magic
number and version field, the header's attributes, the line offset table,
and blocks of scanlines stored uncompressed or with RLE, ZIPS, ZIP, PIZ or
PXR24.  RLE and the zlib methods split each block into its even and odd
bytes, replace each byte by its difference from the one before plus 128,
and then run-length or zlib code the result.  PIZ and PXR24 are written
from OpenEXR's ImfPizCompressor.cpp, ImfHuf.cpp, ImfWav.cpp and
ImfPxr24Compressor.cpp (`piz_block`, `pxr24_block`); `float24` gives the
FLOAT values a PXR24 file holds.  A block that does not shrink is stored
as it is.  It imports no JAX and nothing of the port, so the chip's smoke
script can use it and the port's reader is held against code of its
own."""
from __future__ import annotations

import struct
import zlib

import numpy as np

COMPRESSION = {"NONE": (0, 1), "RLE": (1, 1), "ZIPS": (2, 1), "ZIP": (3, 16),
               "PIZ": (4, 32), "PXR24": (5, 16), "B44": (6, 32)}
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


def write_exr(path, channels: dict, compression: str = "ZIP",
              origin=(0, 0), line_order: str = "INCREASING_Y",
              version_flags: int = 0) -> list:
    """`channels`: name -> (H, W) array of float16, float32 or uint32, all
    one size.  `origin` is the data window's (xmin, ymin); `version_flags`
    adds bits to the version field (0x200 tiled, 0x1000 multi-part) for
    files a reader must refuse.  Returns, block by block from the top,
    whether the block was stored compressed (else as it is)."""
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
    blocks, packed_flags = [], []
    for b, r0 in enumerate(range(0, h, lines)):
        rows = range(r0, min(r0 + lines, h))
        raw = b"".join(np.ascontiguousarray(
            channels[n][r], channels[n].dtype.newbyteorder("<")).tobytes()
            for r in rows for n in names)
        packed = raw
        dtypes = [np.asarray(channels[n]).dtype for n in names]
        if compression == "RLE":
            packed = _rle(_predict(raw))
        elif compression in ("ZIPS", "ZIP"):
            packed = zlib.compress(_predict(raw))
        elif compression == "PIZ":
            packed = piz_block(raw, len(rows), w, dtypes)
        elif compression == "PXR24":
            packed = pxr24_block(raw, len(rows), w, dtypes)
        if len(packed) >= len(raw):
            packed = raw
        packed_flags.append(packed is not raw)
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
    return packed_flags
