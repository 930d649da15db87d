"""`read_exr` against OpenEXR's own decoder, on a machine without OpenEXR:
tests/fixtures/openexr/ holds small files and the values that OpenEXR
2.3.0 (through cv2 4.13.0's imread, on the H100 machine) read from them,
written by tests/make_openexr_fixtures.py.  B44 and B44A files come from
OpenEXR's encoder; DWAA, DWAB and the tiled files from the test writer
(OpenEXR 2.3.0 writes DWA files without blocks there, and cv2 writes no
tiles).  Each must read bit for bit as OpenEXR read it: DWA's DCT
channels too, since the port's inverse DCT follows OpenEXR's SSE2 order;
OpenEXR's scalar order, emulated, reads some values otherwise.  The test
writer's B44 and B44A blocks are OpenEXR's own, byte for byte."""
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from ngp_pl_torch import native
from ngp_pl_torch.datasets import exr
from ngp_pl_torch.datasets.exr import read_exr
from tests.exr_writer import ZIGZAG, encode_exr
from tests.make_openexr_fixtures import CASES, frame

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "openexr"


def test_manifest_names_every_case():
    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    assert manifest["openexr"] and manifest["reader"].startswith("cv2")
    assert sorted(manifest["files"]) == sorted(CASES)
    for name, (method, writer, _, _) in CASES.items():
        assert manifest["files"][name]["method"] == method
        assert manifest["files"][name]["writer"].startswith(
            "cv2" if writer == "cv2" else "tests/exr_writer.py")


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_exr_equals_openexr(name):
    got = read_exr(FIXTURES / f"{name}.exr")
    want = np.load(FIXTURES / f"{name}.npy").astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _scalar_order_decode(ac, dc, n_comp, width, height):
    """`native.dwa_dct_decode` with OpenEXR's scalar inverse DCT
    (dctInverse8x8_scalar: its constants 0.5 cosf of multiples of
    3.14159f / 16, its odd sums left to right) in numpy float32: the
    order the port does not take."""
    f32 = np.float32
    pi = f32(3.14159)
    k = {i: f32(0.5) * f32(np.cos(np.float64(f32(f32(i) * pi) / f32(16))))
         for i in range(1, 8)}
    a, b, c, d, e, f, g = k[4], k[1], k[2], k[3], k[5], k[6], k[7]

    def one_pass(x):                    # along the last axis
        r = [x[..., i] for i in range(8)]
        be = [b * r[1] + d * r[3] + e * r[5] + g * r[7],
              d * r[1] - g * r[3] - b * r[5] - e * r[7],
              e * r[1] - b * r[3] + g * r[5] + d * r[7],
              g * r[1] - e * r[3] + d * r[5] - b * r[7]]
        th0, th3 = a * (r[0] + r[4]), a * (r[0] - r[4])
        th1, th2 = c * r[2] + f * r[6], f * r[2] - c * r[6]
        ga = [th0 + th1, th3 + th2, th3 - th2, th0 - th1]
        return np.stack([ga[i] + be[i] for i in range(4)]
                        + [ga[3 - i] - be[3 - i] for i in range(4)], -1)

    nbx, nby = -(-width // 8), -(-height // 8)
    zig = np.zeros((nby * nbx, n_comp, 64), np.uint16)
    zig[..., 0] = dc.reshape(n_comp, -1).T
    flat = np.zeros((nby * nbx, n_comp), bool)
    at = 0
    for blk in range(nby * nbx):
        for comp in range(n_comp):
            pos, last = 1, 0
            while pos < 64:
                v = int(ac[at])
                at += 1
                if v == 0xFF00:
                    pos = 64
                elif v >> 8 == 0xFF:
                    pos += v & 0xFF
                else:
                    zig[blk, comp, pos], last, pos = v, pos, pos + 1
            flat[blk, comp] = last == 0
    coef = np.zeros_like(zig)
    coef[..., ZIGZAG] = zig
    x = coef.view(np.float16).astype(f32).reshape(-1, n_comp, 8, 8)
    full = np.swapaxes(one_pass(np.swapaxes(one_pass(x), -1, -2)), -1, -2)
    s = f32(3.535536e-01)
    dc_only = (x[..., :1, :1] * s) * s
    y = np.where(flat[..., None, None], dc_only, full)
    if n_comp == 3:
        yy, cb, cr = y[:, 0], y[:, 1], y[:, 2]
        y = np.stack([yy + f32(1.5747) * cr,
                      yy - f32(0.1873) * cb - f32(0.4682) * cr,
                      yy + f32(1.8556) * cb], 1)
    y = y.reshape(nby, nbx, n_comp, 8, 8).transpose(2, 0, 3, 1, 4)
    out = y.reshape(n_comp, 8 * nby, 8 * nbx)[:, :height, :width]
    return out.astype(np.float16).view(np.uint16), at


def test_scalar_order_misses_openexr(monkeypatch):
    """The negative control of the inverse DCT's order: OpenEXR's scalar
    path, emulated, reads some values of the committed DWA files otherwise
    than OpenEXR did, where the port's SSE2 order reads none (above)."""
    monkeypatch.setattr(native, "dwa_dct_decode", _scalar_order_decode)
    missed = {}
    for name, (method, _, _, _) in CASES.items():
        if method.startswith("DWA"):
            got = read_exr(FIXTURES / f"{name}.exr")
            want = np.load(FIXTURES / f"{name}.npy").astype(np.float32)
            missed[name] = int((got != want).sum())
    assert sum(missed.values()) > 0, missed


def _chunks(data: bytes) -> list:
    """The stored bytes of each chunk of a single-part scanline file."""
    attrs, _, _, table, _ = exr._part0("f", data)
    y0, y1 = struct.unpack("<4i", attrs["dataWindow"][1])[1::2]
    lines = exr.COMPRESSION[attrs["compression"][1][0]][1]
    n = -(-(y1 - y0 + 1) // lines)
    out = []
    for off in struct.unpack_from(f"<{n}Q", data, table):
        (size,) = struct.unpack_from("<i", data, off + 4)
        out.append(data[off + 8:off + 8 + size])
    return out


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[1] == "cv2"])
def test_writer_b44_is_openexrs_encoder(name):
    """The test writer's B44 and B44A blocks are byte for byte those
    OpenEXR's encoder wrote for the same frame."""
    method, _, _, side = CASES[name]
    names = "RGB" if name.endswith("_rgb") else "RGBA"
    ch = frame(list(CASES).index(name), names, side)
    theirs = _chunks((FIXTURES / f"{name}.exr").read_bytes())
    assert _chunks(encode_exr(ch, method).data) == theirs
