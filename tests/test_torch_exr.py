"""The port's OpenEXR reader (`ngp_pl_torch/datasets/exr.py`) against files
the test writes from the OpenEXR specification (`tests/exr_writer.py`),
and its RTMV preparation script against the JAX repository's
(misc/prepare_rtmv.py), whose imageio read is replaced by the arrays the
test wrote."""
import importlib.util
import os
import shutil
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from ngp_pl_torch.datasets.color_utils import read_png
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.misc import prepare_rtmv
from tests.exr_writer import write_exr

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"


def _frame(seed, h, w, names="RGBA", dtype=np.float16):
    """An HDR frame: values in [-0.1, 2), a few exact 0s and 1s, A in
    [0, 1]; half floats by default."""
    rng = np.random.default_rng(seed)
    ch = {}
    for n in names:
        a = rng.random((h, w)) * (1.0 if n == "A" else 2.1) - (
            0.0 if n == "A" else 0.1)
        a.flat[0] = 0.0
        a.flat[-1] = 1.0
        if n != "A":
            a[1:3, 1:4] = 0.5              # a run for RLE
        ch[n] = a.astype(dtype)
    return ch


CASES = [("NONE", np.float16, "RGBA", (0, 0), "INCREASING_Y"),
         ("RLE", np.float16, "RGBA", (0, 0), "INCREASING_Y"),
         ("ZIPS", np.float32, "RGB", (3, -2), "INCREASING_Y"),
         ("ZIP", np.float16, "RGBA", (-5, 7), "DECREASING_Y"),
         ("ZIP", np.float32, "RGBA", (0, 0), "INCREASING_Y"),
         ("RLE", np.float32, "RGB", (2, 2), "DECREASING_Y"),
         ("ZIP", np.uint32, "RGB", (0, 0), "INCREASING_Y")]


@pytest.mark.parametrize("comp,dtype,names,origin,order", CASES)
@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (37, 21)])
def test_round_trip(tmp_path, comp, dtype, names, origin, order, hw):
    """The reader returns exactly the values written, as float32 in R, G,
    B(, A) order, over the data window."""
    ch = _frame(sum(hw), *hw, names=names, dtype=dtype)
    if dtype == np.uint32:
        ch = {n: (a.astype(np.float64) * 1000).astype(np.uint32)
              for n, a in ch.items()}
    path = tmp_path / "f.exr"
    write_exr(path, ch, comp, origin=origin, line_order=order)
    got = read_exr(path)
    want = np.stack([ch[n].astype(np.float32) for n in names], -1)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_compressed_blocks_are_smaller(tmp_path):
    """The ZIP and RLE fixtures really hold compressed blocks (a smooth
    frame compresses), so the round trip covers the decompressors."""
    y, x = np.mgrid[0:32, 0:40]
    ch = {n: ((x + y * k) / 80).astype(np.float16)
          for k, n in enumerate("RGB", 1)}
    sizes = {}
    for comp in ("NONE", "RLE", "ZIPS", "ZIP"):
        path = tmp_path / f"{comp}.exr"
        write_exr(path, ch, comp)
        sizes[comp] = os.path.getsize(path)
        np.testing.assert_array_equal(
            read_exr(path), np.stack([ch[n] for n in "RGB"], -1))
    assert sizes["ZIP"] < sizes["ZIPS"] < sizes["NONE"]
    assert sizes["RLE"] < sizes["NONE"]


@pytest.mark.parametrize("kind,match", [
    (dict(compression="B44"), "B44 compression"),
    (dict(version_flags=0x200), "tiled"),
    (dict(version_flags=0x1000), "multi-part"),
    (dict(version_flags=0x800), "deep")])
def test_refusals_name_what_they_refuse(tmp_path, kind, match):
    path = tmp_path / "f.exr"
    write_exr(path, _frame(0, 4, 4), **kind)
    with pytest.raises(ValueError, match=match) as e:
        read_exr(path)
    assert str(path) in str(e.value)


def test_not_exr_and_truncated(tmp_path):
    bad = tmp_path / "bad.exr"
    bad.write_bytes(b"not an exr file")
    with pytest.raises(ValueError, match="not an OpenEXR"):
        read_exr(bad)
    good = tmp_path / "f.exr"
    write_exr(good, _frame(1, 20, 20), "ZIP")
    data = good.read_bytes()
    cut = tmp_path / "cut.exr"
    cut.write_bytes(data[:len(data) - 40])
    with pytest.raises(Exception):
        read_exr(cut)


def _jax_prepare_rtmv():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rtmv_tree(root, frames):
    """Two scenes of three frames each: ZIP half RGBA (the OpenEXR
    library's default compression), and one scene written with other
    compressions and windows."""
    kinds = [("ZIP", (0, 0), "INCREASING_Y"), ("RLE", (4, 1), "DECREASING_Y"),
             ("ZIPS", (0, 0), "INCREASING_Y")]
    for s, scene in enumerate(("scene_a", "scene_b")):
        os.makedirs(root / scene)
        for i in range(3):
            ch = _frame(10 * s + i, 23, 31)
            comp, origin, order = kinds[i] if s else kinds[0]
            path = root / scene / f"{i:05d}.exr"
            write_exr(path, ch, comp, origin=origin, line_order=order)
            frames[str(path)] = np.stack([ch[n].astype(np.float32)
                                          for n in "RGBA"], -1)


def test_prepare_rtmv_matches_jax_script(tmp_path, monkeypatch):
    """Two copies of an RTMV-like tree: the JAX script (imageio's read
    replaced by the float32 arrays written) and the port's write PNGs that
    are pixel-equal."""
    frames = {}
    _rtmv_tree(tmp_path / "jax", frames)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.setattr(imageio, "imread", lambda p: frames[str(p)].copy())
    _jax_prepare_rtmv().main(str(tmp_path / "jax"))
    monkeypatch.undo()
    prepare_rtmv.main(str(tmp_path / "port"))
    pngs = sorted((tmp_path / "jax").glob("*/images/*.png"))
    assert len(pngs) == 6
    for p in pngs:
        q = tmp_path / "port" / p.relative_to(tmp_path / "jax")
        want = np.asarray(imageio.imread(p))   # a PNG: Pillow's read
        got = read_png(q)
        assert got.shape == (23, 31, 3)
        np.testing.assert_array_equal(got, want)


def test_committed_fixture_tree(tmp_path):
    """The committed EXR tree (read by chip_smoke.py's `exr` phase): the
    port's script, run on a copy, writes PNGs equal to the committed ones
    that the JAX script wrote for the same frames."""
    root = tmp_path / "rtmv"
    shutil.copytree(FIXTURES / "rtmv_exr", root)
    prepare_rtmv.main(str(root))
    pngs = sorted(root.glob("*/images/*.png"))
    assert len(pngs) == len(list(root.glob("*/*.exr"))) == 5
    for got in pngs:
        want = got.parent.parent / "expected" / got.name
        np.testing.assert_array_equal(read_png(got), read_png(want))
