"""Writes the committed OpenEXR fixtures under tests/fixtures/ (read by
tests/test_torch_exr.py and chip_smoke.py's `exr` phase):

    JAX_PLATFORMS=cpu python -m tests.make_fixtures

- rtmv_exr/<scene>/<frame>.exr (half RGBA, ZIP, the OpenEXR library's
  default compression; scene_b also RLE with a data window off the origin
  and DECREASING_Y, and ZIPS) and rtmv_exr/<scene>/expected/<frame>.png,
  what the JAX repository's misc/prepare_rtmv.py writes for those frames
  (its imageio read replaced by the arrays written).
- rtmv_exr_piz/<scene>/... the same for one scene of PIZ and PXR24 frames
  (`PIZ_KINDS`: PIZ half RGBA; PIZ float RGBA with a data window off the
  origin and DECREASING_Y; PXR24 float RGBA, whose arrays are the 24-bit
  values the file holds).
- rtmv_exr_more/<scene>/... the same for one scene of the other layouts
  and methods (`MORE_KINDS`: B44 and B44A half RGBA; DWAA half RGBA; DWAB
  float RGB off the origin and DECREASING_Y; a tiled ZIP frame with MIPMAP
  levels; a multi-part file whose part 0 is a PIZ frame), whose arrays are
  what the writer says the files hold.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

from tests.exr_writer import (encode_exr, encode_multipart, float24,
                              write_exr)

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "fixtures"
EXR_KINDS = {"scene_a": [("ZIP", (0, 0), "INCREASING_Y")] * 2,
             "scene_b": [("ZIP", (0, 0), "INCREASING_Y"),
                         ("RLE", (4, 1), "DECREASING_Y"),
                         ("ZIPS", (0, 0), "INCREASING_Y")]}
# name -> (compression, dtype, origin, line order, encode_exr's options);
# "multipart" puts the frame in part 0 beside a tiled part 1
MORE_KINDS = {"scene_m": [
    ("B44", np.float16, (0, 0), "INCREASING_Y", {}),
    ("B44A", np.float16, (0, 0), "INCREASING_Y", {}),
    ("DWAA", np.float16, (0, 0), "INCREASING_Y", {}),
    ("DWAB", np.float32, (2, -3), "DECREASING_Y", {}),
    ("ZIP", np.float16, (0, 0), "INCREASING_Y",
     {"tiles": (16, 16, "MIPMAP", "DOWN")}),
    ("PIZ", np.float16, (0, 0), "INCREASING_Y", {"multipart": True})]}
PIZ_KINDS = {"scene_p": [("PIZ", np.float16, (0, 0), "INCREASING_Y"),
                         ("PIZ", np.float32, (-3, 5), "DECREASING_Y"),
                         ("PXR24", np.float32, (0, 0), "INCREASING_Y")]}


def exr_frame(seed, h=24, w=32):
    """Half RGBA radiance: smooth in [0, 1.6) with some values past 1
    (clipped by the script) and below 0.0031308 (its linear segment)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ch = {"R": 1.6 * x * x, "G": 0.8 * y + 0.01 * rng.random((h, w)),
          "B": np.abs(np.sin(5 * x * y)) * 1.2, "A": np.ones((h, w))}
    ch["R"][:2, :3] = 0.002
    return {n: a.astype(np.float16) for n, a in ch.items()}


def piz_frame(seed, dtype, h=24, w=32):
    """exr_frame's radiance in `dtype`, float32 values cut to 10 bits of
    significand so that PIZ's wavelet finds smooth 16-bit halves."""
    ch = {n: a.astype(np.float32) for n, a in exr_frame(seed, h, w).items()}
    if dtype == np.float32:
        ch = {n: (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
              for n, a in ch.items()}
    return {n: a.astype(dtype) for n, a in ch.items()}


def write_exrs():
    root = OUT / "rtmv_exr"
    shutil.rmtree(root, ignore_errors=True)
    frames = {}
    for s, (scene, kinds) in enumerate(EXR_KINDS.items()):
        (root / scene).mkdir(parents=True)
        for i, (comp, origin, order) in enumerate(kinds):
            ch = exr_frame(10 * s + i)
            path = root / scene / f"{i:05d}.exr"
            write_exr(path, ch, comp, origin=origin, line_order=order)
            frames[path.name, scene] = np.stack(
                [ch[n].astype(np.float32) for n in "RGBA"], -1)
    jax_expected(root, frames)


def write_piz_exrs():
    """rtmv_exr_piz: PIZ_KINDS' frames, every block stored compressed."""
    root = OUT / "rtmv_exr_piz"
    shutil.rmtree(root, ignore_errors=True)
    frames = {}
    for scene, kinds in PIZ_KINDS.items():
        (root / scene).mkdir(parents=True)
        for i, (comp, dtype, origin, order) in enumerate(kinds):
            ch = piz_frame(20 + i, dtype)
            path = root / scene / f"{i:05d}.exr"
            packed = write_exr(path, ch, comp, origin=origin,
                               line_order=order)
            assert all(packed), (path, packed)
            img = np.stack([ch[n].astype(np.float32) for n in "RGBA"], -1)
            frames[path.name, scene] = (float24(img) if comp == "PXR24"
                                        else img)
    jax_expected(root, frames)


def write_more_exrs():
    """rtmv_exr_more: MORE_KINDS' frames, every block stored compressed;
    RGB for the RGB frame and RGBA for the others."""
    root = OUT / "rtmv_exr_more"
    shutil.rmtree(root, ignore_errors=True)
    frames = {}
    for scene, kinds in MORE_KINDS.items():
        (root / scene).mkdir(parents=True)
        for i, (comp, dtype, origin, order, kw) in enumerate(kinds):
            ch = piz_frame(40 + i, dtype)
            if dtype == np.float32:
                del ch["A"]
            kw = dict(kw)
            if kw.pop("multipart", False):
                enc = encode_multipart([
                    dict(channels=ch, compression=comp, origin=origin,
                         line_order=order, name="rgba"),
                    dict(channels=piz_frame(50, np.float16, 8, 12),
                         compression="ZIP", tiles=(4, 4, "RIPMAP", "UP"),
                         name="thumb")])
            else:
                enc = encode_exr(ch, comp, origin=origin, line_order=order,
                                 **kw)
            assert all(enc.packed), (comp, enc.packed)
            path = root / scene / f"{i:05d}.exr"
            path.write_bytes(enc.data)
            img = np.stack([enc.held[n].astype(np.float32) for n in "RGBA"
                            if n in ch], -1)
            frames[path.name, scene] = img
    jax_expected(root, frames)


def jax_expected(root, frames):
    """<scene>/expected/*.png under `root`: what the JAX script writes for
    the arrays `frames` ((file name, scene) -> (H, W, 4) float32)."""
    import imageio.v2 as imageio

    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    real = imageio.imread
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(root, tmp, dirs_exist_ok=True)
        imageio.imread = lambda p: frames[Path(p).name,
                                          Path(p).parent.name].copy()
        try:
            jax_script.main(tmp)
        finally:
            imageio.imread = real
        for scene in sorted({scene for _, scene in frames}):
            shutil.copytree(Path(tmp) / scene / "images",
                            root / scene / "expected")


if __name__ == "__main__":
    write_exrs()
    write_piz_exrs()
    write_more_exrs()
    for p in sorted(OUT.rglob("*")):
        if p.is_file():
            print(f"{os.path.getsize(p):8d} {p.relative_to(REPO)}")
