"""Writes tests/fixtures/openexr/: small OpenEXR files beside the values
OpenEXR's own decoder reads from them, so that the CPU tests
(tests/test_torch_exr_openexr.py) hold `read_exr` against OpenEXR on a
machine that has no OpenEXR.  It needs a cv2 built with OpenEXR (the
H100 machine's cv2 4.13.0 has OpenEXR 2.3.0):

    python -m tests.make_openexr_fixtures OUT_DIR

then copy OUT_DIR's files into tests/fixtures/openexr/.  For each case
<name>.exr and <name>.npy, the (H, W, C) float16 R, G, B(, A) values that
cv2.imread (OpenEXR's InputFile) returns.  B44 and B44A files are written
by OpenEXR's encoder (cv2.imwrite); the DWAA and DWAB files by the test
writer (tests/exr_writer.py), since cv2 4.13.0's OpenEXR writes DWA files
whose offset table is all zeros; the tiled ones by the test writer, since
cv2 writes no tiles.  MANIFEST.json names each file's writer, OpenEXR's
version and the cv2 that read it.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from tests.exr_writer import encode_exr

SIDE = (37, 45)         # every edge case of B44's 4x4 and DWA's 8x8 blocks


def frame(seed: int, names: str = "RGBA", side=SIDE) -> dict:
    """Half radiance in [0, 2) with noise, a bright patch, a negative
    patch and a flat one; alpha in [0, 1]."""
    rng = np.random.default_rng(seed)
    h, w = side
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ch = {}
    for k, n in enumerate(names):
        a = (np.sin(7 * x * (k + 1) + seed) * np.cos(5 * y) + 1.0
             + 0.05 * rng.standard_normal((h, w)))
        if n == "A":
            a = np.clip(a / 2, 0, 1)
            a[:, :6] = 1.0
        else:
            a[:5, :7] = 3.5 - k
            a[10:14, 3:9] = -0.25
            a[20:28, 30:38] = 0.75
        ch[n] = a.astype(np.float16)
    return ch


# name -> (method, writer, encode_exr's options for the test writer, side)
CASES = {
    "b44_rgba": ("B44", "cv2", {}, SIDE),
    "b44a_rgba": ("B44A", "cv2", {}, SIDE),
    "b44a_rgb": ("B44A", "cv2", {}, SIDE),
    "dwaa_rgba": ("DWAA", "writer", {}, SIDE),
    "dwaa_rgba_96": ("DWAA", "writer", {}, (96, 96)),
    "dwab_rgb": ("DWAB", "writer", {"dwa": {"ac_method": "DEFLATE"}}, SIDE),
    "dwaa_v1_rgba": ("DWAA", "writer", {"dwa": {"version": 1}}, SIDE),
    "dwaa_tiled_rgba": ("DWAA", "writer",
                        {"tiles": (16, 16, "MIPMAP", "DOWN")}, SIDE),
    "zip_tiled_rgba": ("ZIP", "writer",
                       {"tiles": (10, 7, "RIPMAP", "UP")}, SIDE),
}


def main(out_dir: str) -> None:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    version = [ln.split("ver")[-1].strip(" )") for ln in
               cv2.getBuildInformation().splitlines() if "OpenEXR:" in ln]
    manifest = {"reader": f"cv2 {cv2.__version__}",
                "openexr": version[0] if version else None, "files": {}}
    for i, (name, (method, writer, kw, side)) in enumerate(CASES.items()):
        names = "RGB" if name.endswith("_rgb") else "RGBA"
        ch = frame(i, names, side)
        path = os.path.join(out_dir, name + ".exr")
        if writer == "cv2":
            bgr = np.stack([ch[n] for n in "BGRA"[:len(names)]],
                           -1).astype(np.float32)
            ok = cv2.imwrite(path, bgr, [
                cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF,
                cv2.IMWRITE_EXR_COMPRESSION,
                getattr(cv2, "IMWRITE_EXR_COMPRESSION_" + method)])
            if not ok:
                raise RuntimeError(f"cv2 could not write {path}")
            who = f"cv2 {cv2.__version__}"
        else:
            with open(path, "wb") as f:
                f.write(encode_exr(ch, method, **kw).data)
            who = "tests/exr_writer.py"
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError(f"cv2 could not read {path}")
        rgb = img[..., [2, 1, 0, 3][:img.shape[-1]]].astype(np.float16)
        np.save(os.path.join(out_dir, name + ".npy"), rgb)
        manifest["files"][name] = {"method": method, "writer": who,
                                   "options": {k: str(v)
                                               for k, v in kw.items()}}
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
