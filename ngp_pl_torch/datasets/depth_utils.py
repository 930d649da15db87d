"""PFM depth-map IO (a copy of ngp_pl_tpu/datasets/depth_utils.py; reference
datasets/depth_utils.py:5-50).

Not used by the main training path in the reference either; provided for
dataset-tooling parity (some NSVF-family scenes ship PFM depth)."""
from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """Read a PFM file -> (data (H, W) or (H, W, 3) float32, scale).

    PFM stores rows bottom-to-top; the returned array is top-to-bottom like
    every other image here."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path!r}")

        dims = f.readline()
        while dims.startswith(b"#"):            # comment lines
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM header in {path!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"      # negative scale = little endian
        scale = abs(scale)

        data = np.frombuffer(f.read(), endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        return np.ascontiguousarray(data[::-1]), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    """Write a float32 (H, W) or (H, W, 3) array as PFM (little endian)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2:
        color = False
    else:
        raise ValueError("image must be (H, W) or (H, W, 3)")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())         # negative = little endian
        f.write(image[::-1].astype("<f4").tobytes())
