"""RTMV's HDR .exr frames to the sRGB PNGs the `rtmv` loader reads, the
counterpart of misc/prepare_rtmv.py (reference misc/prepare_rtmv.py).

    python -m ngp_pl_torch.misc.prepare_rtmv ROOT

For every scene directory ROOT/<scene>/, each <name>.exr becomes
<scene>/images/<name>.png: the first three channels (R, G, B), clipped to
[0, 1], through `linear_to_srgb`, times 255 and truncated to uint8, as the
JAX script does; read by the port's own OpenEXR reader
(`datasets/exr.py`) and written by its own PNG writer, since the card's
machine has no imageio.
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ngp_pl_torch.datasets.color_utils import linear_to_srgb
from ngp_pl_torch.datasets.exr import read_exr
from ngp_pl_torch.utils.images import write_png


def main(root_dir) -> None:
    for scene in sorted(glob.glob(os.path.join(root_dir, "*/"))):
        out_dir = os.path.join(scene, "images")
        os.makedirs(out_dir, exist_ok=True)
        for exr in sorted(glob.glob(os.path.join(scene, "*.exr"))):
            img = read_exr(exr)[..., :3]
            img = linear_to_srgb(np.clip(img, 0, 1))
            name = os.path.splitext(os.path.basename(exr))[0] + ".png"
            write_png(os.path.join(out_dir, name),
                      (img * 255).astype(np.uint8))
        print(f"done {scene}")


if __name__ == "__main__":
    main(sys.argv[1])
