"""`read_exr` of two checkouts on the same OpenEXR frame, in turns (first,
second, second, first), each turn in a process of its own whose
`ngp_pl_torch` is that checkout's: one untimed read (it builds the
checkout's host library), then RUNS timed reads.

    python -m ngp_pl_torch.benchmarking.exr_read_ab FIRST SECOND \
        [--method PIZ] [--side 1600]

The frame (RGBA half, smooth radiance with noise, `--side` square) is
written by cv2's OpenEXR encoder, which the machine must have, into a
temporary directory under build/.  Prints one JSON line: the card line,
the frame, and each turn's tree and seconds; both trees' reads must be
equal.  Both checkouts must read `--method`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from ngp_pl_torch.device import card_line

RUNS = 3
CHILD = """
import hashlib, json, sys, time
from ngp_pl_torch.datasets.exr import read_exr
first = read_exr(sys.argv[1])
seconds = []
for _ in range(int(sys.argv[2])):
    t0 = time.perf_counter()
    read_exr(sys.argv[1])
    seconds.append(time.perf_counter() - t0)
print(json.dumps({"seconds": seconds,
                  "sha256": hashlib.sha256(first.tobytes()).hexdigest()}))
"""


def write_frame(path: str, side: int, method: str) -> None:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:side, 0:side] / side
    bgra = np.stack([np.sin(7 * x * (k + 1)) * np.cos(5 * y) + 1.0
                     + 0.02 * rng.random(x.shape) for k in (2, 1, 0)]
                    + [np.ones(x.shape)], -1).astype(np.float16)
    ok = cv2.imwrite(path, bgra.astype(np.float32), [
        cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF,
        cv2.IMWRITE_EXR_COMPRESSION,
        getattr(cv2, "IMWRITE_EXR_COMPRESSION_" + method)])
    if not ok:
        raise RuntimeError(f"cv2 {cv2.__version__} wrote no {method} file")


def turn(tree: str, path: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", CHILD, path, str(RUNS)],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=os.path.abspath(tree))
    if out.returncode:
        raise RuntimeError(f"{tree}: {out.stderr}")
    return dict(tree=tree, **json.loads(out.stdout.strip().splitlines()[-1]))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("first")
    parser.add_argument("second")
    parser.add_argument("--method", default="PIZ")
    parser.add_argument("--side", type=int, default=1600)
    args = parser.parse_args(argv)
    build = os.path.join(os.path.dirname(__file__), "..", "..", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.abspath(os.path.join(tmp, f"ab_{args.method}.exr"))
        write_frame(path, args.side, args.method)
        turns = [turn(t, path) for t in (args.first, args.second,
                                         args.second, args.first)]
    if len({t["sha256"] for t in turns}) != 1:
        raise AssertionError(f"the trees read different frames: {turns}")
    print(json.dumps(dict(card=card_line("cuda"), method=args.method,
                          side=args.side, runs=RUNS, turns=turns)))


if __name__ == "__main__":
    main()
