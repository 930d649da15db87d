"""Build and load the port's CUDA kernels (no JAX counterpart).

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by nvcc for
Hopper (`sm_90a`) into its own shared library and loaded with ctypes.  All
missing libraries are built at once, with one nvcc process per source.  A
library is built at first use into `build/kernels/` (listed in .gitignore)
and reused while its source, the headers that source includes from
`csrc/`, and the flags are unchanged: the file name carries a hash of them.
A failed build raises; there is no fallback.

Every C entry returns `cudaGetLastError()` after its launch; `check` turns a
nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
KERNELS = ("hash_encode_fwd", "field_tail_fwd", "hash_encode_bwd",
           "field_tail_bwd", "scatter_rows", "encode_ablations")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str) -> list:
    """`csrc/<name>.cu` and the headers it includes from `csrc/` with
    `#include "..."`, transitively, in the order first met."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for m in _INCLUDE.finditer(path.read_text()):
            todo.append(CSRC / m.group(1))
    return out


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every listed kernel whose library is missing, all nvcc
    processes started together.  Returns the seconds from the start until
    each one's nvcc finished, by kernel.  The compiler's output (registers,
    spills, shared memory) goes to `<name>.log`."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(BUILD_DIR / f"{name}.log", "w") as log:
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed, pending, seconds = [], list(jobs), {}
    while pending:
        for job in list(pending):
            name, out, tmp, proc = job
            if proc.poll() is None:
                continue
            pending.remove(job)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                text = (BUILD_DIR / f"{name}.log").read_text()
                failed.append(f"--- {name} ---\n{text}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if missing."""
    path = lib_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
