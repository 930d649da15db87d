"""The port's host library (C++, loaded with ctypes): ray-batch sampling,
u8 image ingest, box downsampling, the PNG row unfilter and the OpenEXR
PIZ decoder's Huffman and wavelet stages.

Counterpart of ngp_pl_tpu/native/__init__.py, with its own copy of the
source (`ray_sampler.cpp`), since the port imports nothing of the JAX
package.  The library is compiled with g++ at first use into
`build/host/` at the root of the checkout (gitignored), under a file name
that carries a hash of the source and the flags.  Each process compiles
to a name of its own and moves the result into place with `os.replace`,
so processes that build at once (test workers) never load a half-written
library.  A failed build raises.

Setting `NGP_PL_TORCH_NO_NATIVE` asks for the numpy versions instead, as
`NGP_PL_TPU_NO_NATIVE` does in the JAX package: then `get_lib()` returns
None and the callers of sampling and u8 ingest (`datasets/base.py`,
`datasets/color_utils.py`) take their numpy branch.  Nothing else selects
that branch.  The PNG unfilter and the PIZ stages have no numpy branch
(each step depends on the one before) and build the library whatever the
variable says.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "ray_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
# the JAX package's flags: the same code built the same way gives the same
# floats (no -march, so no contracted multiply-adds on x86-64)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
NO_NATIVE_ENV = "NGP_PL_TORCH_NO_NATIVE"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"ray_sampler_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path."""
    so = lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the host library failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed "
                           f"({' '.join(cmd)}):\n{out.stderr}")
    os.replace(tmp, so)
    return so


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ngp_sample_batch_f32.argtypes = [
        pf, i64, i64, i64, i64, i32, u64, pi32, pi32, pf, ctypes.c_void_p]
    lib.ngp_sample_batch_u8.argtypes = [
        pu8, i64, i64, i64, i64, i32, u64, pi32, pi32, pf]
    lib.ngp_u8_to_rays.argtypes = [pu8, i64, i64, i32, pf]
    lib.ngp_downsample_box.argtypes = [pf, i64, i64, i64, i64, pf]
    lib.ngp_png_unfilter.argtypes = [pu8, i64, i64, i64, pu8]
    lib.ngp_png_unfilter.restype = i64
    lib.ngp_piz_huf_decode.argtypes = [ctypes.c_char_p, i64,
                                       ctypes.c_void_p, i64]
    lib.ngp_piz_huf_decode.restype = i64
    lib.ngp_piz_wav2_decode.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int32] * 4 + [ctypes.c_uint16])
    lib.ngp_native_version.restype = ctypes.c_int
    return lib


def native_disabled() -> bool:
    return bool(os.environ.get(NO_NATIVE_ENV))


def _built() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _load(build())
    return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None only when `NGP_PL_TORCH_NO_NATIVE`
    asks for the numpy versions.  A failed build raises."""
    return None if native_disabled() else _built()


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the host library is switched off by "
                           f"{NO_NATIVE_ENV}")
    return lib


_STRATEGIES = {"all_images": 0, "same_image": 1}


def sample_batch(rays: np.ndarray, batch_size: int, strategy: str,
                 seed: int) -> Dict[str, np.ndarray]:
    """One batch from a (n_img, n_pix, C) float32 or uint8 ray store: the
    (img, pix) draws of `seed` under `strategy` and their rows
    (ngp_pl_tpu/native/__init__.py:88-125): img_idxs, pix_idxs (int32),
    rgb (float32, a uint8 store scaled by 1/255) and, for a float32 store
    with 4 channels, exposure (batch, 1)."""
    lib = _require()
    if strategy not in _STRATEGIES:
        raise ValueError(f"ray_sampling_strategy={strategy!r}: one of "
                         f"{tuple(_STRATEGIES)}")
    if rays.ndim != 3 or min(rays.shape) == 0 or rays.shape[2] < 3:
        raise ValueError(f"want a (n_img, n_pix, C >= 3) ray store, got "
                         f"{rays.shape}")
    n_img, n_pix, ch = rays.shape
    img_idxs = np.empty(batch_size, np.int32)
    pix_idxs = np.empty(batch_size, np.int32)
    rgb = np.empty((batch_size, 3), np.float32)
    strat = _STRATEGIES[strategy]
    seed &= 0xFFFFFFFFFFFFFFFF
    if rays.dtype == np.uint8:
        lib.ngp_sample_batch_u8(np.ascontiguousarray(rays), n_img, n_pix, ch,
                                batch_size, strat, seed, img_idxs, pix_idxs,
                                rgb)
        return {"img_idxs": img_idxs, "pix_idxs": pix_idxs, "rgb": rgb}
    if rays.dtype != np.float32:
        raise ValueError(f"ray store dtype {rays.dtype}: float32 or uint8")
    exposure = np.empty((batch_size, 1), np.float32) if ch >= 4 else None
    lib.ngp_sample_batch_f32(
        np.ascontiguousarray(rays), n_img, n_pix, ch, batch_size, strat, seed,
        img_idxs, pix_idxs, rgb,
        exposure.ctypes.data if exposure is not None else None)
    out = {"img_idxs": img_idxs, "pix_idxs": pix_idxs, "rgb": rgb}
    if exposure is not None:
        out["exposure"] = exposure
    return out


def u8_to_rays(img: np.ndarray, blend_a: bool = True,
               premultiply: bool = False) -> np.ndarray:
    """uint8 (n_pix, C) -> float32 (n_pix, 3), each byte times 1.0f/255.0f,
    with 4 or more channels blended onto white (`blend_a`) or premultiplied
    (ngp_pl_tpu/native/__init__.py:128-139).  With fewer than 3 channels
    the library reads the missing ones from the next pixel, as the JAX
    package's does (ROADMAP, reference defects); the port pads the buffer
    with zero bytes so the last pixel reads zeros and not past the array."""
    lib = _require()
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"want an (n_pix, C) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    n_pix, ch = img.shape
    mode = 2
    if ch >= 4:
        mode = 1 if premultiply else (0 if blend_a else 2)
    buf = np.ascontiguousarray(img).reshape(-1)
    if ch < 3:
        buf = np.concatenate([buf, np.zeros(3 - ch, np.uint8)])
    out = np.empty((n_pix, 3), np.float32)
    lib.ngp_u8_to_rays(buf, n_pix, ch, mode, out)
    return out


def downsample_box(img: np.ndarray, factor: int) -> np.ndarray:
    """(H, W, C) float32 integer-factor box downsample
    (ngp_pl_tpu/native/__init__.py:142-148)."""
    lib = _require()
    if img.dtype != np.float32 or img.ndim != 3:
        raise ValueError(f"want an (H, W, C) float32 image, got {img.dtype} "
                         f"{img.shape}")
    h, w, c = img.shape
    out = np.empty((h // factor, w // factor, c), np.float32)
    lib.ngp_downsample_box(np.ascontiguousarray(img), h, w, c, factor, out)
    return out


def png_unfilter(raw: np.ndarray, h: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """Inflated PNG data (h rows of a filter byte + row_bytes) -> the
    (h, row_bytes) uint8 samples; ValueError on a filter byte past 4."""
    lib = _built()
    if raw.size != h * (row_bytes + 1):
        raise ValueError(f"inflated PNG data holds {raw.size} bytes, "
                         f"{h * (row_bytes + 1)} expected")
    out = np.empty((h, row_bytes), np.uint8)
    bad = lib.ngp_png_unfilter(np.ascontiguousarray(raw, np.uint8), h,
                               row_bytes, bpp, out)
    if bad >= 0:
        raise ValueError(f"PNG row {bad} has filter type "
                         f"{raw[bad * (row_bytes + 1)]}, not 0-4")
    return out


PIZ_ERRORS = {-1: "ends early", -2: "has a bad code table",
              -3: "holds a code of no symbol",
              -4: "decodes to more values than the block holds",
              -5: "decodes to fewer values than the block holds",
              -6: "starts with a run"}


def piz_huf_decode(data: bytes, n_out: int) -> np.ndarray:
    """The n_out u16 values of a PIZ block's Huffman-coded data (OpenEXR's
    hufUncompress); ValueError naming what is wrong with a corrupt one."""
    lib = _built()
    out = np.empty(n_out, np.uint16)
    err = lib.ngp_piz_huf_decode(data, len(data), out.ctypes.data, n_out)
    if err:
        raise ValueError(f"the Huffman data {PIZ_ERRORS[err]}")
    return out


def piz_wav2_decode(buf: np.ndarray, start: int, nx: int, ox: int, ny: int,
                    oy: int, mx: int) -> None:
    """OpenEXR's wav2Decode in place on the u16 values buf[start + x * ox +
    y * oy] for x < nx, y < ny (14-bit transform when mx < 2^14)."""
    lib = _built()
    if (buf.dtype != np.uint16 or not buf.flags.c_contiguous
            or start + (nx - 1) * ox + (ny - 1) * oy >= buf.size):
        raise ValueError("the wavelet's plane lies outside the buffer")
    lib.ngp_piz_wav2_decode(buf.ctypes.data + 2 * start, nx, ox, ny, oy, mx)
