"""Test-trajectory video export (counterpart of ngp_pl_tpu/utils/video.py;
reference train.py:284-293 writes rgb and depth mp4s through imageio).

The JAX package writes an mp4 where imageio has an ffmpeg backend and a GIF
otherwise.  The port needs neither imageio nor ffmpeg: it always writes
the GIF, with its own encoder, beside the requested path:
GIF89a, a looping application block, one image per frame with its own
256-entry colour table, the delay round(100 / fps) hundredths of a second,
and LZW codes of up to 12 bits.

Colours: a frame with at most 256 colours (a depth frame, drawn from the
turbo table's 256 entries) keeps them exactly.  Any other frame is mapped
to the 6 x 6 x 6 cube of levels 0, 51, ..., 255 (the web-safe palette),
each channel to its nearest level: at most 25 of 255 off per channel.
"""
from __future__ import annotations

import os
import struct
from typing import List

import numpy as np
import torch

from ngp_pl_torch.utils.images import depth2img

CUBE_STEP = 51                 # the 6 levels 0, 51, ..., 255 of each channel
QUANT_MAX_ERR = CUBE_STEP // 2     # 25: the most a channel moves


def _quantise(frame: np.ndarray):
    """(H, W, 3) uint8 -> (palette (256, 3) uint8, indices (H, W) uint8)."""
    flat = frame.reshape(-1, 3)
    colours, idx = np.unique(flat, axis=0, return_inverse=True)
    if len(colours) <= 256:
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(colours)] = colours
        return palette, idx.reshape(frame.shape[:2]).astype(np.uint8)
    q = (flat.astype(np.int32) + CUBE_STEP // 2) // CUBE_STEP     # 0..5
    levels = np.arange(6) * CUBE_STEP
    cube = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                    -1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[:216] = cube
    idx = q[:, 0] * 36 + q[:, 1] * 6 + q[:, 2]
    return palette, idx.reshape(frame.shape[:2]).astype(np.uint8)


def _lzw(indices: bytes) -> bytes:
    """GIF LZW of 8-bit indices (minimum code size 8), in sub-blocks."""
    clear, eoi = 256, 257
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table, nxt, size = {}, 258, 9
    emit(clear, size)
    code = indices[0]
    for c in indices[1:]:
        key = (code << 8) | c
        hit = table.get(key)
        if hit is not None:
            code = hit
            continue
        emit(code, size)
        if nxt < 4096:
            table[key] = nxt
            # the decoder widens its codes once it has made code 2^size
            if nxt == 1 << size:
                size += 1
            nxt += 1
        else:
            emit(clear, size)
            table, nxt, size = {}, 258, 9
        code = c
    emit(code, size)
    # the decoder makes an entry on reading that last code and may widen
    # before it reads the end code
    if nxt == 1 << size and size < 12:
        size += 1
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    blocks = bytearray()
    for i in range(0, len(out), 255):
        part = out[i:i + 255]
        blocks += bytes([len(part)]) + part
    return bytes(blocks) + b"\x00"


def write_gif(path: str, frames: List[np.ndarray], fps: int = 30) -> None:
    """Write (H, W, 3) uint8 frames as a looping GIF89a."""
    h, w = frames[0].shape[:2]
    delay = int(round(100.0 / fps))
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for frame in frames:
            frame = np.asarray(frame, np.uint8)
            if frame.shape != (h, w, 3):
                raise ValueError(f"frame {frame.shape}, want {(h, w, 3)}")
            palette, idx = _quantise(frame)
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                    + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87))
            f.write(palette.tobytes())
            f.write(b"\x08" + _lzw(idx.tobytes()))
        f.write(b"\x3b")


def write_video(path: str, frames: List[np.ndarray], fps: int = 30) -> str:
    """frames: list of (H, W, 3) uint8.  Writes the GIF beside the
    requested path (its extension replaced by .gif) and returns its path,
    as the JAX package's fallback does."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alt = os.path.splitext(path)[0] + ".gif"
    write_gif(alt, frames, fps)
    return alt


def render_trajectory_video(renderer, occ_grid, poses, directions, img_wh,
                            out_dir: str, name: str, fps: int = 30):
    """Render every (3, 4) pose through the round renderer and write the
    rgb and turbo-depth videos (reference train.py:284-293).  `directions`
    (H*W, 3) on the renderer's device.  Returns the two paths."""
    w, h = img_wh
    rgb_frames, depth_frames = [], []
    for pose in poses:
        out = renderer.render_pose(
            occ_grid, directions,
            torch.as_tensor(pose, dtype=torch.float32,
                            device=directions.device))
        rgb = out["rgb"].reshape(h, w, 3).cpu().numpy()
        rgb_frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        depth_frames.append(depth2img(out["depth"].reshape(h, w).cpu()
                                      .numpy()))
    return (write_video(os.path.join(out_dir, f"{name}_rgb.mp4"),
                        rgb_frames, fps),
            write_video(os.path.join(out_dir, f"{name}_depth.mp4"),
                        depth_frames, fps))
