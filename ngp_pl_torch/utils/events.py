"""TensorBoard event files without a package (the JAX package writes them
through tensorboardX, system.py:264-271; neither tensorboardX nor
tensorboard is a dependency of the port).

An event file is a TFRecord file of `Event` protocol buffers.  A record
is the data's length as a little-endian u64, the masked CRC32C of those
eight bytes, the data, and the masked CRC32C of the data.  CRC32C is the
Castagnoli polynomial (reflected 0x82F63B78), masked as
((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.  The protos are encoded by
hand: `Event` holds wall_time (field 1, double), step (2, varint),
file_version (3, string, "brain.Event:2" in the first record) and summary
(5), whose `value` (1) holds tag (1, string) and simple_value (2, float).
Files are named as tensorboardX names them:
events.out.tfevents.<first 10 characters of time.time()>.<hostname>.
"""
from __future__ import annotations

import os
import socket
import struct
import time


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def event(wall_time: float, step: int = 0, file_version: str = None,
          scalars=()) -> bytes:
    """An encoded `Event`: `scalars` is a sequence of (tag, value), each a
    `Summary.Value` with its simple_value in float32."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _varint(2 << 3 | 5) + struct.pack("<f", value))
            for tag, value in scalars)
        out += _bytes_field(5, summary)
    return out


class EventWriter:
    """Scalars into a new event file in `logdir` (made if missing); the
    first record carries the file version."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{str(time.time())[:10]}."
            f"{socket.gethostname()}")
        self._f = open(self.path, "wb")
        self._f.write(record(event(time.time(),
                                   file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(record(event(time.time(), int(step),
                                   scalars=[(tag, float(value))])))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
