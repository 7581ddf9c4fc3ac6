"""Byte-stream framing (host side, numpy only): the port's copy of
gauspcc_tpu/core/bitstream.py:14-34.

u16 stream count, then per stream a u32 length and its bytes.
"""

from __future__ import annotations

import os

import numpy as np


def pack_byte_streams(streams: list[bytes]) -> bytes:
    out = [np.uint16(len(streams)).tobytes()]
    for s in streams:
        out.append(np.uint32(len(s)).tobytes())
        out.append(s)
    return b"".join(out)


def unpack_byte_streams(stream: bytes) -> list[bytes]:
    n = int(np.frombuffer(stream[:2], dtype=np.uint16)[0])
    out = []
    cursor = 2
    for _ in range(n):
        ln = int(np.frombuffer(stream[cursor : cursor + 4], dtype=np.uint32)[0])
        out.append(stream[cursor + 4 : cursor + 4 + ln])
        cursor += 4 + ln
    return out


def file_size_bits(path: str) -> int:
    return os.stat(path).st_size * 8
