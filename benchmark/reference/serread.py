"""A plain SER reader for the reference: mono frames of 8 or 16 bits,
the ``LittleEndian`` field read as capture programs write it (0:
little-endian words)."""

from __future__ import annotations

import struct

import numpy as np

HEADER = 178


def open_video(path: str) -> np.ndarray:
    """(N, H, W) unsigned integers, memory-mapped."""
    with open(path, "rb") as f:
        hdr = f.read(HEADER)
    if hdr[:14] != b"LUCAM-RECORDER":
        raise ValueError(f"{path}: not a SER file")
    _, color, endian, w, h, depth, n = struct.unpack_from("<iiiiiiI", hdr,
                                                         14)
    if color != 0:
        raise ValueError("the reader takes mono videos only")
    dt = np.dtype("u1") if depth <= 8 else np.dtype(">u2" if endian
                                                   else "<u2")
    return np.memmap(path, dt, "r", HEADER, (n, h, w))


def max_value(video: np.ndarray) -> float:
    return 255.0 if video.dtype.itemsize == 1 else 65535.0
