"""A plain SER writer (the LUCAM-RECORDER container of planetary capture
programs): a 178-byte little-endian header, then the frames, rows
top-down, mono 16-bit little-endian words (the header's
``LittleEndian`` field 0, as capture programs write it)."""

from __future__ import annotations

import os
import struct

HEADER = 178


class SerWriter:
    def __init__(self, path: str, width: int, height: int,
                 depth: int = 16):
        self.path, self.w, self.h, self.depth = path, width, height, depth
        self.frames = 0
        self.f = open(path, "wb")
        self.f.write(b"\0" * HEADER)

    def write(self, data: bytes) -> None:
        """Frames of ``width × height`` 16-bit words, packed."""
        per = self.w * self.h * 2
        assert len(data) % per == 0
        self.f.write(data)
        self.frames += len(data) // per

    def close(self) -> None:
        hdr = b"LUCAM-RECORDER" + struct.pack(
            "<iiiiiiI", 0, 0, 0, self.w, self.h, self.depth, self.frames)
        hdr += b"\0" * 120 + struct.pack("<qq", 0, 0)
        assert len(hdr) == HEADER
        self.f.seek(0)
        self.f.write(hdr)
        self.f.flush()
        os.fsync(self.f.fileno())      # no write-back under the window
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
