"""Uncompressed AVI container — counterpart of ``siril_tpu/io/avi.py``
(``_chunk``:19, ``AviWriter``:24, ``AviReader``:98), the reference's
PIPP-derived AVI writer (``src/io/avi_pipp/``) and the uncompressed-DIB
case of its film import (``src/io/films.c``): RIFF/AVI with ``00db``
frames (BGR24 rows bottom-up, or 8-bit grey with a palette) and an
``idx1`` index, with no codec.  Frames decode to [0, 1] float32 as the
JAX package's reader does (u8 / 255); ``export_avi`` (:164) writes a
sequence's selected frames (the sirilpy ``export_sequence_avi``).  Host
code.
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np

from siril_tpu_torch.core.image import SirilImage


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def to_u8(img: SirilImage) -> np.ndarray:
    """(C, H, W) uint8 of an image's [0, 1] data (``SirilImage.to_u8``)."""
    return np.rint(np.clip(img.host(), 0.0, 1.0) * 255.0).astype(np.uint8)


class AviWriter:
    """Uncompressed AVI writer (avi_pipp): BGR24 when ``color``, else
    8-bit grey; frames are kept in memory until ``close``."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 25.0, color: bool = True):
        self.path = path
        self.w = width
        self.h = height
        self.fps = fps
        self.color = color
        self._frames: List[bytes] = []

    def add_frame(self, img: SirilImage) -> None:
        u8 = to_u8(img)
        if self.color:
            if u8.shape[0] == 1:
                u8 = np.repeat(u8, 3, axis=0)
            # BGR24 rows bottom-up, 4-byte aligned
            bgr = np.stack([u8[2], u8[1], u8[0]], axis=-1)[::-1]
            row = bgr.reshape(self.h, -1)
        else:
            row = u8[0][::-1]
        stride = (row.shape[1] + 3) & ~3
        if stride != row.shape[1]:
            padded = np.zeros((self.h, stride), np.uint8)
            padded[:, : row.shape[1]] = row
            row = padded
        self._frames.append(row.tobytes())

    def close(self) -> None:
        n = len(self._frames)
        bpp = 24 if self.color else 8
        frame_size = len(self._frames[0]) if self._frames else 0
        usec = int(1_000_000 / max(self.fps, 1e-3))
        avih = struct.pack("<14I", usec, frame_size * int(self.fps), 0,
                           0x10, n, 0, 1, frame_size, self.w, self.h,
                           0, 0, 0, 0)
        strh = (b"vids" + b"DIB " + struct.pack("<I", 0)
                + struct.pack("<IIIII", 0, 0, 0, 1, int(self.fps))
                + struct.pack("<IIIi", 0, n, frame_size, -1)
                + struct.pack("<I", 0) + struct.pack("<4H", 0, 0,
                                                     self.w, self.h))
        palette = b""
        if not self.color:
            palette = b"".join(struct.pack("<4B", i, i, i, 0)
                               for i in range(256))
        strf = struct.pack("<IiiHHIIiiII", 40, self.w, self.h, 1, bpp,
                           0, frame_size, 0, 0,
                           256 if not self.color else 0, 0) + palette
        strl = b"LIST" + struct.pack(
            "<I", 4 + len(_chunk(b"strh", strh)) + len(_chunk(b"strf", strf))
        ) + b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl_payload = b"avih" + struct.pack("<I", len(avih)) + avih + strl
        hdrl = b"LIST" + struct.pack("<I", 4 + len(hdrl_payload)) \
            + b"hdrl" + hdrl_payload

        parts = [b"movi"]
        offsets = []
        pos = 4
        for f in self._frames:
            offsets.append(pos)
            c = _chunk(b"00db", f)
            parts.append(c)
            pos += len(c)
        movi_payload = b"".join(parts)
        movi = b"LIST" + struct.pack("<I", len(movi_payload)) + movi_payload
        idx = b"".join(b"00db" + struct.pack("<III", 0x10, off, len(f))
                       for off, f in zip(offsets, self._frames))
        riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", idx)
        with open(self.path, "wb") as fh:
            fh.write(b"RIFF" + struct.pack("<I", len(riff_payload))
                     + riff_payload)


class AviReader:
    """Random-access reader for uncompressed ('DIB ' / raw) AVI files.
    A compressed one raises ``ValueError``: its stream format names a
    codec, or it holds no frame.  (The JAX package's reader looks only for
    frames, so it takes an MJPG stream's ``00dc`` chunks for raw rows and
    fails when it reads them; the port hands every compressed AVI to
    OpenCV, ROADMAP §3.)"""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise ValueError("not an AVI file")
        self.w = self.h = 0
        self.bpp = 24
        self._frame_spans: List[Tuple[int, int]] = []
        pos = 12
        while pos + 8 <= len(data):
            fourcc = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if fourcc == b"LIST":
                if data[pos + 8:pos + 12] == b"movi":
                    p = pos + 12
                    end = pos + 8 + size
                    while p + 8 <= end:
                        cc = data[p:p + 4]
                        sz = struct.unpack("<I", data[p + 4:p + 8])[0]
                        if cc[2:4] in (b"db", b"dc"):
                            self._frame_spans.append((p + 8, sz))
                        p += 8 + sz + (sz & 1)
                    pos += 8 + size + (size & 1)
                else:
                    pos += 12          # descend into hdrl / strl
            elif fourcc == b"strf":
                (_, w, h, _, bpp, compression) = struct.unpack(
                    "<IiiHHI", data[pos + 8:pos + 28])
                if compression not in (0, 3):          # BI_RGB, BI_BITFIELDS
                    raise ValueError("compressed AVI stream")
                self.w, self.h, self.bpp = w, abs(h), bpp
                pos += 8 + size + (size & 1)
            else:
                pos += 8 + size + (size & 1)
        self.nframes = len(self._frame_spans)
        if self.nframes == 0 or self.w == 0:
            raise ValueError("no uncompressed frames found in AVI")
        self._data = data

    @property
    def nchans(self) -> int:
        return 3 if self.bpp == 24 else 1

    def read_frame(self, index: int) -> SirilImage:
        off, sz = self._frame_spans[index]
        raw = np.frombuffer(self._data[off:off + sz], np.uint8)
        if self.bpp == 24:
            stride = (self.w * 3 + 3) & ~3
            rows = raw[: stride * self.h].reshape(self.h, stride)
            bgr = rows[:, : self.w * 3].reshape(self.h, self.w, 3)
            rgb = bgr[::-1, :, ::-1]       # bottom-up BGR → top-down RGB
            data = np.moveaxis(rgb, -1, 0).astype(np.float32) / 255.0
        elif self.bpp == 8:
            stride = (self.w + 3) & ~3
            rows = raw[: stride * self.h].reshape(self.h, stride)
            data = rows[::-1, : self.w][None].astype(np.float32) / 255.0
        else:
            raise ValueError(f"unsupported AVI bit depth {self.bpp}")
        img = SirilImage(data=np.ascontiguousarray(data))
        img.keywords.filename = os.path.basename(self.path)
        return img


def export_avi(seq, path: str, fps: float = 25.0) -> int:
    """Export a sequence's selected frames as an uncompressed AVI (the
    reference's AVI export, avi_pipp); the number of frames."""
    first = seq.read_frame(int(seq.selected_indices()[0]))
    wr = AviWriter(path, first.width, first.height, fps, first.nchans == 3)
    n = 0
    for i in seq.selected_indices():
        wr.add_frame(seq.read_frame(int(i)))
        n += 1
    wr.close()
    return n
