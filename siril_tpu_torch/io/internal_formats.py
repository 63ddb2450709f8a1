"""Dependency-free readers for legacy formats — counterpart of
``siril_tpu/io/internal_formats.py`` (``read_pic``:21, ``write_pic``:50),
host code copied for the port; ``src/io/image_formats_internal.c``
equivalent.  ``io/image_formats.py`` covers BMP/PNM/PPM;
this module adds the IRIS PIC format (``readpic``,
image_formats_internal.c:974): 290-byte header with magic 0x12231fc,
u16 little-endian pixels, mono or planar RGB, bottom-up rows.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from siril_tpu_torch.core.image import SirilImage

PIC_MAGIC = 0x12231FC
PIC_HEADER_SIZE = 290


def read_pic(path: str) -> SirilImage:
    with open(path, "rb") as f:
        header = f.read(PIC_HEADER_SIZE)
        if len(header) < PIC_HEADER_SIZE:
            raise ValueError("truncated PIC header")
        magic = struct.unpack_from("<I", header, 0)[0]
        if magic != PIC_MAGIC:
            raise ValueError("wrong magic cookie in PIC file")
        w = struct.unpack_from("<H", header, 68)[0]
        h = struct.unpack_from("<H", header, 70)[0]
        binning = header[80:92]
        raw = np.fromfile(f, "<u2")
    npx = w * h
    if npx == 0:
        raise ValueError("empty PIC image")
    planes = 3 if raw.size >= 3 * npx else 1
    data = (raw[: planes * npx].reshape(planes, h, w).astype(np.float32)
            / 65535.0)
    data = data[:, ::-1, :]                  # bottom-up → top-down
    img = SirilImage(data=np.ascontiguousarray(data))
    img.keywords.binning_x = int(binning[4]) or 1
    img.keywords.binning_y = int(binning[5]) or 1
    img.keywords.filename = os.path.basename(path)
    from siril_tpu_torch.core.image import USHORT_IMG

    img.orig_bitdepth = USHORT_IMG
    return img


def write_pic(img: SirilImage, path: str) -> None:
    """Writer for round-trip tests and IRIS interchange."""
    data = img.host()
    c, h, w = data.shape
    header = bytearray(PIC_HEADER_SIZE)
    struct.pack_into("<I", header, 0, PIC_MAGIC)
    struct.pack_into("<H", header, 68, w)
    struct.pack_into("<H", header, 70, h)
    header[84] = img.keywords.binning_x or 1
    header[85] = img.keywords.binning_y or 1
    u16 = np.clip(data[:, ::-1, :] * 65535.0 + 0.5, 0,
                  65535).astype("<u2")
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(u16.tobytes())
