"""XISF (PixInsight Extensible Image Serialization Format) reader/writer —
counterpart of ``siril_tpu/io/xisf.py`` (``read_xisf``:67,
``write_xisf``:141), host code copied for the port.

Equivalent of the reference's ``src/io/SirilXISFReader.cpp`` (libXISF +
zstd).  Pure-Python implementation of the XISF 1.0 monolithic container:

  signature "XISF0100" | uint32 headerLength | 4 reserved bytes |
  XML header | attached data blocks

Supported: attachment and inline/embedded base64 blocks, zlib compression
(+ byte shuffling), UInt8/16/32 and Float32/64 samples, planar or normal
pixel storage, FITSKeyword properties.  zstd/lz4 compression is gated
(module not in this build).
"""

from __future__ import annotations

import base64
import os
import xml.etree.ElementTree as ET
import zlib
from typing import Optional

import numpy as np

from siril_tpu_torch.core.image import SirilImage, ensure_chw

_SIG = b"XISF0100"
_NS = "{http://www.pixinsight.com/xisf}"

_DTYPES = {
    "UInt8": (np.uint8, 255.0),
    "UInt16": (np.uint16, 65535.0),
    "UInt32": (np.uint32, 4294967295.0),
    "Float32": (np.float32, 1.0),
    "Float64": (np.float64, 1.0),
}


def _unshuffle(data: bytes, item_size: int) -> bytes:
    """Reverse XISF byte shuffling (byte-plane transposition)."""
    if item_size <= 1:
        return data
    n = len(data) // item_size
    arr = np.frombuffer(data[:n * item_size], np.uint8)
    return arr.reshape(item_size, n).T.tobytes() + data[n * item_size:]


def _decode_block(raw: bytes, compression: Optional[str],
                  item_size: int) -> bytes:
    if not compression:
        return raw
    parts = compression.split(":")
    codec = parts[0].lower()
    if codec in ("zlib", "zlib+sh"):
        out = zlib.decompress(raw)
    elif codec.startswith(("zstd", "lz4")):
        raise ValueError(f"XISF compression codec '{codec}' not available "
                         "in this build (zlib supported)")
    else:
        raise ValueError(f"unknown XISF compression: {codec}")
    if codec.endswith("+sh"):
        sh_size = int(parts[2]) if len(parts) > 2 else item_size
        out = _unshuffle(out, sh_size)
    return out


def read_xisf(path: str) -> SirilImage:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIG:
        raise ValueError("not a monolithic XISF file")
    hlen = int.from_bytes(blob[8:12], "little")
    header = blob[16:16 + hlen].decode("utf-8", "replace")
    root = ET.fromstring(header)
    img_el = root.find(f"{_NS}Image")
    if img_el is None:
        img_el = root.find("Image")
    if img_el is None:
        raise ValueError("XISF header contains no Image element")

    geom = img_el.get("geometry", "")
    dims = [int(v) for v in geom.split(":")]
    if len(dims) < 3:
        raise ValueError(f"unsupported XISF geometry: {geom}")
    w, h, c = dims[0], dims[1], dims[-1]
    fmt = img_el.get("sampleFormat", "UInt16")
    if fmt not in _DTYPES:
        raise ValueError(f"unsupported XISF sampleFormat: {fmt}")
    dtype, maxval = _DTYPES[fmt]
    item = np.dtype(dtype).itemsize
    expected = w * h * c * item

    loc = img_el.get("location", "")
    comp = img_el.get("compression")
    if loc.startswith("attachment:"):
        _, off, size = loc.split(":")
        raw = blob[int(off):int(off) + int(size)]
    elif loc.startswith("inline:"):
        enc = loc.split(":")[1]
        if enc != "base64":
            raise ValueError(f"unsupported inline encoding: {enc}")
        raw = base64.b64decode(img_el.text or "")
    elif loc == "embedded":
        data_el = img_el.find(f"{_NS}Data") or img_el.find("Data")
        raw = base64.b64decode((data_el.text or "") if data_el is not None
                               else "")
    else:
        raise ValueError(f"unsupported XISF block location: {loc}")
    raw = _decode_block(raw, comp, item)
    if len(raw) < expected:
        raise ValueError("truncated XISF data block")

    arr = np.frombuffer(raw[:expected], dtype).astype(np.float32)
    if fmt.startswith("UInt"):
        arr /= maxval
    storage = img_el.get("pixelStorage", "Planar")
    if storage.lower() == "planar":
        data = arr.reshape(c, h, w)
    else:                                       # Normal: interleaved
        data = np.moveaxis(arr.reshape(h, w, c), -1, 0)
    img = SirilImage(data=np.ascontiguousarray(data))

    # FITSKeyword properties → keywords.extra
    for kw in img_el.iter():
        if kw.tag.endswith("FITSKeyword"):
            name = kw.get("name", "").upper()
            value = kw.get("value", "").strip("'\" ")
            if not name:
                continue
            for conv in (int, float):
                try:
                    value = conv(value)
                    break
                except (TypeError, ValueError):
                    pass
            img.keywords.extra[name] = value
    img.keywords.filename = os.path.basename(path)
    return img


def _shuffle(data: bytes, item_size: int) -> bytes:
    """XISF byte shuffling (the byte planes of the items, in turn)."""
    n = len(data) // item_size
    arr = np.frombuffer(data[:n * item_size], np.uint8)
    return arr.reshape(n, item_size).T.tobytes() + data[n * item_size:]


def write_xisf(img: SirilImage, path: str, sample_format: str = "Float32",
               compress: bool = False, shuffle: bool = False) -> None:
    """Monolithic XISF writer (uncompressed or zlib attachment block;
    ``shuffle``, with ``compress``, shuffles the bytes first:
    ``zlib+sh``)."""
    if sample_format not in ("UInt16", "Float32"):
        raise ValueError("write_xisf supports UInt16 or Float32")
    data = img.host()
    c, h, w = data.shape
    if sample_format == "UInt16":
        payload = (np.clip(data, 0, 1) * 65535.0 + 0.5).astype("<u2").tobytes()
    else:
        payload = data.astype("<f4").tobytes()
    comp_attr = ""
    if compress:
        item = 2 if sample_format == "UInt16" else 4
        if shuffle:
            comp_payload = zlib.compress(_shuffle(payload, item), 6)
            comp_attr = f' compression="zlib+sh:{len(payload)}:{item}"'
        else:
            comp_payload = zlib.compress(payload, 6)
            comp_attr = f' compression="zlib:{len(payload)}"'
        payload = comp_payload

    kws = "".join(
        f'<FITSKeyword name="{k}" value="{v}" comment=""/>'
        for k, v in img.keywords.extra.items())
    # two-pass: header length depends on the data offset digits; pad header
    for pad in range(1, 5):
        guess = 16 + 2048 * pad
        hdr = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<xisf version="1.0" xmlns="http://www.pixinsight.com/xisf">'
            f'<Image geometry="{w}:{h}:{c}" sampleFormat="{sample_format}" '
            f'colorSpace="{"RGB" if c == 3 else "Gray"}" '
            f'pixelStorage="Planar"{comp_attr} '
            f'location="attachment:{guess}:{len(payload)}">'
            f"{kws}</Image></xisf>").encode()
        if len(hdr) <= guess - 16:
            break
    else:
        raise ValueError("XISF header too large")
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(len(hdr).to_bytes(4, "little"))
        f.write(b"\0" * 4)
        f.write(hdr)
        f.write(b"\0" * (guess - 16 - len(hdr)))
        f.write(payload)
