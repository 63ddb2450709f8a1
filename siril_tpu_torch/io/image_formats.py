"""TIFF, PNG, BMP and PNM on the host, in numpy and ``zlib`` — the port's
own codec for the formats that ``siril_tpu/io/conversion.py:75-91`` and
``siril_tpu/cli/commands.py:140-202`` read and write through PIL
(reference ``src/io/image_formats_libraries.c`` and
``image_formats_internal.c``).  PIL is not on every machine the port runs
on, and it cannot write a colour image of 16-bit or float samples.

Writers (``write_tiff``, ``write_png``, ``write_bmp``, ``write_pnm``)
take a planar (C, H, W) array of one or three layers:
- TIFF: uint8, uint16 or float32 samples, chunky, little-endian, in
  strips, uncompressed or deflate (compression 8);
- PNG: uint8 or uint16, grey or RGB, every row with filter 0;
- BMP: uint8, RGB as 24 bits, grey as 8 bits with a grey palette;
- PNM: uint8 or uint16, PGM (P5) or PPM (P6).

``read_image`` reads the same, and more: TIFF of either byte order, in
strips, uncompressed or deflate (8 or 32946), horizontal predictor,
chunky or planar, 8, 16, 32 (float) or 64 (float) bits; PNG of 8 or 16
bits with every row filter (undone in ``native/decoders.cpp``), grey,
RGB, palette and alpha; BMP of 8 (palette), 24 or 32 bits; PNM P2, P3, P5
and P6.  An integer sample becomes float32 divided by its maximum (255 or
65535; a PNM's by its maxval), a float sample stays as it is, and an
alpha layer is dropped.  A variant outside these (LZW or PackBits TIFF,
tiles, interlaced PNG, fewer than 8 bits) raises ``Unsupported``, and
``io/conversion.load_any`` hands the file to PIL where it is installed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from siril_tpu_torch.core.image import SirilImage

TIFF_EXT = (".tif", ".tiff")
PNG_EXT = (".png",)
BMP_EXT = (".bmp",)
PNM_EXT = (".pnm", ".ppm", ".pgm")
CODEC_EXT = TIFF_EXT + PNG_EXT + BMP_EXT + PNM_EXT

#: rows of an uncompressed or deflate TIFF strip: about 64 KiB a strip
TIFF_STRIP_BYTES = 1 << 16


class Unsupported(ValueError):
    """A file of a codec format in a variant this codec does not read."""


def _planar(arr: np.ndarray) -> np.ndarray:
    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[None]
    if a.ndim != 3 or a.shape[0] not in (1, 3):
        raise ValueError(f"an image of 1 or 3 layers is needed, not "
                         f"{a.shape}")
    return a


def _interleaved(arr: np.ndarray) -> np.ndarray:
    """(C, H, W) → (H, W, C) contiguous."""
    return np.ascontiguousarray(np.moveaxis(_planar(arr), 0, 2))


def _to_float(a: np.ndarray, maxval: float = 0.0) -> np.ndarray:
    """Integer samples over their maximum (``maxval``, else 255 or
    65535), as the JAX package's ``load_any`` scales PIL's arrays; float
    samples as float32."""
    if a.dtype.kind == "f":
        return a.astype(np.float32)
    if not maxval:
        maxval = 255.0 if a.dtype.itemsize == 1 else 65535.0
    return a.astype(np.float32) / np.float32(maxval)


def _image(hwc: np.ndarray, path: str, maxval: float = 0.0) -> SirilImage:
    """An (H, W, C) sample array as a SirilImage: grey + alpha → grey,
    RGBA → RGB."""
    c = hwc.shape[2]
    if c == 2:
        hwc = hwc[:, :, :1]
    elif c == 4:
        hwc = hwc[:, :, :3]
    elif c not in (1, 3):
        raise Unsupported(f"{path}: {c} samples a pixel")
    data = np.ascontiguousarray(np.moveaxis(_to_float(hwc, maxval), 2, 0))
    img = SirilImage(data=data)
    img.keywords.filename = os.path.basename(path)
    return img


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_T_WIDTH, _T_LENGTH, _T_BITS, _T_COMP, _T_PHOTO = 256, 257, 258, 259, 262
_T_STRIP_OFF, _T_SPP, _T_ROWS, _T_STRIP_CNT = 273, 277, 278, 279
_T_PLANAR, _T_PREDICTOR, _T_SAMPLEFMT = 284, 317, 339
_T_TILE_W = 322
_SHORT, _LONG = 3, 4


def write_tiff(path: str, arr: np.ndarray, deflate: bool = False) -> None:
    """A little-endian TIFF of ``arr``'s samples (uint8, uint16 or
    float32; 1 or 3 layers), in strips of about ``TIFF_STRIP_BYTES``."""
    hwc = _interleaved(arr)
    kind = hwc.dtype
    if kind not in (np.uint8, np.uint16, np.float32):
        raise ValueError(f"TIFF samples must be uint8, uint16 or float32, "
                         f"not {kind}")
    h, w, spp = hwc.shape
    bits = kind.itemsize * 8
    rowbytes = w * spp * kind.itemsize
    rps = max(1, min(h, TIFF_STRIP_BYTES // max(rowbytes, 1)))
    raw = hwc.astype(kind.newbyteorder("<"), copy=False).tobytes()
    strips: List[bytes] = []
    for y0 in range(0, h, rps):
        s = raw[y0 * rowbytes:min(h, y0 + rps) * rowbytes]
        strips.append(zlib.compress(s) if deflate else s)
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s) + (len(s) & 1)
    entries = [
        (_T_WIDTH, _LONG, [w]), (_T_LENGTH, _LONG, [h]),
        (_T_BITS, _SHORT, [bits] * spp),
        (_T_COMP, _SHORT, [8 if deflate else 1]),
        (_T_PHOTO, _SHORT, [2 if spp == 3 else 1]),
        (_T_STRIP_OFF, _LONG, offsets), (_T_SPP, _SHORT, [spp]),
        (_T_ROWS, _LONG, [rps]),
        (_T_STRIP_CNT, _LONG, [len(s) for s in strips]),
        (_T_PLANAR, _SHORT, [1]),
        (_T_SAMPLEFMT, _SHORT, [3 if kind == np.float32 else 1] * spp)]
    ifd_off = pos
    extra_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = bytearray(struct.pack("<H", len(entries)))
    extra = bytearray()
    for tag, typ, vals in entries:
        fmt = "<%d%s" % (len(vals), "H" if typ == _SHORT else "I")
        payload = struct.pack(fmt, *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra_off + len(extra))
            extra += payload
            if len(extra) & 1:
                extra += b"\0"
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + field
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd_off))
        for s in strips:
            f.write(s)
            if len(s) & 1:
                f.write(b"\0")
        f.write(bytes(ifd))
        f.write(bytes(extra))


def _tiff_dtype(bits: int, fmt: int, endian: str) -> np.dtype:
    if fmt == 3 and bits in (32, 64):
        return np.dtype(f"{endian}f{bits // 8}")
    if fmt in (1, 0) and bits in (8, 16):
        return np.dtype(f"{endian}u{bits // 8}")
    raise Unsupported(f"TIFF samples of {bits} bits, format {fmt}")


def read_tiff(path: str) -> SirilImage:
    from siril_tpu_torch.io.dng import _read_ifd, _values

    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"II", b"MM"):
        raise ValueError(f"{path}: not a TIFF file")
    endian = "<" if data[:2] == b"II" else ">"
    magic, ifd0 = struct.unpack_from(endian + "HI", data, 2)
    if magic != 42:
        raise Unsupported(f"{path}: TIFF magic {magic} (BigTIFF?)")
    e, _ = _read_ifd(data, ifd0, endian)

    def tag(t, default=None):
        return _values(e[t], endian) if t in e else default

    if _T_TILE_W in e:
        raise Unsupported(f"{path}: a tiled TIFF")
    w, h = int(tag(_T_WIDTH)[0]), int(tag(_T_LENGTH)[0])
    spp = int(tag(_T_SPP, [1])[0])
    bits = {int(b) for b in tag(_T_BITS, [1])}
    fmts = {int(v) for v in tag(_T_SAMPLEFMT, [1])}
    comp = int(tag(_T_COMP, [1])[0])
    photo = int(tag(_T_PHOTO, [1])[0])
    planar = int(tag(_T_PLANAR, [1])[0])
    pred = int(tag(_T_PREDICTOR, [1])[0])
    if len(bits) != 1 or len(fmts) != 1:
        raise Unsupported(f"{path}: samples of mixed sizes or formats")
    if comp not in (1, 8, 32946):
        raise Unsupported(f"{path}: TIFF compression {comp}")
    if photo not in (1, 2) or pred not in (1, 2):
        raise Unsupported(f"{path}: photometric {photo}, predictor {pred}")
    dt = _tiff_dtype(bits.pop(), fmts.pop(), endian)
    if pred == 2 and dt.kind == "f":
        raise Unsupported(f"{path}: a predictor on float samples")
    offs = tag(_T_STRIP_OFF)
    cnts = tag(_T_STRIP_CNT)
    parts = []
    for o, n in zip(offs, cnts):
        s = data[int(o):int(o) + int(n)]
        parts.append(zlib.decompress(s) if comp != 1 else s)
    raw = b"".join(parts)
    need = w * h * spp * dt.itemsize
    if len(raw) < need:
        raise ValueError(f"{path}: TIFF strips hold {len(raw)} bytes, "
                         f"{need} needed")
    a = np.frombuffer(raw, dt, count=w * h * spp)
    if planar == 2:
        a = a.reshape(spp, h, w)
        if pred == 2:
            a = np.cumsum(a, axis=2, dtype=a.dtype.newbyteorder("="))
        hwc = np.moveaxis(a, 0, 2)
    else:
        hwc = a.reshape(h, w, spp)
        if pred == 2:
            hwc = np.cumsum(hwc, axis=1, dtype=hwc.dtype.newbyteorder("="))
    return _image(np.ascontiguousarray(hwc, hwc.dtype.newbyteorder("=")),
                  path)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """A PNG of ``arr``'s uint8 or uint16 samples (1 or 3 layers), every
    row with filter 0, the image data deflated at zlib's default level."""
    hwc = _interleaved(arr)
    if hwc.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not "
                         f"{hwc.dtype}")
    h, w, c = hwc.shape
    rows = hwc.astype(hwc.dtype.newbyteorder(">"), copy=False).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rows.view(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, hwc.dtype.itemsize * 8,
                       2 if c == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path: str) -> SirilImage:
    from siril_tpu_torch import native

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    p, idat, plte = 8, [], None
    hdr = None
    while p + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, p)
        body = data[p + 8:p + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        p += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or ctype not in _PNG_SAMPLES:
        raise Unsupported(f"{path}: PNG of {depth} bits, colour type "
                          f"{ctype}, interlace {interlace}")
    spp = _PNG_SAMPLES[ctype]
    bpp = spp * depth // 8
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp,
                               bpp)
    a = rows.view(">u2" if depth == 16 else np.uint8).reshape(h, w, spp)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: a palette PNG without PLTE")
        a = _apply_palette(a[:, :, 0], plte)
    return _image(np.ascontiguousarray(a, a.dtype.newbyteorder("=")), path)


def _apply_palette(idx: np.ndarray, plte: np.ndarray) -> np.ndarray:
    """Palette indices → (H, W, 1) grey where the palette is grey, else
    (H, W, 3) RGB."""
    rgb = plte[np.minimum(idx, len(plte) - 1)]
    if (plte[:, 0] == plte[:, 1]).all() and (plte[:, 1] == plte[:, 2]).all():
        return rgb[:, :, :1]
    return rgb


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def write_bmp(path: str, arr: np.ndarray) -> None:
    """A BMP of ``arr``'s uint8 samples: 24 bits for RGB, 8 bits with a
    grey palette for one layer; rows bottom-up, padded to 4 bytes."""
    hwc = _interleaved(arr)
    if hwc.dtype != np.uint8:
        raise ValueError(f"BMP samples must be uint8, not {hwc.dtype}")
    h, w, c = hwc.shape
    px = hwc[::-1, :, ::-1] if c == 3 else hwc[::-1]
    rowbytes = w * c
    pad = (-rowbytes) % 4
    body = np.zeros((h, rowbytes + pad), np.uint8)
    body[:, :rowbytes] = px.reshape(h, rowbytes)
    palette = b""
    if c == 1:
        g = np.arange(256, dtype=np.uint8)
        palette = np.stack([g, g, g, np.zeros(256, np.uint8)], 1).tobytes()
    off = 14 + 40 + len(palette)
    size = off + body.size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8 * c, 0, body.size,
                       2835, 2835, 256 if c == 1 else 0, 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", size, 0, 0, off) + info
                + palette + body.tobytes())


def read_bmp(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (off,) = struct.unpack_from("<I", data, 10)
    hsize, w, h, _, bpp, comp = struct.unpack_from("<IiiHHI", data, 14)
    if comp != 0 or bpp not in (8, 24, 32):
        raise Unsupported(f"{path}: BMP of {bpp} bits, compression {comp}")
    top_down = h < 0
    h = abs(h)
    c = bpp // 8
    rowbytes = (w * c + 3) & ~3
    body = np.frombuffer(data, np.uint8, count=rowbytes * h, offset=off)
    px = body.reshape(h, rowbytes)[:, :w * c].reshape(h, w, c)
    if not top_down:
        px = px[::-1]
    if c == 1:
        (ncol,) = struct.unpack_from("<I", data, 46)
        ncol = ncol or 256
        pal = np.frombuffer(data, np.uint8, count=4 * ncol,
                            offset=14 + hsize).reshape(ncol, 4)[:, 2::-1]
        px = _apply_palette(px[:, :, 0], pal)
    else:
        px = px[:, :, 2::-1]
    return _image(np.ascontiguousarray(px), path)


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


def write_pnm(path: str, arr: np.ndarray) -> None:
    """A binary PGM (one layer) or PPM (three) of ``arr``'s uint8 or
    uint16 samples (maxval 255 or 65535, big-endian)."""
    hwc = _interleaved(arr)
    if hwc.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNM samples must be uint8 or uint16, not "
                         f"{hwc.dtype}")
    h, w, c = hwc.shape
    maxval = 255 if hwc.dtype == np.uint8 else 65535
    head = b"%s\n%d %d\n%d\n" % (b"P6" if c == 3 else b"P5", w, h, maxval)
    with open(path, "wb") as f:
        f.write(head + hwc.astype(hwc.dtype.newbyteorder(">"),
                                  copy=False).tobytes())


def _pnm_header(data: bytes) -> Tuple[List[int], int]:
    """The magic's digit, width, height and maxval, and the offset of the
    samples (one whitespace byte after the maxval)."""
    vals, p = [], 2
    while len(vals) < 3:
        while p < len(data) and data[p:p + 1].isspace():
            p += 1
        if data[p:p + 1] == b"#":
            while p < len(data) and data[p] not in (10, 13):
                p += 1
            continue
        q = p
        while q < len(data) and data[q:q + 1].isdigit():
            q += 1
        if q == p:
            raise ValueError("PNM: a malformed header")
        vals.append(int(data[p:q]))
        p = q
    return vals, p + 1


def read_pnm(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise Unsupported(f"{path}: PNM of type {magic!r}")
    (w, h, maxval), p = _pnm_header(data)
    c = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P2", b"P3"):
        a = np.array(data[p:].split()[:w * h * c], dtype=np.uint32)
        a = a.astype(np.uint16 if maxval > 255 else np.uint8)
    else:
        a = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8,
                          count=w * h * c, offset=p)
    a = a.reshape(h, w, c)
    return _image(np.ascontiguousarray(a, a.dtype.newbyteorder("=")), path,
                  maxval=float(maxval))


_READERS = {**{e: read_tiff for e in TIFF_EXT},
            **{e: read_png for e in PNG_EXT},
            **{e: read_bmp for e in BMP_EXT},
            **{e: read_pnm for e in PNM_EXT}}


def read_image(path: str) -> SirilImage:
    """A TIFF, PNG, BMP or PNM file by its extension; ``Unsupported``
    for a variant this codec does not read."""
    return _READERS[os.path.splitext(path)[1].lower()](path)
