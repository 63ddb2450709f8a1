"""DNG (Adobe Digital Negative) raw import — counterpart of
``siril_tpu/io/dng.py`` (``_ljpeg_decode_py``:99, ``read_dng``:293), host
code copied for the port.  The DSLR/mirrorless raw
path (reference: libraw via ``src/io/image_formats_libraries.c``; DNG is
the openly-specified raw container every proprietary raw converts to).

Implements the TIFF/EP structure directly:
  - IFD walk (II/MM byte order, SubIFD chase) to the raw CFA IFD
    (PhotometricInterpretation 32803, or 34892 LinearRaw)
  - strip and tile layouts
  - Compression 1 (uncompressed, 8/10/12/14/16-bit packed big-endian
    per TIFF6 packing) and 7 (lossless JPEG SOF3 — native decoder in
    ``siril_tpu_torch/native/decoders.cpp``, which raises when it fails to
    build; ``_ljpeg_decode_py`` is its plain version, and no path falls
    back to it)
  - BlackLevel / WhiteLevel scaling to [0,1]
  - CFAPattern → Siril BAYERPAT string

Returns a mono CFA SirilImage ready for ``debayer``/calibration, like
the reference's raw loading path with debayering deferred.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from siril_tpu_torch.core.image import SirilImage

# TIFF tags
T_WIDTH, T_LENGTH, T_BITS, T_COMP, T_PHOTO = 256, 257, 258, 259, 262
T_STRIP_OFF, T_SPP, T_ROWS_PER_STRIP, T_STRIP_CNT = 273, 277, 278, 279
T_SUBIFD = 330
T_TILE_W, T_TILE_L, T_TILE_OFF, T_TILE_CNT = 322, 323, 324, 325
T_CFA_DIM, T_CFA_PAT = 33421, 33422
T_BLACK, T_WHITE = 50714, 50717
T_MAKE, T_MODEL = 271, 272
T_EXPOSURE, T_ISO = 33434, 34855

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 13: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


def _read_ifd(data: bytes, off: int, endian: str) -> Tuple[Dict, int]:
    (count,) = struct.unpack_from(endian + "H", data, off)
    entries = {}
    p = off + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", data, p)
        size = _TYPE_SIZE.get(typ, 1) * n
        if size <= 4:
            raw = data[p + 8:p + 8 + size]
        else:
            (voff,) = struct.unpack_from(endian + "I", data, p + 8)
            raw = data[voff:voff + size]
        entries[tag] = (typ, n, raw)
        p += 12
    (nxt,) = struct.unpack_from(endian + "I", data, p)
    return entries, nxt


def _values(entry, endian: str) -> List:
    typ, n, raw = entry
    fmt = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
           12: "d", 13: "I"}.get(typ)   # 13 = IFD offset (LONG-typed)
    if fmt:
        return list(struct.unpack_from(endian + fmt * n, raw, 0))
    if typ in (5, 10):      # rationals
        kind = "I" if typ == 5 else "i"
        vals = struct.unpack_from(endian + kind * (2 * n), raw, 0)
        return [vals[2 * i] / vals[2 * i + 1] if vals[2 * i + 1] else 0.0
                for i in range(n)]
    if typ == 2:
        return [raw.split(b"\0")[0].decode("ascii", "replace")]
    return [raw]


def _unpack_bits(raw: bytes, bits: int, count: int,
                 endian: str = ">") -> np.ndarray:
    """TIFF6 bit packing → uint16 samples.  16-bit samples follow the
    FILE byte order (little-endian 'II' DNGs are the common case); sub-
    byte packing is always MSB-first per TIFF6."""
    if bits == 16:
        return np.frombuffer(raw, endian + "u2",
                             count=count).astype(np.uint16)
    if bits == 8:
        return np.frombuffer(raw, np.uint8, count=count).astype(np.uint16)
    b = np.frombuffer(raw, np.uint8)
    bitarr = np.unpackbits(b)
    usable = (len(bitarr) // bits) * bits
    groups = bitarr[:usable].reshape(-1, bits)[:count]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (groups.astype(np.uint32) @ weights).astype(np.uint16)


# ---------------------------------------------------------------------------
# the plain Python lossless JPEG decoder (the native one's semantics)
# ---------------------------------------------------------------------------


def _ljpeg_decode_py(data: bytes):
    if data[:2] != b"\xff\xd8":
        return None
    p = 2
    precision = width = height = ncomp = 0
    comp_tbl = [0, 0, 0, 0]
    predictor, pt, restart = 1, 0, 0
    tables: Dict[int, Tuple] = {}
    scan_start = -1
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            p += 1
            continue
        m = data[p + 1]
        p += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        seglen = (data[p] << 8) | data[p + 1]
        if m == 0xC3:
            precision = data[p + 2]
            height = (data[p + 3] << 8) | data[p + 4]
            width = (data[p + 5] << 8) | data[p + 6]
            ncomp = data[p + 7]
        elif m == 0xC4:
            q = p + 2
            while q + 17 <= p + seglen:
                th = data[q] & 0x0F
                counts = list(data[q + 1:q + 17])
                total = sum(counts)
                symbols = list(data[q + 17:q + 17 + total])
                # canonical code map
                lut = {}
                code = 0
                k = 0
                for l in range(1, 17):
                    for _ in range(counts[l - 1]):
                        lut[(l, code)] = symbols[k]
                        code += 1
                        k += 1
                    code <<= 1
                tables[th] = lut
                q += 17 + total
        elif m == 0xDD:
            restart = (data[p + 2] << 8) | data[p + 3]
        elif m == 0xDA:
            ns = data[p + 2]
            q = p + 3
            for i in range(min(ns, 4)):
                comp_tbl[i] = (data[q + 1] >> 4) & 0x0F
                q += 2
            predictor = data[q]
            pt = data[q + 2] & 0x0F
            scan_start = p + seglen
            break
        p += seglen
    if scan_start < 0:
        return None

    # de-stuff scan bytes into a bit string
    scan = bytearray()
    q = scan_start
    markers = []
    while q < len(data):
        b = data[q]
        if b == 0xFF:
            if q + 1 < len(data) and data[q + 1] == 0x00:
                scan.append(0xFF)
                q += 2
                continue
            if q + 1 < len(data) and 0xD0 <= data[q + 1] <= 0xD7:
                markers.append(len(scan))
                q += 2
                continue
            break
        scan.append(b)
        q += 1
    bits = np.unpackbits(np.frombuffer(bytes(scan), np.uint8))
    bpos = 0
    marker_bits = [m * 8 for m in markers]
    mk = 0

    def get(n):
        nonlocal bpos
        v = 0
        for _ in range(n):
            v = (v << 1) | int(bits[bpos])
            bpos += 1
        return v

    def huff(th):
        nonlocal bpos
        lut = tables[th]
        code = 0
        for l in range(1, 17):
            code = (code << 1) | int(bits[bpos])
            bpos += 1
            if (l, code) in lut:
                return lut[(l, code)]
        return None

    rowlen = width * ncomp
    out = np.zeros((height, rowlen), np.uint16)
    prev = np.zeros(rowlen, np.int64)
    cur = np.zeros(rowlen, np.int64)
    default_pred = 1 << (precision - pt - 1)
    fresh = True
    mcu = 0
    for y in range(height):
        row_fresh = y == 0
        for x in range(width):
            for c in range(ncomp):
                t = huff(comp_tbl[c])
                if t is None:
                    return None
                if t == 16:
                    diff = 32768
                else:
                    v = get(t)
                    diff = v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v
                i = x * ncomp + c
                if fresh:
                    pred = default_pred
                elif x == 0:
                    pred = int(prev[i])
                elif row_fresh:
                    pred = int(cur[i - ncomp])
                else:
                    ra, rb, rc = (int(cur[i - ncomp]), int(prev[i]),
                                  int(prev[i - ncomp]))
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                            5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}.get(predictor, ra)
                val = (pred + diff) & 0xFFFF
                cur[i] = val
                out[y, i] = val << pt
            fresh = False
            mcu += 1
            if restart and mcu % restart == 0 and mk < len(marker_bits):
                # jump to the byte after the restart marker
                bpos = marker_bits[mk]
                mk += 1
                fresh = True
        prev, cur = cur, prev
    return out, ncomp


def _ljpeg_decode(data: bytes):
    from siril_tpu_torch import native

    return native.decode_ljpeg(data)


def ljpeg_precision(data: bytes) -> int:
    """SOF3 sample precision (bits) of a lossless-JPEG stream, 0 if
    absent.  The true bit depth of a CR2 raw lives here — guessing it
    from the decoded pixel maximum misclassifies underexposed 14-bit
    frames (max < 4096) as 12-bit."""
    if data[:2] != b"\xff\xd8":
        return 0
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            p += 1
            continue
        m = data[p + 1]
        p += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        seglen = (data[p] << 8) | data[p + 1]
        if m == 0xC3:
            return data[p + 2]
        p += seglen
    return 0


# ---------------------------------------------------------------------------
# DNG loader
# ---------------------------------------------------------------------------


def is_dng(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return False
    return head[:2] in (b"II", b"MM") and len(head) >= 4 and \
        head[2:4] in (b"*\x00", b"\x00*")


def read_dng(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    endian = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic != 42:
        raise ValueError(f"{path}: not a TIFF/DNG")
    (ifd0_off,) = struct.unpack_from(endian + "I", data, 4)

    # walk IFD0 + SubIFDs, collect candidates
    ifds = []
    seen = set()
    stack = [ifd0_off]
    while stack:
        off = stack.pop()
        if off in seen or off == 0 or off >= len(data):
            continue
        seen.add(off)
        try:
            entries, nxt = _read_ifd(data, off, endian)
        except struct.error:
            continue
        ifds.append(entries)
        if nxt:
            stack.append(nxt)
        if T_SUBIFD in entries:
            stack.extend(_values(entries[T_SUBIFD], endian))

    raw_ifd = None
    for e in ifds:
        photo = _values(e[T_PHOTO], endian)[0] if T_PHOTO in e else 0
        if photo in (32803, 34892):
            raw_ifd = e
            break
    if raw_ifd is None:
        # fall back to the largest strip/tile IFD
        best = 0
        for e in ifds:
            if T_WIDTH in e:
                a = _values(e[T_WIDTH], endian)[0] * \
                    _values(e[T_LENGTH], endian)[0]
                if a > best:
                    best, raw_ifd = a, e
        if raw_ifd is None:
            raise ValueError(f"{path}: no raw IFD found")
    e = raw_ifd

    width = _values(e[T_WIDTH], endian)[0]
    height = _values(e[T_LENGTH], endian)[0]
    bits = _values(e[T_BITS], endian)[0] if T_BITS in e else 16
    comp = _values(e[T_COMP], endian)[0] if T_COMP in e else 1
    img = np.zeros((height, width), np.uint16)

    def place(tile, y0, x0):
        th, tw = tile.shape
        y1 = min(y0 + th, height)
        x1 = min(x0 + tw, width)
        img[y0:y1, x0:x1] = tile[: y1 - y0, : x1 - x0]

    def decode_chunk(raw, th, tw):
        if comp == 1:
            return _unpack_bits(raw, bits, th * tw,
                                endian).reshape(th, tw)
        if comp == 7:
            res = _ljpeg_decode(raw)
            if res is None:
                raise ValueError(f"{path}: lossless JPEG decode failed")
            arr, nc = res
            return arr.reshape(-1)[: th * tw].reshape(th, tw)
        raise ValueError(f"{path}: unsupported DNG compression {comp}")

    if T_TILE_OFF in e:
        tw = _values(e[T_TILE_W], endian)[0]
        tl = _values(e[T_TILE_L], endian)[0]
        offs = _values(e[T_TILE_OFF], endian)
        cnts = _values(e[T_TILE_CNT], endian)
        i = 0
        for y0 in range(0, height, tl):
            for x0 in range(0, width, tw):
                raw = data[offs[i]: offs[i] + cnts[i]]
                place(decode_chunk(raw, tl, tw), y0, x0)
                i += 1
    else:
        offs = _values(e[T_STRIP_OFF], endian)
        cnts = _values(e[T_STRIP_CNT], endian)
        rps = _values(e[T_ROWS_PER_STRIP], endian)[0] \
            if T_ROWS_PER_STRIP in e else height
        y0 = 0
        for i in range(len(offs)):
            th = min(rps, height - y0)
            raw = data[offs[i]: offs[i] + cnts[i]]
            place(decode_chunk(raw, th, width), y0, 0)
            y0 += th

    black = 0.0
    white = float((1 << bits) - 1)
    if T_BLACK in e:
        black = float(np.mean(_values(e[T_BLACK], endian)))
    if T_WHITE in e:
        white = float(np.mean(_values(e[T_WHITE], endian)))
    arr = (img.astype(np.float32) - black) / max(white - black, 1.0)
    arr = np.clip(arr, 0.0, 1.0)

    out = SirilImage(data=arr[None])
    # CFA pattern
    if T_CFA_PAT in e:
        pat_raw = _values(e[T_CFA_PAT], endian)
        if isinstance(pat_raw[0], (bytes, bytearray)):
            vals = list(pat_raw[0])
        else:
            vals = [int(v) for v in pat_raw]
        lut = {0: "R", 1: "G", 2: "B"}
        pat = "".join(lut.get(v, "G") for v in vals[:4])
        if len(pat) == 4:
            out.keywords.bayer_pattern = pat
    # a bit of metadata
    ifd0, _ = _read_ifd(data, ifd0_off, endian)
    if T_MAKE in ifd0 or T_MODEL in ifd0:
        make = _values(ifd0[T_MAKE], endian)[0] if T_MAKE in ifd0 else ""
        model = _values(ifd0[T_MODEL], endian)[0] if T_MODEL in ifd0 else ""
        out.keywords.instrume = f"{make} {model}".strip()
    for src in (e, ifd0):
        if T_EXPOSURE in src:
            out.keywords.exposure = float(_values(src[T_EXPOSURE],
                                                  endian)[0])
            break
    out.log_history("DNG raw import")
    return out
