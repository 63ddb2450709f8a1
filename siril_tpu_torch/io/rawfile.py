"""Proprietary DSLR raw import — counterpart of
``siril_tpu/io/rawfile.py`` (CR2:138, NEF:447, ARW:586, HEIF:632,
RAF:691, RW2:941, CR3:1031, PEF:1185, ORF:1194), host code copied for the
port: Canon CR2 and Nikon NEF (reference:
libraw via ``src/io/image_formats_libraries.c`` open_raw_files; this
module parses the two most common raw containers natively, reusing the
DNG module's TIFF walker and the native lossless-JPEG (SOF3) decoder).

CR2: TIFF container with magic "CR\\x02\\x00" at offset 8.  IFD3 holds
the sensor data as one lossless-JPEG stream; the ``cr2_slice`` tag
(0xC640 = [count, w1, w2]) describes the vertical slicing the decoder
output must be re-assembled from (column slices filled in stream
order).  Black level comes from the masked left border when present,
else Canon's nominal per-bit-depth pedestal.

NEF: TIFF container, Make = NIKON; the raw SubIFD uses compression 1
with Nikon's LSB-first 12/14-bit packing (NOT TIFF6 MSB packing —
2 px / 3 B at 12-bit, 4 px / 7 B at 14-bit), plain 16-bit, or Nikon
compression 34713: fixed-table Huffman predictor deltas + a MakerNote
linearization curve (lossless and lossy variants, incl. the lossy
tree switch at `split`); decoded natively (``decode_nikon`` of
``siril_tpu_torch/native/decoders.cpp``; ``_nikon_decode_py`` is its plain
version, and no path falls back to it).

ARW: TIFF container, Make = SONY; uncompressed 12/14/16-bit LE strips,
or Sony's ARW2 lossy block compression (compression 32767: 16-byte
blocks of 16 same-color pixels — 11-bit max/min, 4-bit positions,
seven-bit shifted deltas, tone curve; dcraw sony_arw2_load_raw).

RAF: Fujifilm container (magic + big-endian pointer header + CFA tag
table); uncompressed 16-bit LE sensor data, X-Trans 6×6 grid from tag
0x131 exported as the 36-char pattern string ops/xtrans.py consumes.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.io.dng import (
    T_BITS,
    T_COMP,
    T_CFA_PAT,
    T_EXPOSURE,
    T_LENGTH,
    T_MAKE,
    T_MODEL,
    T_PHOTO,
    T_ROWS_PER_STRIP,
    T_STRIP_CNT,
    T_STRIP_OFF,
    T_SUBIFD,
    T_WIDTH,
    _ljpeg_decode,
    _read_ifd,
    _values,
)

T_CR2_SLICE = 0xC640


def _walk_ifds(data: bytes, endian: str) -> List[dict]:
    (ifd0_off,) = struct.unpack_from(endian + "I", data, 4)
    ifds = []
    seen = set()
    stack = [ifd0_off]
    while stack:
        off = stack.pop(0)
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
    return ifds


# ---------------------------------------------------------------------------
# Canon CR2
# ---------------------------------------------------------------------------


def is_cr2(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return len(head) >= 12 and head[:2] == b"II" and head[8:10] == b"CR"


def _find_cfa_ifd(ifds, endian):
    """Largest IFD with PhotometricInterpretation==32803 (CFA)."""
    raw_ifd = None
    best = 0
    for e in ifds:
        photo = _values(e[T_PHOTO], endian)[0] if T_PHOTO in e else 0
        if photo == 32803 and T_WIDTH in e:
            a = _values(e[T_WIDTH], endian)[0] * \
                _values(e[T_LENGTH], endian)[0]
            if a > best:
                best, raw_ifd = a, e
    return raw_ifd


def _decode_cfa_pattern(e, endian, default="RGGB"):
    """CFAPattern tag (0/1/2 = R/G/B) -> 4-char Bayer string."""
    if T_CFA_PAT not in e:
        return default
    v = _values(e[T_CFA_PAT], endian)
    vals = list(v[0]) if isinstance(v[0], (bytes, bytearray)) else \
        [int(x) for x in v]
    lut = {0: "R", 1: "G", 2: "B"}
    cand = "".join(lut.get(x, "G") for x in vals[-4:])
    return cand if len(cand) == 4 else default


def _apply_ifd0_metadata(out, ifds, raw_ifd, endian):
    """Make/Model -> INSTRUME and ExposureTime -> EXPTIME from IFD0 /
    the raw IFD."""
    ifd0 = ifds[0] if ifds else {}
    make = _values(ifd0[T_MAKE], endian)[0] if T_MAKE in ifd0 else ""
    model = _values(ifd0[T_MODEL], endian)[0] if T_MODEL in ifd0 else ""
    if make or model:
        out.keywords.instrume = f"{make} {model}".strip()
    for src in (raw_ifd, ifd0):
        if T_EXPOSURE in src:
            out.keywords.exposure = float(
                _values(src[T_EXPOSURE], endian)[0])
            break


def read_cr2(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    if not (data[:2] == b"II" and data[8:10] == b"CR"):
        raise ValueError(f"{path}: not a CR2")
    endian = "<"
    ifds = _walk_ifds(data, endian)
    # the raw IFD is the (last) one with an SOF3 strip + slice tag; in
    # practice IFD3.  Identify by compression 6/7 + StripOffsets and the
    # largest strip.
    raw_ifd = None
    best = 0
    for e in ifds:
        if T_STRIP_OFF not in e or T_STRIP_CNT not in e:
            continue
        comp = _values(e[T_COMP], endian)[0] if T_COMP in e else 1
        if comp not in (6, 7):
            continue
        size = sum(_values(e[T_STRIP_CNT], endian))
        if size > best:
            best, raw_ifd = size, e
    if raw_ifd is None:
        raise ValueError(f"{path}: no lossless-JPEG raw IFD found")
    e = raw_ifd
    off = _values(e[T_STRIP_OFF], endian)[0]
    cnt = _values(e[T_STRIP_CNT], endian)[0]
    res = _ljpeg_decode(data[off:off + cnt])
    if res is None:
        raise ValueError(f"{path}: lossless JPEG decode failed")
    arr, ncomp = res                       # (jh, jw*ncomp) u16
    jh, jwn = arr.shape
    flat = arr.reshape(-1)

    slices = None
    if T_CR2_SLICE in e:
        sl = _values(e[T_CR2_SLICE], endian)
        if len(sl) >= 3 and sl[0] > 0:
            slices = [int(sl[1])] * int(sl[0]) + [int(sl[2])]
    height = jh
    width = jwn
    if slices:
        width = sum(slices)
        # sensor rows == jpeg rows; columns re-assemble slice by slice
        img = np.empty((height, width), np.uint16)
        pos = 0
        x0 = 0
        for ws in slices:
            n = ws * height
            img[:, x0:x0 + ws] = flat[pos:pos + n].reshape(height, ws)
            pos += n
            x0 += ws
    else:
        img = arr

    from siril_tpu_torch.io.dng import ljpeg_precision

    bits = ljpeg_precision(data[off:off + cnt])
    if bits not in (10, 12, 14, 16):
        # stream lacks a parseable SOF3 header: fall back to the pixel-
        # range guess (wrong only for underexposed frames)
        bits = 12 if int(img.max()).bit_length() <= 12 else 14
    # Canon pedestal: ~2048 at 14-bit, ~256 at 12-bit (dcraw table);
    # prefer the masked-border estimate when a border exists
    black = 2048.0 if bits == 14 else 256.0
    if img.shape[1] > 96:
        border = img[:, :40].astype(np.float32)
        if border.mean() < black * 2 and border.std() < black:
            black = float(np.median(border))
    white = float((1 << bits) - 1)
    out_arr = np.clip((img.astype(np.float32) - black)
                      / max(white - black, 1.0), 0.0, 1.0)
    out = SirilImage(data=out_arr[None])
    out.keywords.bayer_pattern = "RGGB"    # Canon CFA order
    _apply_ifd0_metadata(out, ifds, e, endian)
    out.log_history("CR2 raw import")
    return out


# ---------------------------------------------------------------------------
# Nikon NEF
# ---------------------------------------------------------------------------


def is_nef(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            data = f.read(512)
    except OSError:
        return False
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        return False
    return b"NIKON" in data.upper()


def _unpack_nikon12(raw: bytes, count: int) -> np.ndarray:
    """Nikon packed 12-bit: LSB-first, 2 px / 3 B
    (p0 = b0 | (b1&0xF)<<8; p1 = b1>>4 | b2<<4)."""
    b = np.frombuffer(raw, np.uint8).astype(np.uint16)
    n3 = (len(b) // 3) * 3
    b = b[:n3].reshape(-1, 3)
    p0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
    p1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    return np.stack([p0, p1], -1).reshape(-1)[:count]


def _unpack_nikon14(raw: bytes, count: int) -> np.ndarray:
    """Nikon packed 14-bit: LSB-first, 4 px / 7 B."""
    b = np.frombuffer(raw, np.uint8).astype(np.uint32)
    n7 = (len(b) // 7) * 7
    b = b[:n7].reshape(-1, 7)
    p0 = b[:, 0] | ((b[:, 1] & 0x3F) << 8)
    p1 = (b[:, 1] >> 6) | (b[:, 2] << 2) | ((b[:, 3] & 0x0F) << 10)
    p2 = (b[:, 3] >> 4) | (b[:, 4] << 4) | ((b[:, 5] & 0x03) << 12)
    p3 = (b[:, 5] >> 2) | (b[:, 6] << 6)
    return np.stack([p0, p1, p2, p3],
                    -1).reshape(-1).astype(np.uint16)[:count]


# Nikon-compressed NEF (compression 34713): Huffman-coded predictor
# deltas + a linearization curve carried in MakerNote tag 0x96.  The
# reference reaches this through libraw (image_formats_libraries.c
# open_raw_files); this is an original implementation of the published
# format.  Fixed Huffman tables (format constants, one per mode): 16
# code-length counts then leaf values, leaf = (shl << 4) | len.

T_EXIF_IFD = 0x8769
T_MAKERNOTE = 0x927C
T_NIKON_LINTABLE = 0x0096

NIKON_TREES = (
    # 12-bit lossy
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12, 0)),
    # 12-bit lossy after split
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12)),
    # 12-bit lossless
    ((0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12)),
    # 14-bit lossy
    ((0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
     (5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14)),
    # 14-bit lossy after split
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0),
     (8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14)),
    # 14-bit lossless
    ((0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0),
     (7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14)),
)


def _nikon_makernote(data: bytes, ifds, endian: str):
    """Locate the Nikon MakerNote and return (embedded_tiff_bytes,
    mn_endian, mn_ifd0) — MakerNote value offsets are relative to the
    embedded TIFF header at byte 10 of the note."""
    for e in ifds:
        if T_EXIF_IFD not in e:
            continue
        off = _values(e[T_EXIF_IFD], endian)[0]
        try:
            exif, _ = _read_ifd(data, off, endian)
        except (struct.error, IndexError):
            continue
        if T_MAKERNOTE not in exif:
            continue
        raw = exif[T_MAKERNOTE][2]
        if raw[:5] != b"Nikon" or len(raw) < 20:
            continue
        sub = raw[10:]
        if sub[:2] not in (b"II", b"MM"):
            continue
        mn_endian = "<" if sub[:2] == b"II" else ">"
        (ifd_off,) = struct.unpack_from(mn_endian + "I", sub, 4)
        try:
            mn_ifd, _ = _read_ifd(sub, ifd_off, mn_endian)
        except (struct.error, IndexError):
            continue
        return sub, mn_endian, mn_ifd
    return None, None, None


def _parse_nikon_lintable(tbl: bytes, mn_endian: str, bits: int):
    """Linearization-table (MakerNote 0x96) → (tree, vpred[4], curve,
    split, white).  Layout: ver0, ver1, [2110-byte gap for 0x49/0x58
    variants], vpred 2×2 u16, curve size u16, curve points; lossy 0x44/
    0x20 tables spread points every `step` and store the tree-switch row
    at byte 562."""
    ver0, ver1 = tbl[0], tbl[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110
    vpred = np.frombuffer(tbl, mn_endian + "u2", 4, pos).copy()
    pos += 8
    (csize,) = struct.unpack_from(mn_endian + "H", tbl, pos)
    pos += 2
    vmax = (1 << bits) & 0x7FFF
    step = vmax // (csize - 1) if csize > 1 else 0
    curve = np.arange(0x8000, dtype=np.uint16)
    split = 0
    if ver0 == 0x44 and ver1 == 0x20 and step > 0:
        pts = np.frombuffer(tbl, mn_endian + "u2", csize,
                            pos).astype(np.uint32)
        pts = np.concatenate([pts, pts[-1:]])
        idx = np.arange(vmax)
        lo, frac = idx // step, idx % step
        curve[:vmax] = ((pts[lo] * (step - frac) + pts[lo + 1] * frac)
                        // step).astype(np.uint16)
        (split,) = struct.unpack_from(mn_endian + "H", tbl, 562)
    elif ver0 != 0x46 and csize <= 0x4001:
        vmax = csize
        curve[:csize] = np.frombuffer(tbl, mn_endian + "u2", csize, pos)
    while vmax > 2 and curve[vmax - 2] == curve[vmax - 1]:
        vmax -= 1
    tree = (2 if ver0 == 0x46 else 0) + (3 if bits == 14 else 0)
    return tree, vpred, curve, int(split), int(curve[vmax - 1])


def _nikon_huff_decoder(tree: int):
    """Canonical-Huffman decode table for one fixed tree:
    (maxcode, mincode, valptr, vals) per code length 1..16."""
    counts, values = NIKON_TREES[tree]
    mincode = [0] * 17
    maxcode = [-1] * 17
    valptr = [0] * 17
    code = k = 0
    for ln in range(1, 17):
        valptr[ln] = k
        mincode[ln] = code
        k += counts[ln - 1]
        code += counts[ln - 1]
        maxcode[ln] = code - 1 if counts[ln - 1] else -1
        code <<= 1
    return mincode, maxcode, valptr, list(values)


def _nikon_decode_py(data: bytes, width: int, height: int, tree: int,
                     vpred: np.ndarray, split: int) -> np.ndarray:
    """The plain Python version of the native decode_nikon (bit-serial —
    fine for tests and small files)."""
    tabs = [_nikon_huff_decoder(tree)]
    if split > 0:
        tabs.append(_nikon_huff_decoder(tree + 1))
    mincode, maxcode, valptr, vals = tabs[0]
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    pos = 0
    nbits = len(bits)

    def getbits(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            b = int(bits[pos]) if pos < nbits else 0
            pos += 1
            v = (v << 1) | b
        return v

    vp = [[int(vpred[0]), int(vpred[1])], [int(vpred[2]), int(vpred[3])]]
    out = np.zeros((height, width), np.uint16)
    for row in range(height):
        if split > 0 and row == split:
            mincode, maxcode, valptr, vals = tabs[1]
        hpred = [0, 0]
        for col in range(width):
            code = 0
            leaf = -1
            for ln in range(1, 17):
                code = (code << 1) | (int(bits[pos]) if pos < nbits else 0)
                pos += 1
                if maxcode[ln] >= 0 and code <= maxcode[ln]:
                    leaf = vals[valptr[ln] + code - mincode[ln]]
                    break
            if leaf < 0:
                raise ValueError("NEF huffman decode failed")
            ln = leaf & 15
            shl = leaf >> 4
            diff = ((getbits(ln - shl) << 1) + 1) << shl >> 1
            if ln > 0 and (diff & (1 << (ln - 1))) == 0:
                diff -= (1 << ln) - (0 if shl else 1)
            if col < 2:
                vp[row & 1][col] = (vp[row & 1][col] + diff) & 0xFFFF
                hpred[col] = vp[row & 1][col]
            else:
                hpred[col & 1] = (hpred[col & 1] + diff) & 0xFFFF
            v = hpred[col & 1]
            out[row, col] = 0 if v >= 0x8000 else min(v, 0x3FFF)
    return out


def _read_nef_compressed(data: bytes, endian: str, ifds, e,
                         width: int, height: int, bits: int):
    """Decode a compression-34713 strip → (u16 image, white level)."""
    sub, mn_endian, mn_ifd = _nikon_makernote(data, ifds, endian)
    if mn_ifd is None or T_NIKON_LINTABLE not in mn_ifd:
        raise ValueError("compressed NEF without a Nikon MakerNote "
                         "linearization table")
    tbl = mn_ifd[T_NIKON_LINTABLE][2]
    tree, vpred, curve, split, white = _parse_nikon_lintable(
        tbl, mn_endian, bits)
    offs = _values(e[T_STRIP_OFF], endian)
    cnts = _values(e[T_STRIP_CNT], endian)
    raw = data[offs[0]: offs[0] + cnts[0]]
    from siril_tpu_torch import native

    img = native.decode_nikon(raw, width, height, tree, vpred, split)
    return curve[img], white


def read_nef(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    endian = "<" if data[:2] == b"II" else ">"
    ifds = _walk_ifds(data, endian)
    e = _find_cfa_ifd(ifds, endian)
    if e is None:
        raise ValueError(f"{path}: no CFA raw IFD found")
    width = _values(e[T_WIDTH], endian)[0]
    height = _values(e[T_LENGTH], endian)[0]
    bits = _values(e[T_BITS], endian)[0] if T_BITS in e else 12
    comp = _values(e[T_COMP], endian)[0] if T_COMP in e else 1
    if comp == 34713:
        img, wl = _read_nef_compressed(data, endian, ifds, e,
                                       width, height, bits)
        white = float(wl)
    elif comp != 1:
        raise ValueError(f"{path}: unsupported NEF compression {comp}")
    else:
        offs = _values(e[T_STRIP_OFF], endian)
        cnts = _values(e[T_STRIP_CNT], endian)
        rps = _values(e[T_ROWS_PER_STRIP], endian)[0] \
            if T_ROWS_PER_STRIP in e else height
        img = np.zeros((height, width), np.uint16)
        y0 = 0
        for i in range(len(offs)):
            th = min(rps, height - y0)
            raw = data[offs[i]: offs[i] + cnts[i]]
            n = th * width
            if bits == 12:
                img[y0:y0 + th] = _unpack_nikon12(raw, n).reshape(th, width)
            elif bits == 14:
                img[y0:y0 + th] = _unpack_nikon14(raw, n).reshape(th, width)
            else:
                img[y0:y0 + th] = np.frombuffer(
                    raw, endian + "u2", count=n).reshape(th, width)
            y0 += th
        white = float((1 << bits) - 1)
    black = 0.0                            # Nikon subtracts black on-camera
    arr = np.clip((img.astype(np.float32) - black)
                  / max(white - black, 1.0), 0.0, 1.0)
    out = SirilImage(data=arr[None])
    out.keywords.bayer_pattern = _decode_cfa_pattern(e, endian)
    _apply_ifd0_metadata(out, ifds, e, endian)
    out.log_history("NEF raw import")
    return out


# ---------------------------------------------------------------------------
# Sony ARW
# ---------------------------------------------------------------------------


def is_arw(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            data = f.read(512)
    except OSError:
        return False
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        return False
    return b"SONY" in data.upper()


def _sony_curve() -> np.ndarray:
    """Sony ARW2 tone curve (dcraw identify(): sony_curve breakpoints
    {0,650,1343,2736,5500} with per-segment slopes 1,2,4,8 over an
    identity base)."""
    bp = [0, 650, 1343, 2736, 5500]
    curve = np.arange(5501, dtype=np.int64)
    for i in range(4):
        lo, hi = bp[i], bp[i + 1]
        curve[lo + 1:hi + 1] = curve[lo] + (1 << i) * np.arange(
            1, hi - lo + 1)
    return curve


def _decode_arw2(data: np.ndarray, height: int, width: int) -> np.ndarray:
    """Sony ARW2 lossy 8-bit/px block compression (dcraw
    sony_arw2_load_raw): each 16-byte block codes 16 same-CFA-color
    pixels across 32 columns — 11-bit max/min + their 4-bit positions +
    fourteen 7-bit deltas, shifted by sh = #{s<4 : 128<<s <= max-min}.
    Blocks alternate even / odd columns of the same 32-column span.
    Output = curve[pix<<1] >> 2."""
    # row stride is `width` bytes (1 B/px); dcraw's span loop runs while
    # col < raw_width-30, i.e. only FULL 32-column spans decode and any
    # tail bytes in the row are ignored (sony_arw2_load_raw)
    spans = width // 32
    if spans == 0:
        raise ValueError(f"ARW2 width {width} too small to decode")
    nb = spans * 2                         # two 16-byte blocks per span
    rows = (data[:height * width].reshape(height, width)[:, :nb * 16]
            .reshape(height, nb, 16).astype(np.uint32))
    val = (rows[..., 0] | (rows[..., 1] << 8) | (rows[..., 2] << 16)
           | (rows[..., 3] << 24))
    vmax = val & 0x7FF
    vmin = (val >> 11) & 0x7FF
    imax = (val >> 22) & 0x0F
    imin = (val >> 26) & 0x0F
    diff = vmax - vmin
    sh = ((diff >= 0x80).astype(np.uint32) + (diff >= 0x100)
          + (diff >= 0x200) + (diff >= 0x400))
    # fifteen 7-bit fields at bit 30+7k (LSB-first within the block);
    # field k spans bytes [b, b+1] with b = (30+7k)>>3 — byte 16 is
    # never needed except for the (degenerate) imax==imin 15th delta,
    # which dcraw reads from its +1 slack byte; pad the same way
    padded = np.concatenate([rows, np.zeros_like(rows[..., :2])], -1)
    deltas = np.empty(rows.shape[:2] + (15,), np.uint32)
    for k in range(15):
        bitpos = 30 + 7 * k
        b, s = bitpos >> 3, bitpos & 7
        two = padded[..., b] | (padded[..., b + 1] << 8)
        deltas[..., k] = (two >> s) & 0x7F
    i = np.arange(16, dtype=np.uint32)
    i_b = i.reshape(1, 1, 16)
    imax_b = imax[..., None]
    imin_b = imin[..., None]
    skip_before = (i_b > imax_b).astype(np.int64) + \
        ((i_b > imin_b) & (imin_b != imax_b))
    didx = np.clip(i_b - skip_before, 0, 14)
    dval = np.take_along_axis(deltas.astype(np.int64), didx, axis=-1)
    pix = np.minimum((dval << sh[..., None]) + vmin[..., None], 0x7FF)
    pix = np.where(i_b == imax_b, vmax[..., None], pix)
    pix = np.where((i_b == imin_b) & (imin_b != imax_b),
                   vmin[..., None], pix)
    curve = _sony_curve()
    raw = (curve[(pix << 1).astype(np.int64)] >> 2).astype(np.uint16)
    # interleave: block 2p -> even columns of span p, 2p+1 -> odd
    raw = raw.reshape(height, spans, 2, 16)
    out = np.empty((height, spans, 32), np.uint16)
    out[..., 0::2] = raw[:, :, 0]
    out[..., 1::2] = raw[:, :, 1]
    out = out.reshape(height, spans * 32)
    if spans * 32 < width:                 # undecoded tail: edge-replicate
        pad = np.repeat(out[:, -1:], width - spans * 32, axis=1)
        out = np.concatenate([out, pad], axis=1)
    return out


def read_arw(path: str) -> SirilImage:
    """Sony ARW import: uncompressed (TIFF comp 1, 12/14/16-bit LE) and
    ARW2 lossy-compressed (comp 32767) sensor data (reference loads
    these through libraw, image_formats_libraries.c open_raw_files)."""
    with open(path, "rb") as f:
        data = f.read()
    endian = "<" if data[:2] == b"II" else ">"
    ifds = _walk_ifds(data, endian)
    e = _find_cfa_ifd(ifds, endian)
    if e is None:
        raise ValueError(f"{path}: no CFA raw IFD found")
    width = _values(e[T_WIDTH], endian)[0]
    height = _values(e[T_LENGTH], endian)[0]
    bits = _values(e[T_BITS], endian)[0] if T_BITS in e else 14
    comp = _values(e[T_COMP], endian)[0] if T_COMP in e else 1
    offs = _values(e[T_STRIP_OFF], endian)
    cnts = _values(e[T_STRIP_CNT], endian)
    blob = b"".join(data[offs[i]: offs[i] + cnts[i]]
                    for i in range(len(offs)))
    if comp == 32767:
        img = _decode_arw2(np.frombuffer(blob, np.uint8), height, width)
        # post-curve scale: curve[0x7ff<<1] >> 2 is the achievable max
        white = float(int(_sony_curve()[0x7FF << 1]) >> 2)
        black = 512.0                      # Sony pedestal (dcraw)
    elif comp == 1:
        img = np.frombuffer(blob, "<u2", count=height * width) \
            .reshape(height, width).astype(np.uint16)
        white = float((1 << bits) - 1)
        black = 512.0 if bits >= 12 else 0.0
    else:
        raise ValueError(f"{path}: unsupported ARW compression {comp} — "
                         "convert to DNG")
    arr = np.clip((img.astype(np.float32) - black)
                  / max(white - black, 1.0), 0.0, 1.0)
    out = SirilImage(data=arr[None])
    out.keywords.bayer_pattern = _decode_cfa_pattern(e, endian)
    _apply_ifd0_metadata(out, ifds, e, endian)
    out.log_history("ARW raw import")
    return out


# ---------------------------------------------------------------------------
# HEIF (gated on a PIL plugin, like the reference gates on libheif)
# ---------------------------------------------------------------------------


def read_heif(path: str) -> SirilImage:
    try:
        from pillow_heif import register_heif_opener

        register_heif_opener()
    except ImportError:
        pass
    from PIL import Image, UnidentifiedImageError

    try:
        im = Image.open(path)
    except UnidentifiedImageError as exc:
        raise ValueError(
            f"{path}: HEIF support needs a PIL HEIF plugin "
            "(pillow-heif), which is not installed") from exc
    arr = np.asarray(im.convert("RGB"))
    from siril_tpu_torch.core.image import ensure_chw

    out = SirilImage(data=ensure_chw(arr.astype(np.float32) / 255.0))
    out.log_history("HEIF import")
    return out


# ---------------------------------------------------------------------------
# Fujifilm RAF
# ---------------------------------------------------------------------------
# Proprietary container (reference reaches it through libraw): 16-byte
# magic, big-endian u32 pointers in the fixed header (0x5C: CFA-record
# table, 0x64: raw data), then a tag table of (tag u16be, len u16be,
# payload) records.  Tag 0x100 = raw height/width; tag 0x131 = the 6×6
# X-Trans CFA grid (36 bytes of 0/1/2 = R/G/B, stored REVERSED).  The
# sensor data of modern bodies is uncompressed 16-bit LE row-major
# (Fuji-compressed RAFs are gated with a clear error).

RAF_MAGIC = b"FUJIFILMCCD-RAW "


def is_raf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(16) == RAF_MAGIC
    except OSError:
        return False


def _parse_raf_table(data: bytes, off: int):
    """CFA-record table → {tag: payload bytes}."""
    (count,) = struct.unpack_from(">I", data, off)
    pos = off + 4
    tags = {}
    for _ in range(min(count, 256)):
        if pos + 4 > len(data):
            break
        tag, ln = struct.unpack_from(">HH", data, pos)
        tags[tag] = data[pos + 4: pos + 4 + ln]
        pos += 4 + ln
    return tags


def read_raf(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    if data[:16] != RAF_MAGIC:
        raise ValueError(f"{path}: not a Fujifilm RAF file")
    try:
        (tbl_off,) = struct.unpack_from(">I", data, 92)
        (raw_off,) = struct.unpack_from(">I", data, 100)
        tags = _parse_raf_table(data, tbl_off)
        if 0x100 not in tags:
            raise ValueError(f"{path}: RAF CFA table lacks the "
                             "raw-size tag")
        height, width = struct.unpack_from(">HH", tags[0x100], 0)
    except struct.error as e:
        raise ValueError(f"{path}: corrupt RAF header ({e})") from e
    n = height * width
    if raw_off + n * 2 > len(data):
        raise ValueError(f"{path}: RAF raw section truncated "
                         "(Fuji-compressed RAF is not supported — "
                         "shoot uncompressed, or convert to DNG)")
    img = np.frombuffer(data, "<u2", count=n,
                        offset=raw_off).reshape(height, width)
    # bit depth is not stored for the uncompressed path.  Default to
    # 14-bit (every current Fuji body) and only widen to 16 when the
    # data proves it: narrowing from the per-frame pixel range would
    # scale a never-saturating DARK/BIAS/FLAT differently from the
    # lights and silently wreck calibration.  12-bit legacy bodies come
    # out 4x dark but CONSISTENTLY so across a session.
    mx = int(img.max()) if n else 0
    bits = 16 if mx > 0x3FFF else 14
    white = float((1 << bits) - 1)
    arr = np.clip(img.astype(np.float32) / white, 0.0, 1.0)
    out = SirilImage(data=arr[None])
    if 0x131 in tags and len(tags[0x131]) >= 36:
        # stored last-cell-first: byte c is grid cell 35−c
        lut = {0: "R", 1: "G", 2: "B"}
        cells = [lut.get(b & 3, "G") for b in tags[0x131][:36]]
        out.keywords.bayer_pattern = "".join(reversed(cells))
    else:
        out.keywords.bayer_pattern = "RGGB"   # Bayer-sensor bodies
    model = data[0x1C:0x3C].split(b"\0")[0].decode("ascii", "replace")
    if model:
        out.keywords.instrume = f"FUJIFILM {model}".strip()
    out.log_history("RAF raw import")
    return out


# ---------------------------------------------------------------------------
# Panasonic RW2
# ---------------------------------------------------------------------------
# TIFF-like container with magic version 0x55 ("IIU\0"); PanasonicRaw
# IFD0 tags (exiftool PanasonicRaw::Main): 0x02/0x03 sensor width/
# height, 0x04-0x07 active-area borders (top/left/bottom/right),
# 0x09 CFA pattern id, 0x0A bits per sample, 0x1C-0x1E per-channel
# black levels (offset by 15), 0x117/0x118 strip bytecount/offset.
# Raw data: uncompressed u16 LE, or the v4 "sliced" 12-bit predictor
# bitstream (dcraw panasonic_load_raw / pana_bits semantics —
# ``native/decoders.cpp`` decode_panasonic; ``_pana_bits_decode_py`` below
# is its plain version).  The
# reference reaches RW2 through libraw (image_formats_libraries.c
# open_raw_files).

_RW2_CFA = {1: "RGGB", 2: "GRBG", 3: "GBRG", 4: "BGGR"}


def is_rw2(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(8)
        return head[:4] == b"II\x55\x00"
    except OSError:
        return False


def _pana_bits_decode_py(data: bytes, width: int, height: int,
                         load_flags: int = 0x2008) -> np.ndarray:
    """The plain scalar Python version of the v4 bitstream decode (exact
    pana_bits semantics; the native decoder is the one the reader
    runs)."""
    # 0x4002: an 8-bit read at a 16 KB block boundary addresses
    # buf[0x3FFF] AND buf[0x4000] (byte = vbits>>3 ^ 0x3FF0 reaches
    # 0x3FFF every block) — the two pad bytes stay zero
    buf = bytearray(0x4002)
    pos = 0
    vbits = 0
    n = len(data)

    def refill():
        nonlocal pos
        for dst0, cnt in ((load_flags, 0x4000 - load_flags),
                          (0, load_flags)):
            take = data[pos:pos + cnt]
            buf[dst0:dst0 + len(take)] = take
            if len(take) < cnt:
                buf[dst0 + len(take):dst0 + cnt] = bytes(cnt - len(take))
            pos += len(take)

    def bits(nbits):
        nonlocal vbits
        if not vbits:
            refill()
        vbits = (vbits - nbits) & 0x1FFFF
        byte = (vbits >> 3) ^ 0x3FF0
        return ((buf[byte] | (buf[byte + 1] << 8)) >> (vbits & 7)) \
            & ((1 << nbits) - 1)

    out = np.empty((height, width), np.uint16)
    pred = [0, 0]
    nonz = [0, 0]
    sh = 0
    for row in range(height):
        orow = out[row]
        for col in range(width):
            i = col % 14
            if i == 0:
                pred[0] = pred[1] = nonz[0] = nonz[1] = 0
            if i % 3 == 2:
                sh = 4 >> (3 - bits(2))
            p = col & 1
            if nonz[p]:
                j = bits(8)
                if j:
                    pred[p] -= 0x80 << sh
                    if pred[p] < 0 or sh == 4:
                        pred[p] &= ~(-1 << sh)
                    pred[p] += j << sh
            else:
                nonz[p] = bits(8)
                if nonz[p] or i > 11:
                    pred[p] = nonz[p] << 4 | bits(4)
            orow[col] = pred[p]
    return out


def _pana_v5_decode(data: bytes, width: int, height: int,
                    bits: int) -> np.ndarray:
    """Panasonic raw v5 (RW2 RawFormat tag 0x2D == 5): the strip is
    0x4000-byte blocks whose two sections are stored SWAPPED (bytes
    [0x1FF8, 0x4000) come first, then [0, 0x1FF8) — same idea as the
    v4 load_flags), and the reordered stream is 16-byte packets each
    holding 10×12-bit or 9×14-bit pixels packed LSB-first
    (rawspeed PanasonicV5Decompressor semantics).  Vectorized: the
    whole reorder is one reshape/concat, the bit extraction one
    gather-free shift table."""
    block = 0x4000
    split = 0x1FF8
    nb = len(data) // block
    main = np.frombuffer(data, np.uint8, count=nb * block)
    mainb = main.reshape(nb, block)
    reordered = np.concatenate([mainb[:, split:], mainb[:, :split]],
                               axis=1).reshape(-1)
    tail = np.frombuffer(data, np.uint8)[nb * block:]
    if tail.size:
        t2 = np.concatenate([tail[split:], tail[:split]]) \
            if tail.size > split else tail
        reordered = np.concatenate([reordered, t2])
    ppp = 10 if bits == 12 else 9
    npkt = len(reordered) // 16
    pk = reordered[:npkt * 16].reshape(npkt, 16).astype(np.uint64)
    # little-endian 128-bit packet → two 64-bit halves
    w0 = np.zeros(npkt, np.uint64)
    w1 = np.zeros(npkt, np.uint64)
    for i in range(8):
        w0 |= pk[:, i] << np.uint64(8 * i)
        w1 |= pk[:, 8 + i] << np.uint64(8 * i)
    out = np.empty((npkt, ppp), np.uint16)
    mask = np.uint64((1 << bits) - 1)
    for p in range(ppp):
        lo = p * bits
        if lo + bits <= 64:
            v = (w0 >> np.uint64(lo)) & mask
        elif lo >= 64:
            v = (w1 >> np.uint64(lo - 64)) & mask
        else:
            v = ((w0 >> np.uint64(lo))
                 | (w1 << np.uint64(64 - lo))) & mask
        out[:, p] = v.astype(np.uint16)
    flat = out.reshape(-1)
    n = width * height
    if flat.size < n:
        raise ValueError("v5 strip smaller than the sensor")
    return flat[:n].reshape(height, width)


def _pana_v6_decode(data: bytes, width: int, height: int) -> np.ndarray:
    """Panasonic raw v6 (RW2 RawFormat tag 0x2D == 6, 14-bit): 16-byte
    pages holding 11 pixels — two full 14-bit values plus three groups
    of (2-bit scale selector + three 10-bit values), laid out from the
    HIGH bytes of the page downward (libraw ``pana_cs6_page_decoder``
    semantics), consumed with the odd/even predictor chain of
    ``panasonicC6_load_raw``.  Vectorized over pages; the 11-pixel
    predictor chain is a static Python loop over page positions."""
    b = np.frombuffer(data, np.uint8)
    npg = len(b) // 16
    pg = b[:npg * 16].reshape(npg, 16).astype(np.uint32)
    # page entries, high-byte-first layout (pana_cs6 read_page)
    ent = [
        (pg[:, 15] << 6) | (pg[:, 14] >> 2),                       # 14b
        (((pg[:, 14] & 0x3) << 12) | (pg[:, 13] << 4)
         | (pg[:, 12] >> 4)) & 0x3FFF,                             # 14b
        (pg[:, 12] >> 2) & 0x3,                                    # 2b
        ((pg[:, 12] & 0x3) << 8) | pg[:, 11],                      # 10b
        ((pg[:, 10] << 2) | (pg[:, 9] >> 6)) & 0x3FF,              # 10b
        ((pg[:, 9] & 0x3F) << 4) | (pg[:, 8] >> 4),                # 10b
        (pg[:, 8] >> 2) & 0x3,                                     # 2b
        ((pg[:, 8] & 0x3) << 8) | pg[:, 7],                        # 10b
        ((pg[:, 6] << 2) | (pg[:, 5] >> 6)) & 0x3FF,               # 10b
        ((pg[:, 5] & 0x3F) << 4) | (pg[:, 4] >> 4),                # 10b
        (pg[:, 4] >> 2) & 0x3,                                     # 2b
        ((pg[:, 4] & 0x3) << 8) | pg[:, 3],                        # 10b
        ((pg[:, 2] << 2) | (pg[:, 1] >> 6)) & 0x3FF,               # 10b
        ((pg[:, 1] & 0x3F) << 4) | (pg[:, 0] >> 4),                # 10b
    ]
    oddeven = [np.zeros(npg, np.uint32), np.zeros(npg, np.uint32)]
    nonzero = [np.zeros(npg, np.uint32), np.zeros(npg, np.uint32)]
    pmul = np.zeros(npg, np.uint32)
    pixel_base = np.zeros(npg, np.uint32)
    out = np.empty((npg, 11), np.uint16)
    ei = 0
    for pix in range(11):
        if pix % 3 == 2:
            base = ent[ei]
            ei += 1
            base = np.where(base == 3, 4, base)
            pixel_base = np.uint32(0x200) << base
            pmul = np.uint32(1) << base
        epixel = ent[ei].copy()
        ei += 1
        p = pix & 1
        had = oddeven[p] != 0
        # had: epixel' = epixel·pmul (+ nonzero − pixel_base when the
        # base window is small); else: full value, 0 repeats last
        scaled = epixel * np.where(pix >= 2, pmul, 1)
        adj = np.where((pixel_base < 0x2000) & (nonzero[p] > pixel_base),
                       nonzero[p] - pixel_base, 0)
        e_had = scaled + np.where(pix >= 2, adj, 0)
        e_not = np.where(epixel != 0, epixel, nonzero[p])
        nonzero[p] = np.where(had, e_had,
                              np.where(epixel != 0, epixel, nonzero[p]))
        oddeven[p] = np.where(had, oddeven[p], epixel)
        value = np.where(had, e_had, e_not)
        spix = (value - np.uint32(0xF)).astype(np.int64)
        out[:, pix] = np.where(
            (spix >= 0) & (spix <= 0xFFFF), spix & 0xFFFF,
            np.where(spix < 0, 0, 0x3FFF)).astype(np.uint16)
    flat = out.reshape(-1)
    n = width * height
    if flat.size < n:
        raise ValueError("v6 strip smaller than the sensor")
    return flat[:n].reshape(height, width)


def read_rw2(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"II\x55\x00":
        raise ValueError(f"{path}: not a Panasonic RW2 file")
    ifds = _walk_ifds(data, "<")
    if not ifds:
        raise ValueError(f"{path}: RW2 header has no IFD")
    e0 = ifds[0]

    def tag(t, default=None):
        if t not in e0:
            return default
        return _values(e0[t], "<")

    sw = tag(0x0002)
    sh_ = tag(0x0003)
    if not sw or not sh_:
        raise ValueError(f"{path}: RW2 lacks sensor dimensions")
    width, height = int(sw[0]), int(sh_[0])
    bits = int((tag(0x000A) or [12])[0])
    raw_fmt = int((tag(0x002D) or [0])[0])         # RawFormat: 5/6/7 = v5/v6/v7
    off_v = tag(0x0118) or tag(T_STRIP_OFF)
    cnt_v = tag(0x0117) or tag(T_STRIP_CNT)
    if not off_v:
        raise ValueError(f"{path}: RW2 lacks a raw-data offset")
    off = int(off_v[0])
    cnt = int(cnt_v[0]) if cnt_v else len(data) - off
    raw_bytes = data[off:off + cnt] if cnt else data[off:]

    if raw_fmt >= 7:
        raise ValueError(
            f"{path}: Panasonic raw v{raw_fmt} is not supported "
            "natively — convert to DNG; uncompressed, v4, v5 and v6 "
            "RW2 decode directly")
    if raw_fmt == 5:
        img = _pana_v5_decode(raw_bytes, width, height, bits)
        if _cfa_roughness(img) > 0.2:
            raise ValueError(
                f"{path}: v5 bitstream decodes implausibly (layout "
                "mismatch for this body) — convert to DNG")
    elif raw_fmt == 6:
        img = _pana_v6_decode(raw_bytes, width, height)
        if _cfa_roughness(img) > 0.2:
            raise ValueError(
                f"{path}: v6 bitstream decodes implausibly (layout "
                "mismatch for this body) — convert to DNG")
    elif cnt >= width * height * 2:
        img = np.frombuffer(raw_bytes, "<u2",
                            count=width * height).reshape(height, width)
    else:
        from siril_tpu_torch import native

        img = native.decode_panasonic(raw_bytes, width, height)

    # active-area crop (borders in sensor pixels)
    top = int((tag(0x0004) or [0])[0])
    left = int((tag(0x0005) or [0])[0])
    bottom = int((tag(0x0006) or [height])[0])
    right = int((tag(0x0007) or [width])[0])
    if 0 <= top < bottom <= height and 0 <= left < right <= width:
        img = img[top:bottom, left:right]

    # black level: RW2 stores per-channel levels offset by 15
    blacks = []
    for t in (0x001C, 0x001D, 0x001E):
        v = tag(t)
        if v:
            blacks.append(int(v[0]) + 15)
    black = float(np.mean(blacks)) if blacks else 0.0
    white = float((1 << bits) - 1)
    arr = np.clip((img.astype(np.float32) - black)
                  / max(white - black, 1.0), 0.0, 1.0)
    out = SirilImage(data=arr[None])
    out.keywords.bayer_pattern = _RW2_CFA.get(
        int((tag(0x0009) or [1])[0]), "RGGB")
    model = tag(T_MODEL)
    if model and isinstance(model[0], str) and model[0].strip():
        out.keywords.instrume = model[0].strip("\x00 ")
    out.log_history("RW2 raw import")
    return out


# ---------------------------------------------------------------------------
# Canon CR3 (gated)
# ---------------------------------------------------------------------------


def read_cr3(path: str) -> SirilImage:
    """CR3 is an ISO-BMFF container with Canon's crx wavelet codec —
    not implemented (the reference needs libraw ≥0.20 for it too,
    image_formats_libraries.c).  Gate with a clear, actionable error
    like the reference gates missing libheif."""
    raise ValueError(
        f"{path}: Canon CR3 (crx codec) is not supported natively — "
        "convert to DNG (Adobe DNG Converter) or shoot CR2/raw-DNG; "
        "CR2, NEF, ARW, RAF, RW2 and DNG decode natively")


# ---------------------------------------------------------------------------
# Pentax PEF / Olympus ORF (uncompressed paths; compressed gated)
# ---------------------------------------------------------------------------
# Both are TIFF-family CFA containers (the reference reads them through
# libraw, image_formats_libraries.c open_raw_files).  PEF is standard
# TIFF ("II*\0"/"MM\0*"); ORF replaces the TIFF version word with "RO"
# ("IIRO") or "RS" but keeps the IFD layout.  Uncompressed 16-bit and
# 12-bit-packed sensor strips decode here; the vendor-specific
# compressors (Pentax huffman 65535, Olympus 0x Olympus-packed
# compression) are gated with clear errors.


def is_pef(path: str) -> bool:
    if not path.lower().endswith(".pef"):
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(4)
        return head in (b"II*\x00", b"MM\x00*")
    except OSError:
        return False


def is_orf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(4)
        return head in (b"IIRO", b"IIRS", b"MMOR")
    except OSError:
        return False


def _unpack12_le(raw: bytes, count: int) -> np.ndarray:
    """Little-endian 12-bit packing (2 values / 3 bytes): v0 = b0 |
    (b1 & 0xF) << 8; v1 = b1 >> 4 | b2 << 4."""
    b = np.frombuffer(raw, np.uint8)
    ntrip = len(b) // 3
    b = b[:ntrip * 3].reshape(ntrip, 3).astype(np.uint16)
    v0 = b[:, 0] | ((b[:, 1] & 0xF) << 8)
    v1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    out = np.empty(ntrip * 2, np.uint16)
    out[0::2] = v0
    out[1::2] = v1
    return out[:count]


def _unpack12_msb(raw: bytes, count: int) -> np.ndarray:
    """MSB-first 12-bit packing (dcraw packed_load_raw order for
    big-endian TIFF bodies, e.g. Pentax "MM" PEF): v0 = b0 << 4 |
    b1 >> 4; v1 = (b1 & 0xF) << 8 | b2."""
    b = np.frombuffer(raw, np.uint8)
    ntrip = len(b) // 3
    b = b[:ntrip * 3].reshape(ntrip, 3).astype(np.uint16)
    v0 = (b[:, 0] << 4) | (b[:, 1] >> 4)
    v1 = ((b[:, 1] & 0xF) << 8) | b[:, 2]
    out = np.empty(ntrip * 2, np.uint16)
    out[0::2] = v0
    out[1::2] = v1
    return out[:count]


def _cfa_roughness(img: np.ndarray) -> float:
    """Plausibility score for a decoded CFA mosaic: median |Δ| between
    same-CFA-column neighbors, relative to the p99 level.  A correctly
    unpacked natural image scores a few percent; a wrong bit-packing
    decodes to quasi-random values scoring ~0.3 (ADVICE r4: the packing
    order was only validated against the suite's own writer, so a real
    camera file hitting the wrong branch must fail loudly, not decode
    to garbage)."""
    s = img[:: max(img.shape[0] // 64, 1)].astype(np.int32)
    d = np.abs(s[:, 2:] - s[:, :-2])
    level = float(np.percentile(s, 99))
    return float(np.median(d)) / max(level, 1.0)


def _cfa_step(img: np.ndarray) -> float:
    """The packing orders' comparison: the larger, over the two column
    parities, of the median |Δ| in ADU between same-CFA-column neighbours
    (the rows of ``_cfa_roughness``).  A wrong order scrambles the low
    bits of one value of each pair and keeps the other smooth, so one
    parity's steps jump while the median over both can stay small."""
    s = img[:: max(img.shape[0] // 64, 1)].astype(np.int32)
    return max(float(np.median(np.abs(s[:, p + 2::2] - s[:, p:-2:2])))
               for p in (0, 1))


def _read_tiff_cfa_strips(path: str, data: bytes, endian: str,
                          vendor: str) -> SirilImage:
    ifds = _walk_ifds(data, endian)
    e = _find_cfa_ifd(ifds, endian)
    if e is None:
        # some bodies omit PhotometricInterpretation on the raw IFD —
        # fall back to the largest strip-bearing IFD
        best = 0
        for cand in ifds:
            if T_STRIP_OFF in cand and T_WIDTH in cand \
                    and T_LENGTH in cand:
                a = _values(cand[T_WIDTH], endian)[0] * \
                    _values(cand[T_LENGTH], endian)[0]
                if a > best:
                    best, e = a, cand
        if e is None:
            raise ValueError(f"{path}: no raw IFD found")
    width = int(_values(e[T_WIDTH], endian)[0])
    height = int(_values(e[T_LENGTH], endian)[0])
    bits = int(_values(e[T_BITS], endian)[0]) if T_BITS in e else 16
    comp = int(_values(e[T_COMP], endian)[0]) if T_COMP in e else 1
    if comp != 1:
        raise ValueError(
            f"{path}: {vendor} compression {comp} is not supported "
            "natively — convert to DNG; uncompressed "
            f"{vendor} decodes directly")
    offs = _values(e[T_STRIP_OFF], endian)
    cnts = _values(e[T_STRIP_CNT], endian) if T_STRIP_CNT in e \
        else [len(data) - offs[0]]
    raw = b"".join(data[o:o + c] for o, c in zip(offs, cnts))
    n = width * height
    if len(raw) >= n * 2:
        img = np.frombuffer(raw, endian + "u2", count=n).reshape(
            height, width)
    elif len(raw) * 2 >= n * 3 and bits == 12:
        # packing order follows the container's byte order (dcraw
        # packed_load_raw: big-endian bodies pack MSB-first), but real
        # bodies vary — decode BOTH orders, keep the smoother CFA
        # (the wrong order scrambles mid-bits: measured 2-5× rougher on
        # natural scenes), and gate when even the smoother decode looks
        # like noise (a vendor-compressed bitstream mislabeled comp=1)
        first, second = (_unpack12_msb, _unpack12_le) \
            if endian == ">" else (_unpack12_le, _unpack12_msb)
        img_a = first(raw, n).reshape(height, width)
        img_b = second(raw, n).reshape(height, width)
        ra = _cfa_roughness(img_a)
        rb = _cfa_roughness(img_b)
        # prefer the container-implied order unless the other is
        # clearly smoother, by the steps of its rougher column parity in
        # ADU (``_cfa_step``): on a dark frame the wrong order's level
        # rises more than its median step, and the relative score alone
        # picks it (a departure from the JAX package, ROADMAP §3)
        sa, sb = _cfa_step(img_a), _cfa_step(img_b)
        img, r_best = (img_a, ra) if sa <= sb * 1.25 else (img_b, rb)
        if r_best > 0.2:
            raise ValueError(
                f"{path}: 12-bit {vendor} strip decodes implausibly in "
                f"both packing orders (roughness {ra:.2f}/{rb:.2f}) — "
                "likely a vendor-compressed variant; convert to DNG")
    else:
        raise ValueError(
            f"{path}: {vendor} raw strips are smaller than the sensor "
            "area — vendor compression is not supported, convert to DNG")
    white = float((1 << bits) - 1)
    arr = np.clip(img.astype(np.float32) / white, 0.0, 1.0)
    out = SirilImage(data=arr[None])
    out.keywords.bayer_pattern = _decode_cfa_pattern(e, endian)
    _apply_ifd0_metadata(out, ifds, e, endian)
    out.log_history(f"{vendor} raw import")
    return out


def read_pef(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    endian = "<" if data[:2] == b"II" else ">"
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError(f"{path}: not a TIFF/PEF file")
    return _read_tiff_cfa_strips(path, data, endian, "PEF")


def read_orf(path: str) -> SirilImage:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] not in (b"IIRO", b"IIRS", b"MMOR"):
        raise ValueError(f"{path}: not an Olympus ORF file")
    endian = "<" if data[:2] == b"II" else ">"
    return _read_tiff_cfa_strips(path, data, endian, "ORF")
