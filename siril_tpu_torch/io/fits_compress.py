"""FITS tiled image compression — counterpart of
``siril_tpu/io/fits_compress.py`` (the RICE_1 coder :89-175, the tile
codecs :183-215, ``build_compressed_hdu``:218, ``read_compressed_hdu``
:311), behind ``setcompress`` and ``.fit.fz`` files.

The FITS Tiled Image Compression convention: a BINTABLE with ZIMAGE = T,
one image row per tile and table row, the compressed bytes in the heap.
Codecs: RICE_1 (BLOCKSIZE 32, BYTEPIX 2 or 4), GZIP_1 (zlib of the
big-endian tile), GZIP_2 (zlib of the byte-shuffled tile).  RICE_1 at
BYTEPIX 2 — every 16-bit image — runs through the host C++ coder
(``siril_tpu_torch/native``, OpenMP over tiles); the Python coder below
is its plain version and serves BYTEPIX 4.  Float images are always
written GZIP_1 (lossless).  Host code.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import numpy as np

BLOCK = 32


# ---------------------------------------------------------------------------
# Rice codec (RICE_1)
# ---------------------------------------------------------------------------

_FS_PARAMS = {1: (3, 6), 2: (4, 14), 4: (5, 25)}   # bytepix → (fsbits, fsmax)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_zeros_then_one(self, nzeros: int):
        while nzeros >= 31:
            self.write(0, 31)
            nzeros -= 31
        self.write(1, nzeros + 1)

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def read(self, nbits: int) -> int:
        while self.nbits < nbits:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8
        self.nbits -= nbits
        v = (self.acc >> self.nbits) & ((1 << nbits) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def read_unary(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n


def rice_encode(pixels: np.ndarray, bytepix: int = 2) -> bytes:
    """RICE_1 tile encoder (cfitsio rcomp-compatible bitstream layout:
    first pixel raw, then per-32-pixel blocks of zigzag differences coded
    with a per-block split level fs in fsbits bits, fs+1 stored; 0 = all
    zero, fsmax+1 = uncoded)."""
    fsbits, fsmax = _FS_PARAMS[bytepix]
    bbits = bytepix * 8
    a = pixels.astype(np.int64).ravel()
    w = _BitWriter()
    if a.size == 0:
        return b""
    w.write(int(a[0]) & ((1 << bbits) - 1), bbits)
    # first differences wrapped to signed bbits (modular arithmetic keeps
    # the zigzag code within bbits bits, as in the convention's reference
    # coder), then zigzag-mapped to unsigned
    half = 1 << (bbits - 1)
    full = 1 << bbits
    d = (np.diff(a) + half) % full - half
    u = np.where(d < 0, ~(d << 1), d << 1).astype(np.uint64)
    for start in range(0, u.size, BLOCK):
        blk = u[start:start + BLOCK]
        s = int(blk.sum())
        n = blk.size
        if s == 0:
            w.write(0, fsbits)
            continue
        dpsum = (s - (n // 2) - 1) / n
        psum = int(dpsum) >> 1 if dpsum > 0 else 0
        fs = 0
        while psum > 0:
            psum >>= 1
            fs += 1
        if fs >= fsmax:
            w.write(fsmax + 1, fsbits)
            for v in blk:
                w.write(int(v), bbits)
        else:
            w.write(fs + 1, fsbits)
            for v in blk:
                v = int(v)
                w.write_zeros_then_one(v >> fs)
                if fs:
                    w.write(v, fs)
    return w.flush()


def rice_decode(data: bytes, npix: int, bytepix: int = 2) -> np.ndarray:
    fsbits, fsmax = _FS_PARAMS[bytepix]
    bbits = bytepix * 8
    r = _BitReader(data)
    out = np.empty(npix, np.int64)
    if npix == 0:
        return out
    first = r.read(bbits)
    # sign-extend the raw first value
    if first >= (1 << (bbits - 1)):
        first -= (1 << bbits)
    out[0] = first
    i = 1
    while i < npix:
        n = min(BLOCK, npix - i)
        code = r.read(fsbits)
        if code == 0:
            u = np.zeros(n, np.int64)
        elif code == fsmax + 1:
            u = np.array([r.read(bbits) for _ in range(n)], np.int64)
        else:
            fs = code - 1
            u = np.empty(n, np.int64)
            for j in range(n):
                top = r.read_unary()
                u[j] = (top << fs) | (r.read(fs) if fs else 0)
        # un-zigzag
        d = np.where(u & 1, ~(u >> 1), u >> 1)
        out[i:i + n] = d
        i += n
    np.cumsum(out, out=out)
    # wrap the running sum back to signed bbits (mod-2^bbits arithmetic)
    half = 1 << (bbits - 1)
    full = 1 << bbits
    return (out + half) % full - half


# ---------------------------------------------------------------------------
# tile codecs
# ---------------------------------------------------------------------------


def _shuffle(b: bytes, item: int) -> bytes:
    a = np.frombuffer(b, np.uint8)
    return a.reshape(-1, item).T.tobytes()


def _unshuffle(b: bytes, item: int) -> bytes:
    a = np.frombuffer(b, np.uint8)
    return a.reshape(item, -1).T.tobytes()


def compress_tile(tile: np.ndarray, cmptype: str, bytepix: int) -> bytes:
    if cmptype == "RICE_1":
        return rice_encode(tile, bytepix)
    raw = tile.astype(f">i{bytepix}" if tile.dtype.kind in "iu"
                      else ">f4").tobytes()
    if cmptype == "GZIP_1":
        return zlib.compress(raw, 6)
    if cmptype == "GZIP_2":
        return zlib.compress(_shuffle(raw, bytepix), 6)
    raise ValueError(f"unsupported compression: {cmptype}")


def decompress_tile(data: bytes, cmptype: str, npix: int, bytepix: int,
                    float_data: bool) -> np.ndarray:
    if cmptype == "RICE_1":
        return rice_decode(data, npix, bytepix)
    raw = zlib.decompress(data)
    if cmptype == "GZIP_2":
        raw = _unshuffle(raw, bytepix)
    elif cmptype != "GZIP_1":
        raise ValueError(f"unsupported compression: {cmptype}")
    if float_data:
        return np.frombuffer(raw, ">f4").astype(np.float64)[:npix]
    return np.frombuffer(raw, f">i{bytepix}").astype(np.int64)[:npix]


# ---------------------------------------------------------------------------
# tiled-FITS container
# ---------------------------------------------------------------------------

CMPTYPES = {"rice": "RICE_1", "gzip1": "GZIP_1", "gzip2": "GZIP_2",
            "gzip": "GZIP_1"}


def build_compressed_hdu(data_chw: np.ndarray, bitpix: int,
                         cmptype: str = "RICE_1",
                         extra_cards: Optional[List] = None) -> bytes:
    """[C, H, W] image rows (as they go to the file) → one ZIMAGE
    BINTABLE extension (header, table and heap, padded to 2880).
    ``bitpix`` 16 (int16 + ZZERO 32768) or -32 (float32, always
    GZIP_1)."""
    from siril_tpu_torch.io.fits_io import _format_card

    c, h, w = data_chw.shape
    if bitpix == 16:
        scaled = np.clip(np.round(data_chw * 65535.0), 0, 65535)
        planes = (scaled - 32768.0).astype(np.int64)
        bytepix = 2
        bzero = 32768.0
    elif bitpix == -32:
        planes = data_chw.astype(np.float32)
        bytepix = 4
        bzero = 0.0
        if cmptype == "RICE_1":
            cmptype = "GZIP_1"
    else:
        raise ValueError("compressed write supports bitpix 16 or -32")

    ntiles = c * h
    desc = np.zeros((ntiles, 2), ">i4")
    if cmptype == "RICE_1" and bytepix == 2:
        from siril_tpu_torch import native

        heap, offs, lens = native.rice_encode_tiles_i16(
            planes.reshape(ntiles, w).astype(np.int16))
        desc[:, 0] = lens
        desc[:, 1] = offs
    else:
        tiles = [compress_tile(planes[ch, row], cmptype, bytepix)
                 for ch in range(c) for row in range(h)]
        heap = b"".join(tiles)
        off = 0
        for k, t in enumerate(tiles):
            desc[k] = (len(t), off)
            off += len(t)

    cards = [
        ("XTENSION", "BINTABLE", "binary table extension"),
        ("BITPIX", 8, ""),
        ("NAXIS", 2, ""),
        ("NAXIS1", 8, "descriptor bytes per row"),
        ("NAXIS2", ntiles, "one row per tile"),
        ("PCOUNT", len(heap), "heap size"),
        ("GCOUNT", 1, ""),
        ("TFIELDS", 1, ""),
        ("TTYPE1", "COMPRESSED_DATA", ""),
        ("TFORM1", f"1PB({int(desc[:, 0].max()) if ntiles else 0})", ""),
        ("ZIMAGE", True, "tiled image compression"),
        ("ZCMPTYPE", cmptype, ""),
        ("ZBITPIX", bitpix, ""),
        ("ZNAXIS", 3 if c > 1 else 2, ""),
        ("ZNAXIS1", w, ""),
        ("ZNAXIS2", h, ""),
    ]
    if c > 1:
        cards.append(("ZNAXIS3", c, ""))
    cards += [("ZTILE1", w, "row tiles"), ("ZTILE2", 1, "")]
    if c > 1:
        cards.append(("ZTILE3", 1, ""))
    if cmptype == "RICE_1":
        cards += [("ZNAME1", "BLOCKSIZE", ""), ("ZVAL1", BLOCK, ""),
                  ("ZNAME2", "BYTEPIX", ""), ("ZVAL2", bytepix, "")]
    if bitpix == 16:
        cards += [("ZZERO", bzero, ""), ("ZSCALE", 1.0, "")]
    cards.extend(extra_cards or [])
    cards.append(("END", None, ""))

    hdr = "".join(_format_card(k, v, cm) for k, v, cm in cards)
    hdr += " " * ((2880 - len(hdr) % 2880) % 2880)
    table = desc.tobytes() + heap
    table += b"\0" * ((2880 - len(table) % 2880) % 2880)
    return hdr.encode("ascii") + table


def read_compressed_hdu(buf: bytes, hdr) -> Tuple[np.ndarray, int]:
    """A ZIMAGE BINTABLE's table and heap bytes ``buf`` (its header
    ``hdr`` parsed) → ([C, H, W] float32 in [0, 1], rows as stored,
    zbitpix)."""
    cmptype = str(hdr.get("ZCMPTYPE", "RICE_1")).strip()
    zbitpix = int(hdr.get("ZBITPIX", 16))
    w = int(hdr.get("ZNAXIS1"))
    h = int(hdr.get("ZNAXIS2"))
    c = int(hdr.get("ZNAXIS3", 1))
    ntiles = int(hdr.get("NAXIS2"))
    bytepix = int(hdr.get("ZVAL2", 2 if zbitpix == 16 else 4))
    bzero = float(hdr.get("ZZERO", 0.0))
    bscale = float(hdr.get("ZSCALE", 1.0))
    if int(hdr.get("ZTILE1", w)) != w or int(hdr.get("ZTILE2", 1)) != 1:
        raise ValueError("only row-tiled ZIMAGEs are supported")
    desc = np.frombuffer(buf[:ntiles * 8], ">i4").reshape(ntiles, 2)
    heap_start = ntiles * 8
    out = np.empty((c, h, w), np.float64)
    is_float = zbitpix < 0
    if cmptype == "RICE_1" and bytepix == 2 and not is_float:
        from siril_tpu_torch import native

        dec = native.rice_decode_tiles_i16(
            buf[heap_start:], desc[:, 1].astype(np.int64),
            desc[:, 0].astype(np.int64), w)
        out[:] = dec.reshape(c, h, w).astype(np.float64) * bscale + bzero
        out /= 65535.0
        return np.clip(out, 0.0, 1.0).astype(np.float32), zbitpix
    for k in range(ntiles):
        ln, off = int(desc[k, 0]), int(desc[k, 1])
        raw = buf[heap_start + off:heap_start + off + ln]
        vals = decompress_tile(raw, cmptype, w, bytepix, is_float)
        ch, row = divmod(k, h)
        out[ch, row] = vals * bscale + bzero
    if not is_float:
        out /= 65535.0
    return np.clip(out, 0.0, 1.0).astype(np.float32), zbitpix
