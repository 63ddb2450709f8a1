"""Pure-numpy FITS reader/writer — counterpart of
``siril_tpu/io/fits_io.py`` (``_raw_to_float01``:274, ``_read_zimage``
:402, read_fits:432, write_fits:474, ``FitseqWriter``:612).

Reads image HDUs of BITPIX 8, 16 (u16 through BZERO 32768), 32, -32 and
-64, the image extensions of a FITS cube (``hdu_index``), and tiled
compressed (ZIMAGE, ``.fit.fz``) extensions (``io/fits_compress.py``).
Writes BITPIX 8, 16 and -32 (a -64 image is written as -32), optionally
tile-compressed (``setcompress``).  A celestial WCS in a header becomes
the image's ``wcs`` (``ops/wcs.WCS.from_header``) and its cards leave
``Keywords.extra``; ``write_fits`` writes ``wcs.to_cards()`` after the
keywords, in plain and compressed files alike (the JAX package keeps
the read cards in ``extra`` too and writes them twice).  FITS rows are stored bottom-up unless
ROWORDER='TOP-DOWN'; the in-memory convention is top-down (row 0 = top).
An image's ICC profile travels as an 8-bit IMAGE extension EXTNAME =
'ICCProfile' after a plain image (``_icc_extension_bytes``:578,
``read_icc_extension``:596, ``_icc_from_hdus``:601); a compressed file
carries none, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from siril_tpu_torch.core.image import (
    BYTE_IMG,
    DOUBLE_IMG,
    FLOAT_IMG,
    INV_USHRT_MAX_SINGLE,
    SHORT_IMG,
    USHORT_IMG,
    Keywords,
    SirilImage,
)

BLOCK = 2880
CARD = 80

_DTYPES = {8: np.dtype(">u1"), 16: np.dtype(">i2"), 32: np.dtype(">i4"),
           -32: np.dtype(">f4"), -64: np.dtype(">f8")}


def _parse_value(raw: str):
    v = raw.strip()
    if not v:
        return None
    if v.startswith("'"):
        out = []
        i = 1
        while i < len(v):
            if v[i] == "'":
                if i + 1 < len(v) and v[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(v[i])
            i += 1
        return "".join(out).rstrip()
    if v == "T":
        return True
    if v == "F":
        return False
    try:
        if any(c in v for c in ".EeDd") and not v.lstrip("+-").isdigit():
            return float(v.replace("D", "E").replace("d", "e"))
        return int(v)
    except ValueError:
        return v


@dataclass
class Header:
    """Ordered FITS header: list of (key, value, comment) cards."""

    cards: List[Tuple[str, object, str]]

    def get(self, key: str, default=None):
        for k, v, _ in self.cards:
            if k == key:
                return v
        return default

    def history(self) -> List[str]:
        return [str(v) for k, v, _ in self.cards if k == "HISTORY"]

    def row_order(self) -> str:
        return str(self.get("ROWORDER", "BOTTOM-UP") or "BOTTOM-UP").upper()

    def text(self) -> str:
        """The cards as lines (``dumpheader``)."""
        return "\n".join(_format_card(k, v, c).rstrip()
                         for k, v, c in self.cards)


def _parse_header_block(buf: bytes) -> Tuple[Header, bool]:
    cards = []
    ended = False
    for off in range(0, len(buf), CARD):
        card = buf[off:off + CARD].decode("ascii", errors="replace")
        key = card[:8].strip()
        if key == "END":
            ended = True
            break
        if key in ("COMMENT", "HISTORY") or (key == "" and card.strip()):
            cards.append((key, card[8:].rstrip(), ""))
            continue
        if card[8:10] == "= ":
            rest = card[10:]
            in_q = False
            com = ""
            val = rest
            for i, ch in enumerate(rest):
                if ch == "'":
                    in_q = not in_q
                elif ch == "/" and not in_q:
                    val = rest[:i]
                    com = rest[i + 1:].strip()
                    break
            cards.append((key, _parse_value(val), com))
        elif key:
            cards.append((key, card[8:].rstrip(), ""))
    return Header(cards), ended


def _format_card(key: str, value, comment: str = "") -> str:
    if key in ("COMMENT", "HISTORY", ""):
        return f"{key:<8}{str(value):<72}"[:CARD].ljust(CARD)
    if value is None:
        return f"{key:<8}".ljust(CARD)
    if isinstance(value, bool):
        body = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        fv = float(value)
        sval = f"{fv:.1f}" if fv == int(fv) and abs(fv) < 1e15 \
            else f"{fv:.15G}"
        body = f"{key:<8}= {sval:>20}"
    else:
        s = str(value).replace("'", "''")
        if len(s) > 68:
            s = s[:68]
            if (len(s) - len(s.rstrip("'"))) % 2 == 1:
                s = s[:-1]
        sval = f"'{s:<8}'" if len(s) < 8 else f"'{s}'"
        body = f"{key:<8}= {sval:<20}"
    if comment:
        body = f"{body} / {comment}"
    return body[:CARD].ljust(CARD)


def _read_header(f) -> Optional[Header]:
    buf = b""
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            return None
        buf += block
        hdr, ended = _parse_header_block(buf)
        if ended:
            return hdr


@dataclass
class HDUInfo:
    header: Header
    data_offset: int
    bitpix: int
    naxes: Tuple[int, ...]       # FITS order (naxis1, naxis2, naxis3)
    data_nbytes: int
    bzero: float
    bscale: float

    @property
    def shape_chw(self) -> Tuple[int, int, int]:
        na = self.naxes
        if len(na) == 2:
            return (1, na[1], na[0])
        return (na[2], na[1], na[0])


def scan_hdus(path: Union[str, os.PathLike]) -> List[HDUInfo]:
    """Parse every HDU header (no pixel read)."""
    hdus = []
    with open(path, "rb") as f:
        while True:
            hdr = _read_header(f)
            if hdr is None:
                break
            bitpix = int(hdr.get("BITPIX", 0) or 0)
            naxis = int(hdr.get("NAXIS", 0) or 0)
            naxes = tuple(int(hdr.get(f"NAXIS{i + 1}", 0) or 0)
                          for i in range(naxis))
            nel = 1
            for n in naxes:
                nel *= n
            nbytes = nel * abs(bitpix) // 8 if naxis > 0 else 0
            nbytes += int(hdr.get("PCOUNT", 0) or 0) * abs(bitpix) // 8
            off = f.tell()
            hdus.append(HDUInfo(
                header=hdr, data_offset=off, bitpix=bitpix, naxes=naxes,
                data_nbytes=nbytes, bzero=float(hdr.get("BZERO", 0.0) or 0.0),
                bscale=float(hdr.get("BSCALE", 1.0) or 1.0)))
            f.seek(off + (nbytes + BLOCK - 1) // BLOCK * BLOCK)
    return hdus


def _is_zimage(h: HDUInfo) -> bool:
    return bool(h.header.get("ZIMAGE"))


def image_hdus(path: Union[str, os.PathLike]) -> List[HDUInfo]:
    """The plain image HDUs (a FITS cube's frames), not the compressed
    ones."""
    return _plain_images(path, scan_hdus(path))


def _plain_images(path, every: List[HDUInfo]) -> List[HDUInfo]:
    hdus = [h for h in every
            if len(h.naxes) >= 2 and all(n > 0 for n in h.naxes)
            and not _is_zimage(h)]
    for h in hdus:
        if h.bitpix not in _DTYPES:
            raise ValueError(f"{path}: unsupported BITPIX {h.bitpix}")
    return hdus


def zimage_hdus(path: Union[str, os.PathLike]) -> List[HDUInfo]:
    """The tile-compressed image extensions (ZIMAGE = T)."""
    return [h for h in scan_hdus(path) if _is_zimage(h)]


def _raw_to_float01(raw: np.ndarray, bitpix: int, bzero: float,
                    bscale: float) -> np.ndarray:
    """Physical value → Siril [0, 1] float32 (readfits rules): u8 /255,
    u16 /65535, u32 /(2³²−1) through float64, floats as they are.  A
    signed SHORT (BZERO 0) is shifted by 32768."""
    if bitpix in (8, 16):
        if bitpix == 16 and bzero == 0.0 and bscale == 1.0:
            bzero = 32768.0
        # (x·bscale + bzero)·(1/max) in float32, in place (x·1 is x)
        phys = raw.astype(np.float32)
        if bscale != 1.0:
            phys *= np.float32(bscale)
        phys += np.float32(bzero)
        phys *= np.float32(1.0 / 255.0 if bitpix == 8
                           else INV_USHRT_MAX_SINGLE)
        return phys
    if bitpix == 32:
        phys = raw.astype(np.float64) * bscale + bzero
        return (phys / 4294967295.0).astype(np.float32)
    if bitpix in (-32, -64):
        phys = raw.astype(np.float32)
        if bscale != 1.0 or bzero != 0.0:
            phys = phys * np.float32(bscale) + np.float32(bzero)
        return phys
    raise ValueError(f"unsupported BITPIX {bitpix}")


_KEYMAP = {
    "PROGRAM": "program",
    "FILENAME": "filename",
    "XPIXSZ": "pixel_size_x",
    "ROWORDER": "row_order",
    "DATE": "date",
    "DATE-OBS": "date_obs",
    "FILTER": "filter",
    "IMAGETYP": "image_type",
    "OBJECT": "object",
    "INSTRUME": "instrume",
    "TELESCOP": "telescop",
    "OBSERVER": "observer",
    "BAYERPAT": "bayer_pattern",
    "XBAYROFF": "bayer_xoffset",
    "YBAYROFF": "bayer_yoffset",
    "FOCALLEN": "focal_length",
    "EXPTIME": "exposure",
    "LIVETIME": "livetime",
    "STACKCNT": "stackcnt",
    "GAIN": "gain",
    "OFFSET": "offset",
    "CCD-TEMP": "ccd_temp",
}

_STRUCTURAL = {
    "SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "NAXIS3", "EXTEND",
    "BZERO", "BSCALE", "PCOUNT", "GCOUNT", "XTENSION", "END", "COMMENT",
    "HISTORY", "CHECKSUM", "DATASUM",
}


def header_to_keywords(hdr: Header) -> Keywords:
    kw = Keywords()
    known = set()
    for key, attr in _KEYMAP.items():
        v = hdr.get(key)
        if v is None:
            continue
        cur = getattr(kw, attr)
        try:
            if isinstance(cur, int) and not isinstance(cur, bool):
                setattr(kw, attr, int(v))
            elif isinstance(cur, float):
                setattr(kw, attr, float(v))
            else:
                setattr(kw, attr, v)
            known.add(key)
        except (TypeError, ValueError):
            pass
    for k, v, _ in hdr.cards:
        if k and k not in known and k not in _STRUCTURAL:
            kw.extra[k] = v
    return kw


#: header keys of a WCS (``siril_tpu/io/fits_io.py:356``): dropped from
#: ``Keywords.extra`` when the header holds a celestial WCS, which
#: ``write_fits`` writes back from the image's ``wcs``
_WCS_KEYS_PREFIX = ("CRPIX", "CRVAL", "CDELT", "CD1_", "CD2_", "PC1_",
                    "PC2_", "CTYPE", "CUNIT", "CROTA", "EQUINOX", "A_",
                    "B_", "AP_", "BP_", "PLTSOLVD")


def _with_wcs(img: SirilImage, hdr: Header) -> SirilImage:
    """Attach the header's celestial WCS, if any, and take its cards out
    of the keywords."""
    from siril_tpu_torch.ops.wcs import WCS

    w = WCS.from_header(hdr)
    if w is not None:
        img.wcs = w
        img.keywords.extra = {k: v for k, v in img.keywords.extra.items()
                              if not k.startswith(_WCS_KEYS_PREFIX)}
    return img


def keywords_to_cards(kw: Keywords) -> List[Tuple[str, object, str]]:
    cards = []
    defaults = Keywords()
    for key, attr in _KEYMAP.items():
        v = getattr(kw, attr)
        if v is None or v == getattr(defaults, attr):
            continue
        cards.append((key, v, ""))
    for k, v in kw.extra.items():
        cards.append((k, v, ""))
    return cards


#: the table and compression cards of a ZIMAGE extension: not the
#: image's keywords, so that a decoded image saves as a plain image
_ZIMAGE_KEYS = ("TFIELDS", "TTYPE", "TFORM", "ZIMAGE", "ZCMPTYPE",
                "ZBITPIX", "ZNAXIS", "ZTILE", "ZNAME", "ZVAL", "ZZERO",
                "ZSCALE", "ZQUANTIZ", "ZDITHER", "ZBLANK")


def _read_zimage(path, h: HDUInfo) -> SirilImage:
    """Decode a tile-compressed image extension."""
    from siril_tpu_torch.io.fits_compress import read_compressed_hdu

    with open(path, "rb") as f:
        f.seek(h.data_offset)
        buf = f.read(h.data_nbytes)
    data, zbitpix = read_compressed_hdu(buf, h.header)
    if h.header.row_order() != "TOP-DOWN":
        data = np.ascontiguousarray(data[:, ::-1, :])
    kw = header_to_keywords(h.header)
    kw.extra = {k: v for k, v in kw.extra.items()
                if not k.startswith(_ZIMAGE_KEYS)}
    return _with_wcs(SirilImage(
        data=data, keywords=kw,
        orig_bitdepth=zbitpix if zbitpix != 16 else USHORT_IMG,
        history=h.header.history(), fits_header=h.header), h.header)


def read_fits(path: Union[str, os.PathLike], hdu_index: int = 0
              ) -> SirilImage:
    """Read a FITS image (readfits, image_format_fits.c:1201): the
    ``hdu_index``-th plain image HDU, else the ``hdu_index``-th
    compressed one."""
    every = scan_hdus(path)
    hdus = _plain_images(path, every)
    if not hdus:
        zhdus = [h for h in every if _is_zimage(h)]
        if zhdus:
            return _read_zimage(path, zhdus[hdu_index])
        raise ValueError(f"{path}: no image HDU found")
    h = hdus[hdu_index]
    c, hgt, wid = h.shape_chw
    raw = np.fromfile(path, dtype=_DTYPES[h.bitpix], count=c * hgt * wid,
                      offset=h.data_offset).reshape(c, hgt, wid)
    if h.header.row_order() != "TOP-DOWN":
        raw = raw[:, ::-1, :]            # the decode's copy turns the rows
    data = _raw_to_float01(raw, h.bitpix, h.bzero, h.bscale)
    img = _with_wcs(SirilImage(
        data=np.ascontiguousarray(data, dtype=np.float32),
        keywords=header_to_keywords(h.header),
        orig_bitdepth=h.bitpix if h.bitpix != 16 else USHORT_IMG,
        history=h.header.history(), fits_header=h.header), h.header)
    img.icc_profile = _icc_from_hdus(path, every)
    return img


def _icc_extension_bytes(profile: bytes) -> bytes:
    """An 8-bit IMAGE extension EXTNAME = 'ICCProfile' holding the raw
    ``.icc`` bytes (write_icc_profile_to_fptr, image_format_fits.c:931-987;
    ``siril_tpu/io/fits_io.py:578``)."""
    return _header_bytes([("XTENSION", "IMAGE", "IMAGE extension"),
                          ("BITPIX", 8, ""), ("NAXIS", 1, ""),
                          ("NAXIS1", len(profile), ""), ("PCOUNT", 0, ""),
                          ("GCOUNT", 1, ""),
                          ("EXTNAME", "ICCProfile", "")]) + _padded(profile)


def read_icc_extension(path: Union[str, os.PathLike]) -> Optional[bytes]:
    """The raw ICC bytes of an EXTNAME = 'ICCProfile' extension, or None
    (``siril_tpu/io/fits_io.py:596``)."""
    return _icc_from_hdus(path, scan_hdus(path))


def _icc_from_hdus(path, hdus) -> Optional[bytes]:
    for h in hdus:
        if str(h.header.get("EXTNAME", "")).strip() == "ICCProfile":
            n = int(h.header.get("NAXIS1", 0) or 0)
            if n > 0:
                with open(path, "rb") as f:
                    f.seek(h.data_offset)
                    return f.read(n)
    return None


def _encode(data: np.ndarray, bd: int):
    """(big-endian raw data, BITPIX, BZERO) of [0, 1] float32 rows at
    bit depth ``bd``: u16 through BZERO 32768, u8, or float32."""
    if bd == USHORT_IMG:
        # rint(clip(x)·65535) as u16, less 32768 as i16: its top bit
        # flipped, the same bytes (in place: two passes fewer)
        u = np.clip(data, 0.0, 1.0)
        u *= np.float32(65535.0)
        np.rint(u, out=u)
        u16 = u.astype(np.uint16)
        u16 ^= 0x8000
        return u16.astype(">u2"), 16, 32768.0
    if bd == BYTE_IMG:
        return np.rint(np.clip(data, 0.0, 1.0) * 255.0).astype(">u1"), 8, 0.0
    if bd in (FLOAT_IMG, DOUBLE_IMG):
        return data.astype(">f4"), -32, 0.0
    raise ValueError(f"unsupported save bitdepth {bd}")


def _header_bytes(cards) -> bytes:
    hdr = b"".join(_format_card(k, v, cmt).encode("ascii", "replace")
                   for k, v, cmt in cards)
    hdr += _format_card("END", None).encode("ascii")
    return hdr + b" " * ((-len(hdr)) % BLOCK)


def _padded(body: bytes) -> bytes:
    return body + b"\x00" * ((-len(body)) % BLOCK)


def write_fits(img: SirilImage, path: Union[str, os.PathLike],
               bitdepth: Optional[int] = None,
               row_order: str = "BOTTOM-UP",
               compression: Optional[str] = None) -> None:
    """Write a SirilImage as BITPIX 16 (u16 via BZERO), 8 or -32 (a -64
    image as -32; savefits, image_format_fits.c:1393).  ``compression``
    'rice', 'gzip1' or 'gzip2' writes one tile-compressed extension
    after an empty primary HDU (``setcompress``): 16-bit for integer
    depths, float32 (always GZIP_1) for float ones."""
    bd = bitdepth if bitdepth is not None else img.orig_bitdepth
    if bd == SHORT_IMG:
        bd = USHORT_IMG
    data = img.host()
    c, hgt, wid = data.shape
    if row_order.upper() != "TOP-DOWN":
        data = data[:, ::-1, :]
    kw = img.keywords.copy()
    kw.row_order = row_order.upper()
    kw.program = kw.program or "siril_tpu"
    meta = keywords_to_cards(kw)
    if img.wcs is not None:
        meta += img.wcs.to_cards()
    meta += [("HISTORY", h, "") for h in img.history]
    if compression:
        from siril_tpu_torch.io.fits_compress import (
            CMPTYPES,
            build_compressed_hdu,
        )

        cmptype = CMPTYPES.get(str(compression).lower(), "RICE_1")
        zbitpix = -32 if bd in (FLOAT_IMG, DOUBLE_IMG) else 16
        primary = "".join(_format_card(k, v, "") for k, v in (
            ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True)))
        primary += _format_card("END", None)
        primary += " " * ((-len(primary)) % BLOCK)
        with open(path, "wb") as f:
            f.write(primary.encode("ascii"))
            f.write(build_compressed_hdu(np.ascontiguousarray(data),
                                         zbitpix, cmptype, meta))
        return
    raw, bitpix, bzero = _encode(data, bd)
    cards: List[Tuple[str, object, str]] = [
        ("SIMPLE", True, "file conforms to FITS standard"),
        ("BITPIX", bitpix, "number of bits per data pixel")]
    naxis = 2 if c == 1 else 3
    cards.append(("NAXIS", naxis, "number of data axes"))
    cards.append(("NAXIS1", wid, "length of data axis 1"))
    cards.append(("NAXIS2", hgt, "length of data axis 2"))
    if naxis == 3:
        cards.append(("NAXIS3", c, "length of data axis 3"))
    if bzero != 0.0:
        cards.append(("BZERO", bzero, "offset data range"))
        cards.append(("BSCALE", 1.0, "default scaling factor"))
    with open(path, "wb") as f:
        f.write(_header_bytes(cards + meta))
        f.write(_padded(raw.tobytes()))
        if img.icc_profile:
            f.write(_icc_extension_bytes(img.icc_profile))


class FitseqWriter:
    """A FITS cube sequence (io/fits_sequence.c): the first frame in the
    primary HDU, each next one in an IMAGE extension; every frame of one
    shape, at ``bitdepth`` (16-bit for the integer depths, else
    float32)."""

    def __init__(self, path: Union[str, os.PathLike],
                 bitdepth: int = USHORT_IMG):
        self.path = os.fspath(path)
        self.bitdepth = bitdepth
        self._f = open(self.path, "wb")
        self.count = 0

    def append(self, img: SirilImage) -> None:
        data = img.host()
        c, hgt, wid = data.shape
        bd = USHORT_IMG if self.bitdepth in (USHORT_IMG, SHORT_IMG) \
            else FLOAT_IMG
        raw, bitpix, bzero = _encode(data[:, ::-1, :], bd)
        first = self.count == 0
        cards: List[Tuple[str, object, str]] = [
            ("SIMPLE", True, "file conforms to FITS standard") if first
            else ("XTENSION", "IMAGE", "IMAGE extension"),
            ("BITPIX", bitpix, "")]
        naxis = 2 if c == 1 else 3
        cards += [("NAXIS", naxis, ""), ("NAXIS1", wid, ""),
                  ("NAXIS2", hgt, "")]
        if naxis == 3:
            cards.append(("NAXIS3", c, ""))
        cards += [("EXTEND", True, "")] if first \
            else [("PCOUNT", 0, ""), ("GCOUNT", 1, "")]
        if bzero:
            cards += [("BZERO", bzero, ""), ("BSCALE", 1.0, "")]
        self._f.write(_header_bytes(cards + keywords_to_cards(img.keywords)))
        self._f.write(_padded(raw.tobytes()))
        self.count += 1

    def close(self) -> None:
        self._f.close()


class FitsReader:
    """Random access to one image HDU: a memory map of its raw
    big-endian data, or, for a tile-compressed image, its decoded
    pixels (decoded once, when the reader opens)."""

    def __init__(self, path: Union[str, os.PathLike], hdu_index: int = 0):
        self.path = os.fspath(path)
        hdus = image_hdus(path)
        self._decoded = None
        if not hdus:
            zhdus = zimage_hdus(path)
            if not zhdus:
                raise ValueError(f"{path}: no image HDU")
            self.hdu = zhdus[hdu_index]
            self._decoded = _read_zimage(path, self.hdu).data
            self.nchans, self.height, self.width = self._decoded.shape
            return
        self.hdu = hdus[hdu_index]
        self.nchans, self.height, self.width = self.hdu.shape_chw
        self.bottom_up = self.hdu.header.row_order() != "TOP-DOWN"
        self._mm = np.memmap(self.path, dtype=_DTYPES[self.hdu.bitpix],
                             mode="r", offset=self.hdu.data_offset,
                             shape=(self.nchans, self.height, self.width))

    def is_u16(self) -> bool:
        """True for the raw u16 layout the device decodes itself."""
        return (self._decoded is None and self.hdu.bitpix == 16
                and self.hdu.bzero == 32768.0 and self.hdu.bscale == 1.0)

    def is_f32(self) -> bool:
        """True for raw float32 data that needs no scaling."""
        return (self._decoded is None and self.hdu.bitpix == -32
                and self.hdu.bscale == 1.0 and not self.hdu.bzero)

    def read_region(self, chan: int, y0: int, y1: int) -> np.ndarray:
        """Rows [y0, y1) of a channel, top-down, as [0, 1] float32."""
        if self._decoded is not None:
            return np.array(self._decoded[chan, y0:y1])
        if self.bottom_up:
            fy0, fy1 = self.height - y1, self.height - y0
        else:
            fy0, fy1 = y0, y1
        raw = self._mm[chan, fy0:fy1]
        if self.bottom_up:
            raw = raw[::-1]
        return _raw_to_float01(np.ascontiguousarray(raw), self.hdu.bitpix,
                               self.hdu.bzero, self.hdu.bscale)

    def raw_topdown(self, dtype: str) -> np.ndarray:
        """(C, H, W) raw values in native ``dtype`` ("<i2" for the u16
        layout, "<f4"), rows top-down."""
        a = self._mm[:, ::-1, :] if self.bottom_up else self._mm
        return np.ascontiguousarray(a).astype(dtype)
