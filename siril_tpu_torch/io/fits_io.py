"""Pure-numpy FITS reader/writer — counterpart of
``siril_tpu/io/fits_io.py`` (read_fits:432, write_fits:474).

A trimmed copy for the fused stack path: plain image HDUs with BITPIX 16
(u16 through BZERO 32768) and -32.  FITS rows are stored bottom-up unless
ROWORDER='TOP-DOWN'; the in-memory convention is top-down (row 0 = top).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np

from siril_tpu_torch.core.image import (
    FLOAT_IMG,
    INV_USHRT_MAX_SINGLE,
    SHORT_IMG,
    USHORT_IMG,
    Keywords,
    SirilImage,
)

BLOCK = 2880
CARD = 80

_DTYPES = {16: np.dtype(">i2"), -32: np.dtype(">f4")}


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
                bzero=float(hdr.get("BZERO", 0.0) or 0.0),
                bscale=float(hdr.get("BSCALE", 1.0) or 1.0)))
            f.seek(off + (nbytes + BLOCK - 1) // BLOCK * BLOCK)
    return hdus


def image_hdus(path: Union[str, os.PathLike]) -> List[HDUInfo]:
    hdus = [h for h in scan_hdus(path)
            if len(h.naxes) >= 2 and all(n > 0 for n in h.naxes)]
    for h in hdus:
        if h.bitpix not in _DTYPES:
            raise NotImplementedError(
                f"{path}: BITPIX {h.bitpix} is not ported yet (the port "
                "reads BITPIX 16 and -32; ROADMAP §1.2, FITS BITPIX "
                "8/32/-64)")
    return hdus


def _raw_to_float01(raw: np.ndarray, bitpix: int, bzero: float,
                    bscale: float) -> np.ndarray:
    """Physical value → Siril [0,1] float32 (readfits rules): u16 /65535,
    f32 passthrough.  Signed SHORT (BZERO 0) is shifted by 32768."""
    if bitpix == 16:
        if bzero == 0.0 and bscale == 1.0:
            bzero = 32768.0
        phys = raw.astype(np.float32) * np.float32(bscale) + np.float32(bzero)
        return phys * np.float32(INV_USHRT_MAX_SINGLE)
    phys = raw.astype(np.float32)
    if bscale != 1.0 or bzero != 0.0:
        phys = phys * np.float32(bscale) + np.float32(bzero)
    return phys


_KEYMAP = {
    "PROGRAM": "program",
    "FILENAME": "filename",
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


def read_fits(path: Union[str, os.PathLike], hdu_index: int = 0
              ) -> SirilImage:
    """Read a FITS image (readfits, image_format_fits.c:1201)."""
    hdus = image_hdus(path)
    if not hdus:
        raise ValueError(f"{path}: no image HDU found")
    h = hdus[hdu_index]
    c, hgt, wid = h.shape_chw
    raw = np.fromfile(path, dtype=_DTYPES[h.bitpix], count=c * hgt * wid,
                      offset=h.data_offset).reshape(c, hgt, wid)
    data = _raw_to_float01(raw, h.bitpix, h.bzero, h.bscale)
    row_order = str(h.header.get("ROWORDER", "BOTTOM-UP") or "BOTTOM-UP")
    if row_order.upper() != "TOP-DOWN":
        data = data[:, ::-1, :]
    return SirilImage(
        data=np.ascontiguousarray(data, dtype=np.float32),
        keywords=header_to_keywords(h.header),
        orig_bitdepth=h.bitpix if h.bitpix != 16 else USHORT_IMG,
        history=h.header.history())


def write_fits(img: SirilImage, path: Union[str, os.PathLike],
               bitdepth: Optional[int] = None,
               row_order: str = "BOTTOM-UP") -> None:
    """Write a SirilImage as BITPIX 16 (u16 via BZERO) or -32
    (savefits, image_format_fits.c:1393)."""
    bd = bitdepth if bitdepth is not None else img.orig_bitdepth
    if bd == SHORT_IMG:
        bd = USHORT_IMG
    data = img.host()
    c, hgt, wid = data.shape
    if row_order.upper() != "TOP-DOWN":
        data = data[:, ::-1, :]
    cards: List[Tuple[str, object, str]] = [
        ("SIMPLE", True, "file conforms to FITS standard")]
    if bd == USHORT_IMG:
        u16 = np.rint(np.clip(data, 0.0, 1.0) * 65535.0).astype(np.uint16)
        raw = (u16.astype(np.int32) - 32768).astype(">i2")
        cards.append(("BITPIX", 16, "number of bits per data pixel"))
        bzero = 32768.0
    elif bd == FLOAT_IMG:
        raw = data.astype(">f4")
        cards.append(("BITPIX", -32, "number of bits per data pixel"))
        bzero = 0.0
    else:
        raise NotImplementedError(
            f"saving bitdepth {bd} is not ported yet (BITPIX 16 and -32 "
            "only; ROADMAP §1.2, FITS BITPIX 8/32/-64)")
    naxis = 2 if c == 1 else 3
    cards.append(("NAXIS", naxis, "number of data axes"))
    cards.append(("NAXIS1", wid, "length of data axis 1"))
    cards.append(("NAXIS2", hgt, "length of data axis 2"))
    if naxis == 3:
        cards.append(("NAXIS3", c, "length of data axis 3"))
    if bzero != 0.0:
        cards.append(("BZERO", bzero, "offset data range"))
        cards.append(("BSCALE", 1.0, "default scaling factor"))
    kw = img.keywords.copy()
    kw.row_order = row_order.upper()
    kw.program = kw.program or "siril_tpu"
    cards.extend(keywords_to_cards(kw))
    for hline in img.history:
        cards.append(("HISTORY", hline, ""))
    hdr = b"".join(_format_card(k, v, cmt).encode("ascii", "replace")
                   for k, v, cmt in cards)
    hdr += _format_card("END", None).encode("ascii")
    hdr += b" " * ((-len(hdr)) % BLOCK)
    body = raw.tobytes()
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(b"\x00" * ((-len(body)) % BLOCK))


class FitsReader:
    """Memory-mapped view of one image HDU's raw big-endian data."""

    def __init__(self, path: Union[str, os.PathLike], hdu_index: int = 0):
        self.path = os.fspath(path)
        hdus = image_hdus(path)
        if not hdus:
            raise ValueError(f"{path}: no image HDU")
        self.hdu = hdus[hdu_index]
        self.nchans, self.height, self.width = self.hdu.shape_chw
        ro = str(self.hdu.header.get("ROWORDER", "BOTTOM-UP") or "BOTTOM-UP")
        self.bottom_up = ro.upper() != "TOP-DOWN"
        self._mm = np.memmap(self.path, dtype=_DTYPES[self.hdu.bitpix],
                             mode="r", offset=self.hdu.data_offset,
                             shape=(self.nchans, self.height, self.width))

    def is_u16(self) -> bool:
        """True for the raw u16 layout the device decodes itself."""
        return (self.hdu.bitpix == 16 and self.hdu.bzero == 32768.0
                and self.hdu.bscale == 1.0)

    def read_region(self, chan: int, y0: int, y1: int) -> np.ndarray:
        """Rows [y0, y1) of a channel, top-down, as [0, 1] float32."""
        if self.bottom_up:
            fy0, fy1 = self.height - y1, self.height - y0
        else:
            fy0, fy1 = y0, y1
        raw = self._mm[chan, fy0:fy1]
        if self.bottom_up:
            raw = raw[::-1]
        return _raw_to_float01(np.ascontiguousarray(raw), self.hdu.bitpix,
                               self.hdu.bzero, self.hdu.bscale)

    def raw_i16_topdown(self) -> np.ndarray:
        """(C, H, W) native-endian int16, rows top-down."""
        a = self._mm[:, ::-1, :] if self.bottom_up else self._mm
        return np.ascontiguousarray(a).astype("<i2")
