"""Binary local Gaia catalogue — counterpart of
``siril_tpu/astrometry/gaia_local.py`` (``_cone_pixels``:64,
``GaiaLocalCatalogue``:82, ``write_gaia_astro``:260): the reader and the
writer of the reference's HEALPix-indexed astrometric catalogue
(``src/io/local_catalogues.h`` SourceEntryAstro,
``src/io/healpix/healpix.cpp`` HealpixCatHeader + cumulative index):

  128-byte header  : title[48], gaia_version u8, healpix_level u8,
                     cat_type u8 (1 = astrometric), chunked u8,
                     chunk_level u8, chunk_healpix u32,
                     chunk_first u32, chunk_last u32, spare[63]
  index            : 12·4^level × u32 cumulative record counts per
                     NESTED healpixel
  data             : packed 16-byte records
                     (ra i32·360/2³¹⁻¹, dec i32·360/2³¹⁻¹, pmra i16,
                      pmdec i16 [mas/yr], teff u16 [K], mag i16·0.001)

A cone search reads only the healpixels that overlap the cone.  The
photometric (XP) catalogues of the same format, cat_type 2 and 3, serve
``spcc`` and are not ported yet (ROADMAP §1.5, the image ops: pcc, spcc
and the XP catalogues come first there); such a file raises
``NotImplementedError``.  Host numpy.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from siril_tpu_torch.astrometry.catalog import Catalog
from siril_tpu_torch.astrometry.healpix import ang2pix_nest

HEADER_SIZE = 128
RA_DEC_MULT = 360.0 / 2147483647.0
ENTRY_DTYPE = np.dtype([("ra", "<i4"), ("dec", "<i4"),
                        ("pmra", "<i2"), ("pmdec", "<i2"),
                        ("teff", "<u2"), ("mag", "<i2")])
CAT_ASTROMETRIC = 1
#: photometric catalogue kinds (healpix_cat.h:14-21, the cat_type byte at
#: header offset 50): xp_sampled and xp_continuous records
CAT_XPSAMP = 2
CAT_XPCTS = 3


def _cone_pixels(level: int, ra0: float, dec0: float,
                 radius_deg: float) -> np.ndarray:
    """NESTED healpixels overlapping a cone (dense-sampling query_disc
    approximation, oversampled well past the pixel scale)."""
    nside = 1 << level
    # pixel angular size ~ 58.6°/nside; sample at ~1/4 of that
    samples = max(int(8 * radius_deg * nside / 58.6) + 1, 24)
    t = np.linspace(0.0, radius_deg, samples)
    ang = np.linspace(0.0, 2 * np.pi, 4 * samples, endpoint=False)
    rr, aa = np.meshgrid(t, ang)
    dec = dec0 + (rr * np.cos(aa)).ravel()
    cosd = np.maximum(np.cos(np.radians(np.clip(dec, -89.9, 89.9))), 1e-6)
    ra = ra0 + (rr * np.sin(aa)).ravel() / cosd
    dec = np.clip(dec, -90.0, 90.0)
    ra = np.mod(ra, 360.0)
    return np.unique(ang2pix_nest(nside, ra, dec))


class GaiaLocalCatalogue:
    """Cone-searchable handle on a binary astrometric catalogue file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            hdr = f.read(HEADER_SIZE)
        if len(hdr) < HEADER_SIZE:
            raise ValueError("truncated catalogue header")
        self.title = hdr[:48].rstrip(b"\0 ").decode("ascii", "replace")
        (self.gaia_version, self.level, self.cat_type, self.chunked,
         self.chunk_level) = struct.unpack_from("<5B", hdr, 48)
        (self.chunk_healpix, self.chunk_first,
         self.chunk_last) = struct.unpack_from("<3I", hdr, 53)
        if self.cat_type in (CAT_XPSAMP, CAT_XPCTS):
            raise NotImplementedError(
                f"{path}: Gaia XP (photometric) catalogues are not ported "
                "yet (ROADMAP §1.5, the image ops: spcc and its XP "
                "catalogues)")
        if self.cat_type != CAT_ASTROMETRIC:
            raise ValueError(f"unsupported catalogue type {self.cat_type}")
        nside = 1 << self.level
        self.n_healpixels = 12 * nside * nside
        if self.chunked:
            n_chunks = 12 * (1 << self.chunk_level) ** 2
            self.n_healpixels //= n_chunks
        self.index_size = self.n_healpixels * 4

    def _read_index(self, f, pixel: int) -> int:
        f.seek(HEADER_SIZE + pixel * 4)
        return struct.unpack("<I", f.read(4))[0]

    def _read_cone_entries(self, ra0: float, dec0: float,
                           radius_deg: float) -> np.ndarray:
        """Raw records of the healpixels overlapping a cone, each run of
        consecutive pixels read in one piece."""
        pixels = _cone_pixels(self.level, ra0, dec0, radius_deg)
        if self.chunked:
            pixels = pixels[(pixels >= self.chunk_first)
                            & (pixels <= self.chunk_last)]
            pixels = pixels - self.chunk_first
        pixels = pixels[(pixels >= 0) & (pixels < self.n_healpixels)]
        ranges = []
        start = prev = None
        for p in pixels:
            if prev is not None and p == prev + 1:
                prev = p
                continue
            if start is not None:
                ranges.append((start, prev))
            start = prev = int(p)
        if start is not None:
            ranges.append((start, prev))
        chunks = []
        with open(self.path, "rb") as f:
            for lo, hi in ranges:
                off0 = 0 if lo == 0 else self._read_index(f, lo - 1)
                off1 = self._read_index(f, hi)
                if off1 <= off0:
                    continue
                f.seek(HEADER_SIZE + self.index_size
                       + off0 * ENTRY_DTYPE.itemsize)
                raw = f.read((off1 - off0) * ENTRY_DTYPE.itemsize)
                chunks.append(np.frombuffer(raw, ENTRY_DTYPE))
        if not chunks:
            return np.zeros(0, ENTRY_DTYPE)
        return np.concatenate(chunks)

    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> Catalog:
        e = self._read_cone_entries(ra0, dec0, radius_deg)
        if not len(e):
            z = np.zeros(0)
            return Catalog(ra=z, dec=z, mag=z, cat_name=self.title)
        ra = e["ra"].astype(np.float64) * RA_DEC_MULT
        dec = e["dec"].astype(np.float64) * RA_DEC_MULT
        mag = e["mag"].astype(np.float64) * 0.001
        cosd = np.cos(np.radians(dec0))
        dra = (np.mod(ra - ra0 + 180.0, 360.0) - 180.0) * cosd
        sep = np.hypot(dra, dec - dec0)
        keep = (sep <= radius_deg) & (mag <= mag_limit)
        return Catalog(ra=ra[keep], dec=dec[keep], mag=mag[keep],
                       pmra=e["pmra"][keep].astype(np.float64),
                       pmdec=e["pmdec"][keep].astype(np.float64),
                       cat_name=self.title or "local gaia")


def write_gaia_astro(path: str, ra: np.ndarray, dec: np.ndarray,
                     mag: np.ndarray, level: int = 8,
                     title: str = "siril_tpu gaia astro",
                     pmra: Optional[np.ndarray] = None,
                     pmdec: Optional[np.ndarray] = None,
                     teff: Optional[np.ndarray] = None) -> None:
    """Write a reference-format astrometric catalogue (a local catalogue
    from any source list): header, cumulative healpix index, packed
    records in NESTED pixel order."""
    nside = 1 << level
    pix = ang2pix_nest(nside, np.asarray(ra), np.asarray(dec))
    order = np.argsort(pix, kind="stable")
    pix = pix[order]
    entries = np.zeros(len(ra), ENTRY_DTYPE)
    entries["ra"] = np.round(np.asarray(ra)[order] / RA_DEC_MULT)
    entries["dec"] = np.round(np.asarray(dec)[order] / RA_DEC_MULT)
    entries["mag"] = np.round(np.asarray(mag)[order] * 1000.0)
    if pmra is not None:
        entries["pmra"] = np.round(np.asarray(pmra)[order])
    if pmdec is not None:
        entries["pmdec"] = np.round(np.asarray(pmdec)[order])
    if teff is not None:
        entries["teff"] = np.asarray(teff)[order]
    counts = np.bincount(pix, minlength=12 * nside * nside)
    hdr = bytearray(HEADER_SIZE)
    hdr[:48] = title.encode("ascii", "replace")[:48].ljust(48, b"\0")
    struct.pack_into("<5B", hdr, 48, 3, level, CAT_ASTROMETRIC, 0, 0)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.cumsum(counts).astype("<u4").tobytes())
        f.write(entries.tobytes())
