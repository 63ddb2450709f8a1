"""Binary local Gaia catalogues — counterpart of
``siril_tpu/astrometry/gaia_local.py``: the reader and the writer of the
reference's HEALPix-indexed catalogues (``src/io/local_catalogues.h``,
``src/io/healpix/healpix.cpp`` HealpixCatHeader + cumulative index), the
astrometric kind (``GaiaLocalCatalogue``:82, ``write_gaia_astro``:260) and
the photometric (XP) kinds that ``spcc`` reads (``GaiaXPLocalCatalogue``
:181, ``write_gaia_xpsamp``:277, ``write_gaia_xpcts``:305):

  128-byte header  : title[48], gaia_version u8, healpix_level u8,
                     cat_type u8 (1 astrometric, 2 xp_sampled,
                     3 xp_continuous), chunked u8, chunk_level u8,
                     chunk_healpix u32, chunk_first u32, chunk_last u32,
                     spare[63]
  index            : 12·4^level × u32 cumulative record counts per
                     NESTED healpixel
  data             : packed records — 16 bytes astrometric
                     (ra i32·360/2³¹⁻¹, dec i32·360/2³¹⁻¹, pmra i16,
                      pmdec i16 [mas/yr], teff u16 [K], mag i16·0.001),
                     701 bytes xp_sampled (343 half floats over
                     10^fexpo), 456 bytes xp_continuous (55 + 55 float32
                     Hermite coefficients and the truncation hints)

A cone search reads only the healpixels that overlap the cone.  Host
numpy.
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
# photometric catalogue kinds (healpix_cat.h:14-21 — cat_type byte at
# header offset 50: 2 = xp_sampled records, 3 = xp_continuous records)
CAT_XPSAMP = 2
CAT_XPCTS = 3

XPSAMPLED_LEN = 343
XPCTS_NBASES = 55

# SourceEntryXPsamp (siril_catalogues.h:144-153): 701-byte packed record;
# flux[] holds IEEE half bit patterns scaled by 10^fexpo
XPSAMP_DTYPE = np.dtype([("ra", "<i4"), ("dec", "<i4"),
                         ("pmra", "<i2"), ("pmdec", "<i2"),
                         ("mag", "<i2"), ("fexpo", "u1"),
                         ("flux", "<i2", (XPSAMPLED_LEN,))])
assert XPSAMP_DTYPE.itemsize == 701

# SourceEntryXPcts (xp_continuous.h:27-37): 456-byte packed record with
# float32 Hermite coefficients per band + GaiaXPy truncation hints
XPCTS_DTYPE = np.dtype([("ra", "<i4"), ("dec", "<i4"),
                        ("pmra", "<i2"), ("pmdec", "<i2"),
                        ("mag", "<i2"), ("bp_n", "u1"), ("rp_n", "u1"),
                        ("bp", "<f4", (XPCTS_NBASES,)),
                        ("rp", "<f4", (XPCTS_NBASES,))])
assert XPCTS_DTYPE.itemsize == 456


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

    _ACCEPT_TYPES = (CAT_ASTROMETRIC,)

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
        if self.cat_type not in self._ACCEPT_TYPES:
            raise ValueError(f"unsupported catalogue type {self.cat_type}")
        nside = 1 << self.level
        self.n_healpixels = 12 * nside * nside
        if self.chunked:
            n_chunks = 12 * (1 << self.chunk_level) ** 2
            self.n_healpixels //= n_chunks
        self.index_size = self.n_healpixels * 4

    @property
    def entry_dtype(self) -> np.dtype:
        if self.cat_type == CAT_XPSAMP:
            return XPSAMP_DTYPE
        if self.cat_type == CAT_XPCTS:
            return XPCTS_DTYPE
        return ENTRY_DTYPE

    def _read_index(self, f, pixel: int) -> int:
        f.seek(HEADER_SIZE + pixel * 4)
        return struct.unpack("<I", f.read(4))[0]

    def _read_cone_entries(self, ra0: float, dec0: float,
                           radius_deg: float) -> np.ndarray:
        """Raw record read for the healpixels overlapping a cone."""
        dtype = self.entry_dtype
        pixels = _cone_pixels(self.level, ra0, dec0, radius_deg)
        if self.chunked:
            pixels = pixels[(pixels >= self.chunk_first)
                            & (pixels <= self.chunk_last)]
            pixels = pixels - self.chunk_first
        pixels = pixels[(pixels >= 0) & (pixels < self.n_healpixels)]
        # consecutive ranges → contiguous reads
        chunks = []
        with open(self.path, "rb") as f:
            start = prev = None
            ranges = []
            for p in pixels:
                if prev is not None and p == prev + 1:
                    prev = p
                    continue
                if start is not None:
                    ranges.append((start, prev))
                start = prev = int(p)
            if start is not None:
                ranges.append((start, prev))
            for lo, hi in ranges:
                off0 = 0 if lo == 0 else self._read_index(f, lo - 1)
                off1 = self._read_index(f, hi)
                if off1 <= off0:
                    continue
                f.seek(HEADER_SIZE + self.index_size
                       + off0 * dtype.itemsize)
                raw = f.read((off1 - off0) * dtype.itemsize)
                chunks.append(np.frombuffer(raw, dtype))
        if not chunks:
            return np.zeros(0, dtype)
        return np.concatenate(chunks)

    @staticmethod
    def _cone_keep(e, ra0, dec0, radius_deg, mag_limit):
        ra = e["ra"].astype(np.float64) * RA_DEC_MULT
        dec = e["dec"].astype(np.float64) * RA_DEC_MULT
        mag = e["mag"].astype(np.float64) * 0.001
        cosd = np.cos(np.radians(dec0))
        dra = (np.mod(ra - ra0 + 180.0, 360.0) - 180.0) * cosd
        sep = np.hypot(dra, dec - dec0)
        keep = (sep <= radius_deg) & (mag <= mag_limit)
        return ra, dec, mag, keep

    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> Catalog:
        e = self._read_cone_entries(ra0, dec0, radius_deg)
        if not len(e):
            z = np.zeros(0)
            return Catalog(ra=z, dec=z, mag=z, cat_name=self.title)
        ra, dec, mag, keep = self._cone_keep(e, ra0, dec0, radius_deg,
                                             mag_limit)
        return Catalog(ra=ra[keep], dec=dec[keep], mag=mag[keep],
                       pmra=e["pmra"][keep].astype(np.float64),
                       pmdec=e["pmdec"][keep].astype(np.float64),
                       cat_name=self.title or "local gaia")


class GaiaXPLocalCatalogue(GaiaLocalCatalogue):
    """Photometric (SPCC) local Gaia catalogue: xp_sampled (cat_type 2)
    or xp_continuous (cat_type 3) records — local_catalogues.c:758-812.

    Cone results carry ``xp_sampled`` (N, 343) float64 spectra in
    W·m⁻²·nm⁻¹: xpsamp records decode half floats / 10^fexpo; xpcts
    records run through the baked design-matrix GEMV
    (xp_continuous.cpp:15 equivalent in astrometry/xp_spectra.py).
    """

    _ACCEPT_TYPES = (CAT_XPSAMP, CAT_XPCTS)

    def __init__(self, path: str, design=None):
        super().__init__(path)
        self._design = design

    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> Catalog:
        e = self._read_cone_entries(ra0, dec0, radius_deg)
        if not len(e):
            z = np.zeros(0)
            return Catalog(ra=z, dec=z, mag=z, cat_name=self.title)
        ra, dec, mag, keep = self._cone_keep(e, ra0, dec0, radius_deg,
                                             mag_limit)
        e = e[keep]
        if self.cat_type == CAT_XPSAMP:
            half = np.ascontiguousarray(e["flux"]).view(np.float16)
            powexp = np.power(10.0, e["fexpo"].astype(np.float64))
            xp = half.astype(np.float64) / powexp[:, None]
        else:
            from siril_tpu_torch.astrometry.xp_spectra import (
                load_design,
                xpcts_to_xpsampled,
            )

            design = self._design or load_design()
            if design is None:
                raise ValueError(
                    "xp_continuous catalogue needs XP design matrices — "
                    "set SIRIL_TPU_XP_DESIGN (baked .npz, GaiaXPy config "
                    "dir, or a gaia_xp_design.c)")
            xp = xpcts_to_xpsampled(e["bp"], e["rp"], design)
        return Catalog(ra=ra[keep], dec=dec[keep], mag=mag[keep],
                       pmra=e["pmra"].astype(np.float64),
                       pmdec=e["pmdec"].astype(np.float64),
                       xp_sampled=xp,
                       cat_name=self.title or "local gaia xp")


def _healpix_sort(ra, dec, level):
    nside = 1 << level
    pix = ang2pix_nest(nside, np.asarray(ra), np.asarray(dec))
    order = np.argsort(pix, kind="stable")
    return pix[order], order, 12 * nside * nside


def _write_catalogue(path: str, level: int, cat_type: int,
                     entries: np.ndarray, pix: np.ndarray,
                     npix_total: int, title: str) -> None:
    """Header + cumulative healpix index + packed records."""
    counts = np.bincount(pix, minlength=npix_total)
    cumulative = np.cumsum(counts).astype("<u4")
    hdr = bytearray(HEADER_SIZE)
    hdr[:48] = title.encode("ascii", "replace")[:48].ljust(48, b"\0")
    struct.pack_into("<5B", hdr, 48, 3, level, cat_type, 0, 0)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(cumulative.tobytes())
        f.write(entries.tobytes())


def _fill_common(entries, ra, dec, mag, order, pmra=None, pmdec=None):
    entries["ra"] = np.round(np.asarray(ra)[order] / RA_DEC_MULT)
    entries["dec"] = np.round(np.asarray(dec)[order] / RA_DEC_MULT)
    entries["mag"] = np.round(np.asarray(mag)[order] * 1000.0)
    if pmra is not None:
        entries["pmra"] = np.round(np.asarray(pmra)[order])
    if pmdec is not None:
        entries["pmdec"] = np.round(np.asarray(pmdec)[order])


def write_gaia_astro(path: str, ra: np.ndarray, dec: np.ndarray,
                     mag: np.ndarray, level: int = 8,
                     title: str = "siril_tpu gaia astro",
                     pmra: Optional[np.ndarray] = None,
                     pmdec: Optional[np.ndarray] = None,
                     teff: Optional[np.ndarray] = None) -> None:
    """Write a reference-format astrometric catalogue (used to build a
    local catalogue from any source list, and by the tests)."""
    pix, order, npix_total = _healpix_sort(ra, dec, level)
    entries = np.zeros(len(ra), ENTRY_DTYPE)
    _fill_common(entries, ra, dec, mag, order, pmra, pmdec)
    if teff is not None:
        entries["teff"] = np.asarray(teff)[order]
    _write_catalogue(path, level, CAT_ASTROMETRIC, entries, pix,
                     npix_total, title)


def write_gaia_xpsamp(path: str, ra: np.ndarray, dec: np.ndarray,
                      mag: np.ndarray, flux: np.ndarray, level: int = 8,
                      title: str = "siril_tpu gaia xpsamp",
                      pmra: Optional[np.ndarray] = None,
                      pmdec: Optional[np.ndarray] = None) -> None:
    """Write an xp_sampled photometric catalogue (cat_type 2).

    ``flux``: (N, 343) spectra in W·m⁻²·nm⁻¹.  Each source's samples are
    stored as IEEE half of flux·10^fexpo with a per-source fexpo chosen
    to center the magnitude in the half-float range (decode divides by
    10^fexpo — local_catalogues.c:772-775).
    """
    flux = np.asarray(flux, np.float64)
    pix, order, npix_total = _healpix_sort(ra, dec, level)
    entries = np.zeros(len(ra), XPSAMP_DTYPE)
    _fill_common(entries, ra, dec, mag, order, pmra, pmdec)
    fo = flux[order]
    peak = np.abs(fo).max(axis=1)
    peak = np.where(peak > 0, peak, 1.0)
    # target peak ≈ 1000 in half-float units: fexpo = round(log10(1000/peak))
    fexpo = np.clip(np.round(np.log10(1000.0 / peak)), 0, 255).astype(np.uint8)
    entries["fexpo"] = fexpo
    scaled = fo * np.power(10.0, fexpo.astype(np.float64))[:, None]
    entries["flux"] = scaled.astype(np.float16).view(np.int16)
    _write_catalogue(path, level, CAT_XPSAMP, entries, pix,
                     npix_total, title)


def write_gaia_xpcts(path: str, ra: np.ndarray, dec: np.ndarray,
                     mag: np.ndarray, bp_coeffs: np.ndarray,
                     rp_coeffs: np.ndarray, level: int = 8,
                     title: str = "siril_tpu gaia xpcts",
                     bp_n_relevant: Optional[np.ndarray] = None,
                     rp_n_relevant: Optional[np.ndarray] = None) -> None:
    """Write an xp_continuous photometric catalogue (cat_type 3,
    456-byte SourceEntryXPcts records — xp_continuous.h:27-37)."""
    pix, order, npix_total = _healpix_sort(ra, dec, level)
    entries = np.zeros(len(ra), XPCTS_DTYPE)
    _fill_common(entries, ra, dec, mag, order)
    bp = np.zeros((len(ra), XPCTS_NBASES), np.float32)
    rp = np.zeros((len(ra), XPCTS_NBASES), np.float32)
    bp[:, :np.shape(bp_coeffs)[1]] = np.asarray(bp_coeffs, np.float32)
    rp[:, :np.shape(rp_coeffs)[1]] = np.asarray(rp_coeffs, np.float32)
    entries["bp"] = bp[order]
    entries["rp"] = rp[order]
    if bp_n_relevant is not None:
        entries["bp_n"] = np.asarray(bp_n_relevant)[order]
    if rp_n_relevant is not None:
        entries["rp_n"] = np.asarray(rp_n_relevant)[order]
    _write_catalogue(path, level, CAT_XPCTS, entries, pix,
                     npix_total, title)
