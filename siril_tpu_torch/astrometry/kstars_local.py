"""KStars HTM-indexed binary star catalogue (Tycho-2 / NOMAD) —
counterpart of ``siril_tpu/astrometry/kstars_local.py``
(``_cone_trixels``:39, ``KStarsCatalogue``:54, ``write_kstars_catalogue``
:128), the reference's other local-catalogue family
(``src/io/local_catalogues.c`` catalogue_read_header / read_trixel,
``src/io/kstars/binfile.h``):

  top header    : description[124], endian_id i16 (0x4B53 'KS'),
                  version u8                              (127 bytes)
  field table   : nfields u16, then nfields × dataElement
                  (name[10], size i8, type u8, scale i32) (16 bytes each)
  trixel index  : ntrixels u32, then ntrixels ×
                  {trixelID u32, offset u32, nrecs u32}
  expansion     : faint_mag i16, HTM_level u8, max_stars u16
  data          : per-trixel runs of 16-byte deepStarData records
                  (RA i32 [hours·1e6], Dec i32 [deg·1e5], dRA i16,
                   dDec i16 [mas/yr], B i16, V i16 [mag·1000])

A cone search reads only the HTM trixels that overlap the cone (found by
sampling the cone densely through ``healpix.radec_to_htm``).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from siril_tpu_torch.astrometry.catalog import Catalog
from siril_tpu_torch.astrometry.healpix import radec_to_htm

ENDIAN_ID = 0x4B53
DEEPSTAR_DTYPE = np.dtype([("RA", "<i4"), ("Dec", "<i4"),
                           ("dRA", "<i2"), ("dDec", "<i2"),
                           ("B", "<i2"), ("V", "<i2")])


def _cone_trixels(level: int, ra0: float, dec0: float,
                  radius_deg: float) -> np.ndarray:
    """0-based trixel indices (HTM id − 8·4^level) overlapping a cone."""
    # dense sampling well below the trixel scale (~60°/2^level)
    samples = max(int(12 * radius_deg * (1 << level) / 60.0) + 1, 24)
    t = np.linspace(0.0, radius_deg, samples)
    ang = np.linspace(0.0, 2 * np.pi, 4 * samples, endpoint=False)
    rr, aa = np.meshgrid(t, ang)
    dec = np.clip(dec0 + (rr * np.cos(aa)).ravel(), -90.0, 90.0)
    cosd = np.maximum(np.cos(np.radians(np.clip(dec, -89.9, 89.9))), 1e-6)
    ra = np.mod(ra0 + (rr * np.sin(aa)).ravel() / cosd, 360.0)
    ids = np.unique(radec_to_htm(ra, dec, level))
    return ids - 8 * 4 ** level


class KStarsCatalogue:
    """Cone-searchable handle on a KStars binary catalogue file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            top = f.read(127)
            if len(top) < 127:
                raise ValueError("truncated KStars catalogue header")
            endian = struct.unpack_from("<h", top, 124)[0]
            if endian not in (ENDIAN_ID, 0x534B):
                raise ValueError("invalid endian ID in KStars catalogue")
            # 0x534B = byteswapped 'KS': catalogue written on an
            # opposite-endian host; the reference byteswaps every
            # subsequent field based on this flag (binfile.h bswap).
            self._swap = endian == 0x534B
            bo = ">" if self._swap else "<"
            self.title = top[:124].split(b"\0")[0].decode("ascii",
                                                          "replace")
            self.nfields = struct.unpack(bo + "H", f.read(2))[0]
            if self.nfields not in (6, 11):
                raise ValueError(f"unrecognized field count "
                                 f"{self.nfields}")
            f.seek(self.nfields * 16, os.SEEK_CUR)
            self.ntrixels = struct.unpack(bo + "I", f.read(4))[0]
            if not (1 <= self.ntrixels <= 1 << 20):
                raise ValueError("trixel count out of limits")
            level = -1
            n = self.ntrixels
            while n >= 4:
                n >>= 2
                level += 1
            self.level = level
            idx = np.frombuffer(f.read(self.ntrixels * 12),
                                np.dtype([("id", bo + "u4"),
                                          ("offset", bo + "u4"),
                                          ("nrecs", bo + "u4")]))
            self._index = {int(r["id"]): (int(r["offset"]),
                                          int(r["nrecs"])) for r in idx}

    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> Catalog:
        trixels = _cone_trixels(self.level, ra0, dec0, radius_deg)
        chunks = []
        with open(self.path, "rb") as f:
            for t in trixels:
                ent = self._index.get(int(t))
                if not ent or ent[1] == 0:
                    continue
                off, nrecs = ent
                f.seek(off)
                raw = f.read(nrecs * DEEPSTAR_DTYPE.itemsize)
                dt = (DEEPSTAR_DTYPE.newbyteorder() if self._swap
                      else DEEPSTAR_DTYPE)
                chunks.append(np.frombuffer(raw, dt))
        if not chunks:
            z = np.zeros(0)
            return Catalog(ra=z, dec=z, mag=z, cat_name=self.title)
        e = np.concatenate(chunks)
        ra = e["RA"].astype(np.float64) * 1e-6 * 15.0
        dec = e["Dec"].astype(np.float64) * 1e-5
        vmag = e["V"].astype(np.float64) * 0.001
        bmag = e["B"].astype(np.float64) * 0.001
        cosd = np.cos(np.radians(dec0))
        dra = (np.mod(ra - ra0 + 180.0, 360.0) - 180.0) * cosd
        sep = np.hypot(dra, dec - dec0)
        keep = (sep <= radius_deg) & (vmag <= mag_limit)
        return Catalog(ra=ra[keep], dec=dec[keep], mag=vmag[keep],
                       bv=(bmag - vmag)[keep],
                       pmra=e["dRA"][keep].astype(np.float64),
                       pmdec=e["dDec"][keep].astype(np.float64),
                       cat_name=self.title or "kstars local")


def write_kstars_catalogue(path: str, ra: np.ndarray, dec: np.ndarray,
                           vmag: np.ndarray,
                           bmag: Optional[np.ndarray] = None,
                           level: int = 3,
                           title: str = "siril_tpu deep stars") -> None:
    """Write a KStars-format deep-star catalogue (tests + building local
    catalogues from any source)."""
    n = len(ra)
    ntrixels = 8 * 4 ** level
    trix = radec_to_htm(np.asarray(ra), np.asarray(dec),
                        level) - 8 * 4 ** level
    order = np.argsort(trix, kind="stable")
    trix = trix[order]
    rec = np.zeros(n, DEEPSTAR_DTYPE)
    rec["RA"] = np.round(np.asarray(ra)[order] / 15.0 * 1e6)
    rec["Dec"] = np.round(np.asarray(dec)[order] * 1e5)
    rec["V"] = np.round(np.asarray(vmag)[order] * 1000.0)
    rec["B"] = np.round((np.asarray(bmag)[order] if bmag is not None
                         else np.asarray(vmag)[order]) * 1000.0)

    fields = [("RA", 4, 0, 1000000), ("Dec", 4, 0, 100000),
              ("dRA", 2, 0, 10), ("dDec", 2, 0, 10),
              ("B", 2, 0, 1000), ("V", 2, 0, 1000)]
    header = bytearray()
    desc = title.encode("ascii", "replace")[:123]
    header += desc.ljust(124, b"\0")
    header += struct.pack("<hB", ENDIAN_ID, 1)
    header += struct.pack("<H", len(fields))
    for name, size, typ, scale in fields:
        header += struct.pack("<10sbBi", name.encode(), size, typ, scale)
    header += struct.pack("<I", ntrixels)

    index_pos = len(header)
    index_size = ntrixels * 12
    expansion = struct.pack("<hBH", int(np.max(vmag) * 1000) if n else 0,
                            level, 10000)
    data_start = index_pos + index_size + len(expansion)

    counts = np.bincount(trix, minlength=ntrixels)
    offsets = np.zeros(ntrixels, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    index = b"".join(
        struct.pack("<III", t,
                    data_start + int(offsets[t]) * DEEPSTAR_DTYPE.itemsize,
                    int(counts[t]))
        for t in range(ntrixels))
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(index)
        f.write(expansion)
        f.write(rec.tobytes())
