"""Remote catalogues — counterpart of ``siril_tpu/astrometry/remote.py``
(``TAP_CATALOGUES``:52, ``conesearch_url``:85, ``object_search_url``:107,
the transports :117-184, ``parse_tap_csv``:187, ``parse_sesame``:227,
``RemoteCatalogue``:260, ``search_object``:280): TAP cone searches and the
by-name object lookup behind a transport seam (the reference's
``src/io/remote_catalogues.c`` and ``src/algos/search_objects.c``).

The URLs are the reference's, byte for byte (its servers, ADQL shape and
``%08.4f`` / ``%+08.4f`` / ``%3.2f`` / ``%3.1f`` fields,
remote_catalogues.c:43-232), so recorded fixtures and live servers see
the same queries.  ``FixtureTransport`` serves recorded responses from a
directory keyed by a hash of the URL (``$SIRIL_TPU_CAT_FIXTURES``);
``UrllibTransport`` refuses to touch the network unless its caller's
session is online (the ``online`` command), and nothing here is fetched
otherwise.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import urllib.parse
from dataclasses import dataclass
from typing import Dict

import numpy as np

from siril_tpu_torch.astrometry.catalog import Catalog

_log = logging.getLogger(__name__)

VIZIER_TAP = ("https://tapvizier.u-strasbg.fr/TAPVizieR/tap/sync?"
              "REQUEST=doQuery&LANG=ADQL&FORMAT=csv&QUERY=SELECT+")
SIMBAD_TAP = ("https://simbad.u-strasbg.fr/simbad/sim-tap/sync?"
              "REQUEST=doQuery&LANG=ADQL&FORMAT=csv&QUERY=SELECT+")
EXO_TAP = ("https://exoplanetarchive.ipac.caltech.edu/TAP/sync?"
           "format=csv&query=select+")
SIMBAD_SESAME = "https://simbad.u-strasbg.fr/simbad/sim-id?output.format=ASCII&Ident="

# field keys in canonical output column order (siril_catalogues.c:46-58)
F_RA, F_DEC, F_PMRA, F_PMDEC, F_MAG, F_BMAG, F_NAME = (
    "ra", "dec", "pmra", "pmdec", "mag", "bmag", "name")


@dataclass
class TapFields:
    server: str
    catcode: str
    columns: Dict[str, str]       # canonical name -> remote column


# remote_catalogues.c:54-170 catalog_to_tap_fields
TAP_CATALOGUES: Dict[str, TapFields] = {
    "tycho2": TapFields(VIZIER_TAP, "%22I/259/tyc2%22", {
        F_RA: "RAmdeg", F_DEC: "DEmdeg", F_MAG: "VTmag", F_BMAG: "BTmag",
        F_PMRA: "pmRA", F_PMDEC: "pmDE"}),
    "nomad": TapFields(VIZIER_TAP, "%22I/297/out%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_PMRA: "pmRA", F_PMDEC: "pmDE",
        F_MAG: "Vmag", F_BMAG: "Bmag"}),
    "gaiadr3": TapFields(VIZIER_TAP, "%22I/355/gaiadr3%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_PMRA: "pmRA", F_PMDEC: "pmDE",
        F_MAG: "Gmag", F_BMAG: "BPmag"}),
    "ppmxl": TapFields(VIZIER_TAP, "%22I/317/sample%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_PMRA: "pmRA", F_PMDEC: "pmDE",
        F_MAG: "r1mag", F_BMAG: "b1mag"}),
    "apass": TapFields(VIZIER_TAP, "%22II/336/apass9%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_MAG: "Vmag", F_BMAG: "Bmag"}),
    "bsc": TapFields(VIZIER_TAP, "%22V/50/catalog%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_PMRA: "pmRA", F_PMDEC: "pmDE",
        F_MAG: "Vmag", F_NAME: "Name"}),
    "gcvs": TapFields(VIZIER_TAP, "%22B/gcvs/gcvs_cat%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_MAG: "magMax",
        F_NAME: "VarName"}),
    "vsx": TapFields(VIZIER_TAP, "%22B/vsx/vsx%22", {
        F_RA: "RAJ2000", F_DEC: "DEJ2000", F_MAG: "max", F_NAME: "Name"}),
    "simbad": TapFields(SIMBAD_TAP, "basic+JOIN+allfluxes+ON+oidref+=+oid", {
        F_RA: "ra", F_DEC: "dec", F_MAG: "V", F_BMAG: "B",
        F_PMRA: "pmra", F_PMDEC: "pmdec", F_NAME: "main_id"}),
}

# canonical column iteration order used by the reference when building
# the SELECT list (CAT_FIELD_* enum order)
_FIELD_ORDER = (F_RA, F_DEC, F_PMRA, F_PMDEC, F_MAG, F_BMAG, F_NAME)


def conesearch_url(cat_name: str, ra_deg: float, dec_deg: float,
                   radius_arcmin: float, limit_mag: float = 0.0) -> str:
    """ADQL cone-search URL, byte-identical to the reference's
    siril_catalog_conesearch_get_url (remote_catalogues.c:201-232)."""
    f = TAP_CATALOGUES[cat_name.lower()]
    parts = []
    for key in _FIELD_ORDER:
        col = f.columns.get(key)
        if col:
            parts.append(f"{col}+as+{key}")
    url = f.server + ",".join(parts)
    url += f"+FROM+{f.catcode}"
    rac, decc = f.columns[F_RA], f.columns[F_DEC]
    url += f"+WHERE+CONTAINS(POINT('ICRS',{rac},{decc}),"
    url += ("CIRCLE('ICRS',%08.4f,%+08.4f,%3.2f))=1"
            % (ra_deg, dec_deg, radius_arcmin / 60.0))
    if limit_mag > 0 and F_MAG in f.columns:
        url += "+AND+(%s<=%3.1f)" % (f.columns[F_MAG], limit_mag)
    return url


def object_search_url(name: str) -> str:
    """SIMBAD by-name lookup (search_objects.c sesame path)."""
    return SIMBAD_SESAME + urllib.parse.quote(name)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class TransportError(RuntimeError):
    pass


class UrllibTransport:
    """Live HTTP GET — refused unless the caller's session is online
    (siril_networking.c is_online; the ``online`` / ``offline`` commands
    set ``Session.online``, off by default)."""

    def __init__(self, timeout: float = 30.0, online: bool = False):
        self.timeout = timeout
        self.online = online

    def get(self, url: str) -> str:
        if not self.online:
            raise TransportError(
                "offline mode: enable with the `online` command, or use a "
                "fixture/local catalogue")
        import urllib.request

        req = urllib.request.Request(url, headers={"User-Agent": "siril_tpu"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read().decode("utf-8", "replace")
        except Exception as e:
            raise TransportError(f"remote query failed: {e}") from e


class FixtureTransport:
    """Recorded-response transport: responses live in a directory as
    <sha1(url)[:16]>.csv (plus an index file mapping hash → url for
    humans).  record(url, text) writes one."""

    def __init__(self, directory: str):
        self.directory = directory

    @staticmethod
    def key(url: str) -> str:
        return hashlib.sha1(url.encode()).hexdigest()[:16]

    def path(self, url: str) -> str:
        return os.path.join(self.directory, self.key(url) + ".csv")

    def record(self, url: str, text: str) -> None:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path(url), "w") as f:
            f.write(text)
        with open(os.path.join(self.directory, "index.txt"), "a") as f:
            f.write(f"{self.key(url)} {url}\n")

    def get(self, url: str) -> str:
        p = self.path(url)
        if not os.path.exists(p):
            raise TransportError(f"no fixture recorded for {url}")
        with open(p) as f:
            return f.read()


def default_transport(online: bool = False):
    """Recorded responses from ``$SIRIL_TPU_CAT_FIXTURES`` when it is set,
    else the live transport, gated by ``online``."""
    fixture_dir = os.environ.get("SIRIL_TPU_CAT_FIXTURES")
    if fixture_dir:
        return FixtureTransport(fixture_dir)
    return UrllibTransport(online=online)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def parse_tap_csv(text: str, cat_name: str = "remote") -> Catalog:
    """TAP csv (canonical column names from the SELECT ... as aliases) →
    Catalog.  Blank mags become NaN; rows without ra/dec are dropped."""
    import csv

    rdr = csv.DictReader(io.StringIO(text))
    rows = [r for r in rdr]
    if not rows:
        z = np.zeros(0)
        return Catalog(ra=z, dec=z, mag=z, cat_name=cat_name)

    def col(key, default=np.nan):
        out = np.full(len(rows), default, np.float64)
        for i, r in enumerate(rows):
            v = (r.get(key) or "").strip()
            if v:
                try:
                    out[i] = float(v)
                except ValueError:
                    pass
        return out

    ra = col(F_RA)
    dec = col(F_DEC)
    ok = np.isfinite(ra) & np.isfinite(dec)
    mag = col(F_MAG)
    bmag = col(F_BMAG)
    bv = np.where(np.isfinite(bmag) & np.isfinite(mag), bmag - mag, np.nan)
    names = [(r.get(F_NAME) or "").strip() for r in rows]
    has_names = any(names)
    kept = np.nonzero(ok)[0]
    return Catalog(
        ra=ra[kept], dec=dec[kept],
        mag=np.where(np.isfinite(mag[kept]), mag[kept], 99.0),
        bv=bv[kept] if np.isfinite(bv[kept]).any() else None,
        pmra=col(F_PMRA)[kept], pmdec=col(F_PMDEC)[kept],
        names=[names[i] for i in kept] if has_names else None,
        cat_name=cat_name)


def parse_sesame(text: str):
    """SIMBAD ASCII sesame reply → (ra_deg, dec_deg, name) or None.
    Looks for the 'Coordinates(ICRS,...)' line (search_objects.c parse)."""
    ra = dec = None
    name = None
    for line in text.splitlines():
        ls = line.strip()
        if ls.startswith("Object"):
            name = ls.split("---")[0].replace("Object", "").strip()
        if ls.startswith("Coordinates(ICRS"):
            try:
                after = ls.split(":", 1)[1].strip()
                toks = after.split()
                if len(toks) >= 6:
                    h, m, s = float(toks[0]), float(toks[1]), float(toks[2])
                    dd, dm, ds = toks[3], float(toks[4]), float(toks[5])
                    sign = -1.0 if dd.startswith("-") else 1.0
                    ra = (h + m / 60 + s / 3600) * 15.0
                    dec = sign * (abs(float(dd)) + dm / 60 + ds / 3600)
                elif len(toks) >= 2:
                    ra, dec = float(toks[0]), float(toks[1])
            except (ValueError, IndexError):
                pass
    if ra is None or dec is None:
        return None
    return ra, dec, name or "object"


# ---------------------------------------------------------------------------
# high level
# ---------------------------------------------------------------------------


class RemoteCatalogue:
    """A cone-searchable remote catalogue (drop-in for the local ones)."""

    def __init__(self, cat_name: str, transport=None, online: bool = False):
        if cat_name.lower() not in TAP_CATALOGUES:
            raise ValueError(f"unknown remote catalogue '{cat_name}' "
                             f"(have: {', '.join(sorted(TAP_CATALOGUES))})")
        self.cat_name = cat_name.lower()
        self.transport = transport or default_transport(online)

    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> Catalog:
        url = conesearch_url(self.cat_name, ra0, dec0, radius_deg * 60.0,
                             0.0 if mag_limit >= 99.0 else mag_limit)
        text = self.transport.get(url)
        cat = parse_tap_csv(text, self.cat_name)
        _log.info("%s: %d objects from remote", self.cat_name, len(cat))
        return cat


def search_object(name: str, transport=None, online: bool = False):
    """By-name lookup (catsearch / search_objects.c)."""
    transport = transport or default_transport(online)
    text = transport.get(object_search_url(name))
    return parse_sesame(text)
