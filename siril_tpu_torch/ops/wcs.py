"""World coordinate system — counterpart of ``siril_tpu/ops/wcs.py``
(``WCS``:26 with ``pix2world``:37, ``world2pix``:52, ``shifted``:85,
``from_header``:94, ``to_cards``:121; ``_sip_eval``:152,
``_sip_from_header``:162, ``_tan_to_sky``:172, ``_sky_to_tan``:185,
``parse_ra``:205, ``parse_dec``:216, ``format_ra``:246,
``format_dec``:255), which replaces the reference's wcslib wrapper
(``src/algos/siril_wcs.c``) with a self-contained TAN(+SIP) projection.
Host numpy, float64.

Conventions: FITS — CRPIX is 1-based, the CD matrix is in deg/px, the
projection gnomonic (TAN); the SIP polynomials (A/B forward, AP/BP
inverse; Shupe et al. 2005) are evaluated in the FITS pixel frame
relative to CRPIX, u = x + 1 − CRPIX1 and v = y_FITS + 1 − CRPIX2 with
y_FITS counted bottom-up.  Image coordinates here are the internal
top-down pixel coordinates; conversions flip through the stored image
height.  ``sip_frame`` gives that frame to the code that evaluates SIP on
top-down coordinates (the ``-disto`` warp, the ``disto`` command), so
that every SIP evaluation of the port uses the frame of ``pix2world``;
the JAX package's warp uses top-down v there (ROADMAP §3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

D2R = math.pi / 180.0
R2D = 180.0 / math.pi


@dataclass
class WCS:
    crpix: Tuple[float, float] = (0.0, 0.0)      # 1-based FITS pixel
    crval: Tuple[float, float] = (0.0, 0.0)      # RA, Dec (deg)
    cd: np.ndarray = field(default_factory=lambda: np.eye(2) * (1 / 3600.0))
    height: int = 0                              # for top-down flip
    sip_a: Optional[np.ndarray] = None           # (order+1, order+1)
    sip_b: Optional[np.ndarray] = None
    sip_ap: Optional[np.ndarray] = None
    sip_bp: Optional[np.ndarray] = None

    # ---- projection ----
    def pix2world(self, x, y):
        """Internal top-down pixel (0-based, pixel-center 0.0) → (RA, Dec) deg."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        yf = (self.height - 1) - y if self.height else y     # to bottom-up
        u = x + 1.0 - self.crpix[0]
        v = yf + 1.0 - self.crpix[1]
        if self.sip_a is not None:
            u2 = u + _sip_eval(self.sip_a, u, v)
            v2 = v + _sip_eval(self.sip_b, u, v)
            u, v = u2, v2
        xi = self.cd[0, 0] * u + self.cd[0, 1] * v      # deg
        eta = self.cd[1, 0] * u + self.cd[1, 1] * v
        return _tan_to_sky(xi, eta, self.crval)

    def world2pix(self, ra, dec):
        """(RA, Dec) deg → internal top-down pixel coords."""
        xi, eta = _sky_to_tan(np.asarray(ra, np.float64),
                              np.asarray(dec, np.float64), self.crval)
        inv = np.linalg.inv(self.cd)
        u = inv[0, 0] * xi + inv[0, 1] * eta
        v = inv[1, 0] * xi + inv[1, 1] * eta
        if self.sip_ap is not None:
            u2 = u + _sip_eval(self.sip_ap, u, v)
            v2 = v + _sip_eval(self.sip_bp, u, v)
            u, v = u2, v2
        elif self.sip_a is not None:
            # iterative inversion of the forward SIP
            u0, v0 = u.copy() if hasattr(u, "copy") else u, v
            for _ in range(5):
                du = _sip_eval(self.sip_a, u, v)
                dv = _sip_eval(self.sip_b, u, v)
                u = u0 - du
                v = v0 - dv
        x = u + self.crpix[0] - 1.0
        yf = v + self.crpix[1] - 1.0
        y = (self.height - 1) - yf if self.height else yf
        return x, y

    # ---- metadata ----
    @property
    def pixel_scale_arcsec(self) -> float:
        return float(np.sqrt(abs(np.linalg.det(self.cd))) * 3600.0)

    @property
    def rotation_deg(self) -> float:
        return math.degrees(math.atan2(self.cd[1, 0], self.cd[0, 0]))

    def shifted(self, dx: float, dy: float) -> "WCS":
        w = WCS(crpix=(self.crpix[0] + dx, self.crpix[1] - dy),
                crval=self.crval, cd=self.cd.copy(), height=self.height,
                sip_a=self.sip_a, sip_b=self.sip_b,
                sip_ap=self.sip_ap, sip_bp=self.sip_bp)
        return w

    # ---- FITS header I/O ----
    @staticmethod
    def from_header(hdr) -> Optional["WCS"]:
        ct1 = hdr.get("CTYPE1")
        if not ct1 or "RA" not in str(ct1):
            return None
        w = WCS()
        w.crpix = (float(hdr.get("CRPIX1", 0.0)), float(hdr.get("CRPIX2", 0.0)))
        w.crval = (float(hdr.get("CRVAL1", 0.0)), float(hdr.get("CRVAL2", 0.0)))
        naxis2 = hdr.get("NAXIS2")
        w.height = int(naxis2) if naxis2 else 0
        if hdr.get("CD1_1") is not None:
            w.cd = np.array([[float(hdr.get("CD1_1", 0)), float(hdr.get("CD1_2", 0))],
                             [float(hdr.get("CD2_1", 0)), float(hdr.get("CD2_2", 0))]])
        else:
            cdelt1 = float(hdr.get("CDELT1", 1 / 3600.0) or 1 / 3600.0)
            cdelt2 = float(hdr.get("CDELT2", 1 / 3600.0) or 1 / 3600.0)
            rot = float(hdr.get("CROTA2", 0.0) or 0.0) * D2R
            w.cd = np.array([[cdelt1 * math.cos(rot), -cdelt2 * math.sin(rot)],
                             [cdelt1 * math.sin(rot), cdelt2 * math.cos(rot)]])
        a_order = hdr.get("A_ORDER")
        if a_order:
            w.sip_a = _sip_from_header(hdr, "A", int(a_order))
            w.sip_b = _sip_from_header(hdr, "B", int(hdr.get("B_ORDER", a_order)))
            if hdr.get("AP_ORDER"):
                w.sip_ap = _sip_from_header(hdr, "AP", int(hdr.get("AP_ORDER")))
                w.sip_bp = _sip_from_header(hdr, "BP", int(hdr.get("BP_ORDER")))
        return w

    def to_cards(self):
        suffix = "-SIP" if self.sip_a is not None else ""
        cards = [
            ("CTYPE1", f"RA---TAN{suffix}", "TAN (gnomonic) projection"),
            ("CTYPE2", f"DEC--TAN{suffix}", "TAN (gnomonic) projection"),
            ("CUNIT1", "deg", ""),
            ("CUNIT2", "deg", ""),
            ("EQUINOX", 2000.0, ""),
            ("CRPIX1", float(self.crpix[0]), "X of reference pixel"),
            ("CRPIX2", float(self.crpix[1]), "Y of reference pixel"),
            ("CRVAL1", float(self.crval[0]), "RA of reference pixel (deg)"),
            ("CRVAL2", float(self.crval[1]), "DEC of reference pixel (deg)"),
            ("CD1_1", float(self.cd[0, 0]), ""),
            ("CD1_2", float(self.cd[0, 1]), ""),
            ("CD2_1", float(self.cd[1, 0]), ""),
            ("CD2_2", float(self.cd[1, 1]), ""),
            ("PLTSOLVD", True, "Siril internal solve"),
        ]
        for name, m in (("A", self.sip_a), ("B", self.sip_b),
                        ("AP", self.sip_ap), ("BP", self.sip_bp)):
            if m is None:
                continue
            order = m.shape[0] - 1
            cards.append((f"{name}_ORDER", order, ""))
            for i in range(order + 1):
                for j in range(order + 1):
                    if i + j <= order and m[i, j] != 0.0:
                        cards.append((f"{name}_{i}_{j}", float(m[i, j]), ""))
        return cards


def sip_frame(crpix, height: int):
    """(x0, y0, ysign) such that a top-down pixel (x, y) has the SIP
    offsets u = x − x0, v = ysign·(y − y0), and a displacement B(u, v) of
    v moves the top-down row by ysign·B (``pix2world``'s frame; with no
    height, rows are not flipped)."""
    if height:
        return crpix[0] - 1.0, height - crpix[1], -1.0
    return crpix[0] - 1.0, crpix[1] - 1.0, 1.0


def _sip_eval(m: np.ndarray, u, v):
    order = m.shape[0] - 1
    out = 0.0
    for i in range(order + 1):
        for j in range(order + 1 - i):
            if m[i, j] != 0.0:
                out = out + m[i, j] * (u ** i) * (v ** j)
    return out


def _sip_from_header(hdr, prefix, order):
    m = np.zeros((order + 1, order + 1))
    for i in range(order + 1):
        for j in range(order + 1 - i):
            val = hdr.get(f"{prefix}_{i}_{j}")
            if val is not None:
                m[i, j] = float(val)
    return m


def _tan_to_sky(xi_deg, eta_deg, crval):
    """Gnomonic de-projection (standard coords in deg → RA/Dec deg)."""
    xi = np.asarray(xi_deg) * D2R
    eta = np.asarray(eta_deg) * D2R
    ra0 = crval[0] * D2R
    dec0 = crval[1] * D2R
    den = np.cos(dec0) - eta * np.sin(dec0)
    ra = ra0 + np.arctan2(xi, den)
    dec = np.arctan((np.sin(dec0) + eta * np.cos(dec0)) /
                    np.sqrt(xi * xi + den * den))
    return (np.degrees(ra) % 360.0), np.degrees(dec)


def _sky_to_tan(ra_deg, dec_deg, crval):
    """Gnomonic projection → standard coords (deg)."""
    ra = np.asarray(ra_deg) * D2R
    dec = np.asarray(dec_deg) * D2R
    ra0 = crval[0] * D2R
    dec0 = crval[1] * D2R
    cosc = (np.sin(dec0) * np.sin(dec) +
            np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0))
    cosc = np.maximum(cosc, 1e-9)
    xi = np.cos(dec) * np.sin(ra - ra0) / cosc
    eta = (np.cos(dec0) * np.sin(dec) -
           np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc
    return xi * R2D, eta * R2D


# ---------------------------------------------------------------------------
# sexagesimal value object (siril_world_cs.c)
# ---------------------------------------------------------------------------


def parse_ra(s: str) -> float:
    """'12:34:56.7' / '12h34m56s' / degrees → RA degrees."""
    s = s.strip().lower().replace("h", ":").replace("m", ":").replace("s", "")
    if ":" in s:
        parts = [float(p) for p in s.split(":") if p != ""]
        val = parts[0] + (parts[1] if len(parts) > 1 else 0) / 60.0 + \
            (parts[2] if len(parts) > 2 else 0) / 3600.0
        return val * 15.0
    return float(s)


def parse_dec(s: str) -> float:
    s = s.strip().replace("d", ":").replace("'", ":").replace('"', "")
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if ":" in s:
        parts = [float(p) for p in s.split(":") if p != ""]
        val = parts[0] + (parts[1] if len(parts) > 1 else 0) / 60.0 + \
            (parts[2] if len(parts) > 2 else 0) / 3600.0
    else:
        val = float(s)
    return -val if neg else val


def _sexagesimal(value: float, sec_digits: int):
    """Split into (major, minute, second) with carry so seconds never
    render as 60.0 after rounding."""
    total = round(value * 3600.0, sec_digits)
    major = int(total // 3600)
    rem = total - major * 3600
    minute = int(rem // 60)
    sec = rem - minute * 60
    if round(sec, sec_digits) >= 60.0:
        sec = 0.0
        minute += 1
    if minute >= 60:
        minute = 0
        major += 1
    return major, minute, sec


def format_ra(deg: float) -> str:
    # Wrap like the reference (siril_world_cs.c:177-179): fmod into
    # [0,360) before splitting, and wrap hours after the seconds carry so
    # 359.99999 renders as 00:00:00.00, never 24:00:00.00.
    hh, mm, ss = _sexagesimal((deg % 360.0) / 15.0, 2)
    hh %= 24
    return f"{hh:02d}:{mm:02d}:{ss:05.2f}"


def format_dec(deg: float) -> str:
    sign = "-" if deg < 0 else "+"
    dd, mm, ss = _sexagesimal(abs(deg), 1)
    return f"{sign}{dd:02d}:{mm:02d}:{ss:04.1f}"
