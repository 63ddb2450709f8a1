"""Binary serializers of the sirilpy wire protocol — counterpart of
``siril_tpu/pythonmodule/wire_formats.py``, byte for byte.

Each function packs one block as the reference's ``sirilpy`` client
deserializes it (``python_module/sirilpy/models.py`` / ``connection.py``;
the C producers in ``src/io/siril_pythonmodule.c``).  Every block is in
network byte order except the native ``_SharedMemoryInfo`` struct.  The
port's ``Keywords`` keep fewer fields than the JAX package's: a field it
lacks is packed as the JAX package's default (``_KW_DEFAULTS``)."""

from __future__ import annotations

import struct
from datetime import datetime, timezone
from typing import List, Optional

import numpy as np

FLEN = 71

# FKeywords keyword block (models.py FKeywords._KEYWORD_FORMAT_PARTS)
KEYWORDS_FORMAT = "!" + f"{FLEN}s" * 16 + \
    "ddQQddddddQQ" + "d" * 7 + "qq" + "d" * 9 + "Q" + "d" + "qqqq" + \
    "d" + "qq" + "dd?"

# core FFit block (connection.py get_image format_parts)
CORE_FFIT_FORMAT = "!5qQ3d4Q"

# network-order shm info (connection.py shminfo_format '!Qiiii256s')
NET_SHM_INFO = "!Qiiii256s"

PSFSTAR_FORMAT = "!13d2qdq7d q d8d q 2d"
IMGDATA_FORMAT = "!3qd2q"
REGDATA_FORMAT = "!5dQ9d2Q"
STATS_FORMAT = "!2q12d"
BGSAMPLE_FORMAT = "!6dQ2dQ"
BGSAMPLE_NATIVE_FORMAT = "3dd2dQ2dI"      # SET_BGSAMPLES shm payload
ANALYSIS_FORMAT = f"!dddqdqqqqq{FLEN}s"
SEQ_FORMAT = "!4q3Q4qdQqQq"
DISTO_FORMAT = "!q2d"


def _s(text: Optional[str]) -> bytes:
    return (text or "").encode("utf-8")[:FLEN - 1].ljust(FLEN, b"\0")


def _ts(iso: Optional[str]) -> int:
    """ISO 8601 string → unix timestamp (0 when unset)."""
    if not iso:
        return 0
    try:
        dt = datetime.fromisoformat(str(iso).replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp())
    except ValueError:
        return 0


#: the JAX package's Keywords defaults of the fields the port's lack
_KW_DEFAULTS = dict(lo=0, hi=0, data_max=0.0, data_min=0.0,
                    pixel_size_y=0.0, focname="", centalt=0.0, centaz=0.0,
                    sitelat=0.0, sitelong=0.0, siteelev=0.0, airmass=0.0,
                    iso_speed=0.0, aperture=0.0, set_temp=-999.0, cvf=0.0,
                    focuspos=0, focussz=0, foctemp=-999.0)


class _Kw:
    """A Keywords view that answers the JAX package's defaults."""

    def __init__(self, k):
        self._k = k

    def __getattr__(self, name):
        if hasattr(self._k, name):
            return getattr(self._k, name)
        return _KW_DEFAULTS[name]


def pack_keywords(img) -> bytes:
    """keywords_to_py() equivalent (siril_pythonmodule.c) for a
    SirilImage's Keywords."""
    k = _Kw(img.keywords)
    ra = dec = 0.0
    pltsolvd = False
    if getattr(img, "wcs", None) is not None:
        try:
            ra = float(img.wcs.crval[0])
            dec = float(img.wcs.crval[1])
            pltsolvd = True
        except (AttributeError, TypeError, IndexError):
            pass
    return struct.pack(
        KEYWORDS_FORMAT,
        _s(k.program), _s(k.filename), _s(k.row_order), _s(k.filter),
        _s(k.image_type), _s(k.object), _s(k.instrume), _s(k.telescop),
        _s(k.observer), _s(""), _s(""), _s(k.bayer_pattern),
        _s(k.focname), _s(""), _s(""), _s(""),
        float(k.bscale), float(k.bzero), int(k.lo), int(k.hi),
        0.0, 0.0,                                   # flo, fhi
        float(k.data_max), float(k.data_min),
        float(k.pixel_size_x), float(k.pixel_size_y),
        int(k.binning_x), int(k.binning_y),
        0.0, 0.0,                                   # expstart, expend
        float(k.centalt), float(k.centaz),
        float(k.sitelat), float(k.sitelong), float(k.siteelev),
        int(k.bayer_xoffset), int(k.bayer_yoffset),
        float(k.airmass), float(k.focal_length), float(k.focal_length),
        float(k.iso_speed), float(k.exposure), float(k.aperture),
        float(k.ccd_temp), float(k.set_temp), float(k.livetime),
        max(int(k.stackcnt), 0), float(k.cvf),
        int(k.gain), int(k.offset), int(k.focuspos), int(k.focussz),
        float(k.foctemp), _ts(k.date), _ts(k.date_obs),
        ra, dec, pltsolvd)


def pack_core_ffit(img) -> bytes:
    """The 13-field core block preceding pixel/keyword data."""
    data = img.host()
    c, h, w = data.shape
    bitpix = -32
    return struct.pack(
        CORE_FFIT_FORMAT,
        w, h, c, bitpix, bitpix,
        0,                                          # checksum
        float(data.min()), float(data.max()),
        float((data < 0).mean()),
        0, 0, 0, 0)                                 # top_down/focal/pixel/cm


def pack_stats(st) -> bytes:
    return struct.pack(
        STATS_FORMAT, int(st.total), int(st.ngoodpix), st.mean,
        st.median, st.sigma, st.avgdev, st.mad, st.sqrtbwmv,
        getattr(st, "location", 0.0), getattr(st, "scale", 0.0),
        st.min, st.max, getattr(st, "normvalue", 1.0),
        getattr(st, "bgnoise", 0.0))


def stats14(st) -> List[float]:
    """The 14-double stats block of GET_IMAGE_FILE."""
    if st is None:
        return [0.0] * 14
    return [float(st.total), float(st.ngoodpix), st.mean, st.median,
            st.sigma, st.avgdev, st.mad, st.sqrtbwmv,
            getattr(st, "location", 0.0), getattr(st, "scale", 0.0),
            st.min, st.max, getattr(st, "normvalue", 1.0),
            getattr(st, "bgnoise", 0.0)]


def pack_psfstar(s) -> bytes:
    """fwhm_struct → the client's '!13d2qdq7d q d8d q 2d' block."""
    fwhmx = float(getattr(s, "fwhmx", 0.0))
    fwhmy = float(getattr(s, "fwhmy", 0.0))
    return struct.pack(
        PSFSTAR_FORMAT,
        float(getattr(s, "B", 0.0)), float(getattr(s, "A", 0.0)),
        float(getattr(s, "x0", 0.0)), float(getattr(s, "y0", 0.0)),
        float(getattr(s, "sx", 0.0)), float(getattr(s, "sy", 0.0)),
        fwhmx, fwhmy, 0.0, 0.0,                     # arcsec variants
        float(getattr(s, "angle", 0.0)),
        float(getattr(s, "rmse", 0.0)), 0.0,        # sat
        int(getattr(s, "R", 0)),
        1 if getattr(s, "has_saturated", False) else 0,
        float(getattr(s, "beta", 0.0)),
        int(getattr(s, "profile", 0)),
        float(getattr(s, "x0", 0.0)), float(getattr(s, "y0", 0.0)),
        float(getattr(s, "mag", 0.0)), 0.0,         # Bmag
        999.99, 999.99,                             # s_mag, s_Bmag
        float(getattr(s, "snr", 0.0)),
        0,                                          # phot_is_valid
        0.0,                                        # BV
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,     # uncertainties
        int(getattr(s, "layer", 0)),
        float(getattr(s, "ra", 0.0)), float(getattr(s, "dec", 0.0)))


def pack_imgdata(d: dict) -> bytes:
    return struct.pack(
        IMGDATA_FORMAT, int(d.get("filenum", 0)),
        1 if d.get("incl", True) else 0, _ts(d.get("date_obs")),
        float(d.get("airmass", 0.0)), int(d.get("rx", 0)),
        int(d.get("ry", 0)))


def pack_regdata(r: dict) -> bytes:
    H = np.asarray(r.get("H"), float).reshape(3, 3) \
        if r.get("H") is not None else np.eye(3)
    return struct.pack(
        REGDATA_FORMAT,
        float(r.get("fwhm", 0.0)), float(r.get("weighted_fwhm", 0.0)),
        float(r.get("roundness", 0.0)), float(r.get("quality", 0.0)),
        float(r.get("background_lvl", 0.0)),
        max(int(r.get("number_of_stars", 0)), 0),
        *[float(H[i, j]) for i in range(3) for j in range(3)],
        0, max(int(r.get("number_of_stars", 0)), 0))


def pack_bgsample(s) -> bytes:
    get = s.get if isinstance(s, dict) else \
        (lambda k, d=None: getattr(s, k, d))
    med = get("median", (0.0, 0.0, 0.0))
    pos = get("position", (0.0, 0.0))
    return struct.pack(
        BGSAMPLE_FORMAT, float(med[0]), float(med[1]), float(med[2]),
        float(get("mean", 0.0)), float(get("min", 0.0)),
        float(get("max", 0.0)), int(get("size", 25)),
        float(pos[0]), float(pos[1]), 1 if get("valid", True) else 0)


def unpack_native_bgsamples(buf: bytes) -> List[dict]:
    """SET_BGSAMPLES shm payload: NATIVE-order '3dd2dQ2dI' per sample.
    The client packs ONE '...*N' format string, so native alignment
    pads between repetitions (stride 80, last sample 76 on x86-64)."""
    one = struct.calcsize(BGSAMPLE_NATIVE_FORMAT)
    stride = struct.calcsize(BGSAMPLE_NATIVE_FORMAT * 2) - one
    out = []
    for off in range(0, len(buf) - one + 1, stride):
        v = struct.unpack_from(BGSAMPLE_NATIVE_FORMAT, buf, off)
        out.append({"median": (v[0], v[1], v[2]), "mean": v[3],
                    "min": v[4], "max": v[5], "size": int(v[6]),
                    "position": (v[7], v[8]), "valid": bool(v[9])})
    return out


def pack_analysis(a: dict) -> bytes:
    filt = (a.get("filter") or "").encode("utf-8")[:FLEN].ljust(FLEN, b"\0")
    return struct.pack(
        ANALYSIS_FORMAT, float(a.get("bgnoise", 0.0)),
        float(a.get("fwhm", 0.0)), float(a.get("wfwhm", 0.0)),
        int(a.get("nbstars", 0)), float(a.get("roundness", 0.0)),
        int(a.get("imagetype", 0)), int(a.get("timestamp", 0)),
        int(a.get("channels", 0)), int(a.get("height", 0)),
        int(a.get("width", 0)), filt)


def serialize_polygon(p) -> bytes:
    """models.py Polygon.serialize byte layout."""
    buf = bytearray(struct.pack(
        "!iiI?", int(p["polygon_id"]), len(p["points"]),
        int(p["color"]) & 0xFFFFFFFF, bool(p["fill"])))
    for (x, y) in p["points"]:
        buf += struct.pack("!dd", float(x), float(y))
    legend = p.get("legend")
    if legend:
        lb = legend.encode("utf-8")
        buf += struct.pack("!i", len(lb)) + lb
    else:
        buf += struct.pack("!i", 0)
    return bytes(buf)


def deserialize_polygon(data: bytes):
    """Inverse of serialize_polygon; returns (polygon_dict, rest)."""
    pid, n, color, fill = struct.unpack("!iiI?", data[:13])
    data = data[13:]
    pts = []
    for _ in range(n):
        x, y = struct.unpack("!dd", data[:16])
        pts.append((x, y))
        data = data[16:]
    (llen,) = struct.unpack("!i", data[:4])
    data = data[4:]
    legend = None
    if llen > 0:
        legend = data[:llen].decode("utf-8").rstrip("\0")
        data = data[llen:]
    return {"polygon_id": pid, "points": pts, "color": color,
            "fill": bool(fill), "legend": legend}, data


def deserialize_plotdata(buf: bytes) -> dict:
    """plot.py PlotData.serialize inverse: title/xlabel/ylabel/savename
    (null-terminated) + legend flag + series."""
    def cstr(b):
        i = b.index(b"\0")
        return b[:i].decode("utf-8"), b[i + 1:]

    title, buf = cstr(buf)
    xlabel, buf = cstr(buf)
    ylabel, buf = cstr(buf)
    savename, buf = cstr(buf)
    show_legend = struct.unpack("!?", buf[:1])[0]
    (nseries,) = struct.unpack("!I", buf[1:5])
    buf = buf[5:]
    has_min = struct.unpack("!?", buf[:1])[0]
    buf = buf[1:]
    datamin = None
    if has_min:
        datamin = struct.unpack("!dd", buf[:16])
        buf = buf[16:]
    has_max = struct.unpack("!?", buf[:1])[0]
    buf = buf[1:]
    datamax = None
    if has_max:
        datamax = struct.unpack("!dd", buf[:16])
        buf = buf[16:]
    series = []
    for _ in range(nseries):
        label, buf = cstr(buf)
        with_errors = struct.unpack("!?", buf[:1])[0]
        npts, ptype = struct.unpack("!II", buf[1:9])
        buf = buf[9:]
        step = 32 if with_errors else 16
        xs, ys, nerr, perr = [], [], [], []
        for i in range(npts):
            vals = struct.unpack("!dd" + ("dd" if with_errors else ""),
                                 buf[:step])
            xs.append(vals[0])
            ys.append(vals[1])
            if with_errors:
                nerr.append(vals[2])
                perr.append(vals[3])
            buf = buf[step:]
        series.append({"label": label, "x": xs, "y": ys,
                       "plot_type": ptype,
                       "n_error": nerr if with_errors else None,
                       "p_error": perr if with_errors else None})
    return {"title": title, "xlabel": xlabel, "ylabel": ylabel,
            "savename": savename, "show_legend": show_legend,
            "datamin": datamin, "datamax": datamax, "series": series}
