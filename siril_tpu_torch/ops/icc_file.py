"""ICC profile files — counterpart of ``siril_tpu/ops/icc_file.py``
(``bradford_adapt``:35, ``Trc``:54, ``IccProfile``:143, the parser
``read_icc_bytes``:212 and the writer ``write_icc_bytes``:288,
``srgb_profile``:320), host code copied from the JAX package so that both
write the same bytes and each parses the other's.  It fills the lcms2
load / save role of ``src/core/icc_profile.c`` for matrix + TRC display
profiles (ICC.1: the 128-byte header, the tag table, 'XYZ ', 'curv',
'para', 'desc' / 'mluc').  The tone curves that convert pixels run on
the device in ``ops/icc.py``; ``Trc.decode`` / ``encode`` here are the
host versions that sample a table curve's inverse.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

_D50 = np.array([0.9642, 1.0, 0.8249])
_D65 = np.array([0.95047, 1.0, 1.08883])
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614],
                      [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]])


def bradford_adapt(m_src_to_xyz: np.ndarray, white_src: np.ndarray,
                   white_dst: np.ndarray) -> np.ndarray:
    """Chromatic adaptation of an RGB→XYZ matrix between white points."""
    cs = _BRADFORD @ white_src
    cd = _BRADFORD @ white_dst
    adapt = np.linalg.inv(_BRADFORD) @ np.diag(cd / cs) @ _BRADFORD
    return adapt @ m_src_to_xyz


def _s15f16(v: float) -> int:
    return int(round(v * 65536.0)) & 0xFFFFFFFF


def _from_s15f16(u: int) -> float:
    if u >= 0x80000000:
        u -= 0x100000000
    return u / 65536.0


@dataclass
class Trc:
    """Tone reproduction curve: gamma, sampled table, or parametric."""
    kind: str = "gamma"          # gamma | table | para
    gamma: float = 1.0
    table: Optional[np.ndarray] = None       # [0,1] samples
    para_type: int = 0
    para: Tuple[float, ...] = ()

    def _validate(self) -> None:
        """Reject malformed curves with a clean error instead of a
        ZeroDivisionError deep in encode/decode."""
        if self.kind == "gamma" and self.gamma == 0.0:
            raise ValueError("malformed ICC TRC: zero gamma")
        if self.kind == "para":
            g = self.para + (0.0,) * 7
            if g[0] == 0.0:
                raise ValueError("malformed ICC TRC: zero exponent")
            if self.para_type in (1, 2) and g[1] == 0.0:
                raise ValueError("malformed ICC TRC: zero slope")

    def decode(self, x: np.ndarray) -> np.ndarray:
        """Encoded → linear."""
        self._validate()
        x = np.clip(x, 0.0, 1.0)
        if self.kind == "gamma":
            return x ** self.gamma
        if self.kind == "table":
            t = self.table
            pos = np.linspace(0.0, 1.0, len(t))
            return np.interp(x, pos, t)
        g = self.para + (0.0,) * 7
        t = self.para_type
        if t == 0:
            return x ** g[0]
        if t == 1:      # y = (a x + b)^g for x >= -b/a else 0
            a, b = g[1], g[2]
            return np.where(x >= -b / a, np.maximum(a * x + b, 0) ** g[0], 0)
        if t == 2:
            a, b, c = g[1], g[2], g[3]
            return np.where(x >= -b / a,
                            np.maximum(a * x + b, 0) ** g[0] + c, c)
        if t == 3:      # sRGB-style
            a, b, c, d = g[1], g[2], g[3], g[4]
            return np.where(x >= d, np.maximum(a * x + b, 0) ** g[0], c * x)
        if t == 4:
            a, b, c, d, e, f = g[1], g[2], g[3], g[4], g[5], g[6]
            return np.where(x >= d,
                            np.maximum(a * x + b, 0) ** g[0] + e, c * x + f)
        raise ValueError(f"parametric curve type {t}")

    def encode(self, y: np.ndarray) -> np.ndarray:
        """Linear → encoded (analytic inverse for gamma/parametric,
        numerical inverse for sampled tables)."""
        self._validate()
        y = np.clip(y, 0.0, 1.0)
        if self.kind == "gamma":
            return y ** (1.0 / self.gamma)
        if self.kind == "para":
            g = self.para + (0.0,) * 7
            t = self.para_type
            ginv = 1.0 / g[0]
            if t == 0:
                return y ** ginv
            if t == 1:
                a, b = g[1], g[2]
                return (np.maximum(y, 0.0) ** ginv - b) / a
            if t == 2:
                a, b, c = g[1], g[2], g[3]
                return (np.maximum(y - c, 0.0) ** ginv - b) / a
            if t == 3:          # sRGB-style: inverse of the two branches
                a, b, c, d = g[1], g[2], g[3], g[4]
                thr = np.maximum(a * d + b, 0.0) ** g[0]
                return np.where(
                    y >= thr,
                    (np.maximum(y, 0.0) ** ginv - b) / a,
                    y / max(c, 1e-12))
            if t == 4:
                a, b, c, d, e, f = g[1], g[2], g[3], g[4], g[5], g[6]
                thr = np.maximum(a * d + b, 0.0) ** g[0] + e
                return np.where(
                    y >= thr,
                    (np.maximum(y - e, 0.0) ** ginv - b) / a,
                    (y - f) / max(c, 1e-12))
        xs = np.linspace(0.0, 1.0, 4096)
        ys = self.decode(xs)
        order = np.argsort(ys)
        return np.interp(y, ys[order], xs[order])


@dataclass
class IccProfile:
    description: str = "siril_tpu profile"
    color_space: str = "RGB "
    # RGB→XYZ (PCS D50-relative) columns = r/g/b colorants
    matrix: Optional[np.ndarray] = None
    trc: Dict[str, Trc] = field(default_factory=dict)    # 'r','g','b' or 'k'
    white: np.ndarray = field(default_factory=lambda: _D50.copy())
    raw: Optional[bytes] = None       # original file bytes (for embedding)

    @property
    def is_gray(self) -> bool:
        return self.color_space.strip() == "GRAY"

    def matrix_d65(self) -> Optional[np.ndarray]:
        if self.matrix is None:
            return None
        return bradford_adapt(self.matrix, _D50, _D65)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _parse_curv(data: bytes) -> Trc:
    (n,) = struct.unpack(">I", data[8:12])
    if n == 0:
        return Trc("gamma", 1.0)
    if n == 1:
        (g,) = struct.unpack(">H", data[12:14])
        return Trc("gamma", g / 256.0)
    vals = np.frombuffer(data[12:12 + 2 * n], ">u2").astype(np.float64)
    return Trc("table", table=vals / 65535.0)


def _parse_para(data: bytes) -> Trc:
    (ftype,) = struct.unpack(">H", data[8:10])
    nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ftype]
    params = tuple(
        _from_s15f16(struct.unpack(">I", data[12 + 4 * i:16 + 4 * i])[0])
        for i in range(nparams))
    return Trc("para", para_type=ftype, para=params)


def _parse_xyz(data: bytes) -> np.ndarray:
    vals = [_from_s15f16(struct.unpack(">I", data[8 + 4 * i:12 + 4 * i])[0])
            for i in range(3)]
    return np.array(vals)


def _parse_desc(data: bytes) -> str:
    sig = data[:4]
    if sig == b"desc":
        (n,) = struct.unpack(">I", data[8:12])
        return data[12:12 + n].split(b"\0")[0].decode("ascii", "replace")
    if sig == b"mluc":
        (count,) = struct.unpack(">I", data[8:12])
        if count:
            ln, off = struct.unpack(">II", data[20:28])
            return data[off:off + ln].decode("utf-16-be", "replace")
    return ""


def read_icc_bytes(data: bytes) -> IccProfile:
    if len(data) < 132 or data[36:40] != b"acsp":
        raise ValueError("not an ICC profile (missing 'acsp' signature)")
    color_space = data[16:20].decode("ascii", "replace")
    (ntags,) = struct.unpack(">I", data[128:132])
    tags = {}
    for i in range(ntags):
        sig, off, size = struct.unpack(
            ">4sII", data[132 + 12 * i:144 + 12 * i])
        tags[sig.decode("ascii", "replace")] = data[off:off + size]

    prof = IccProfile(color_space=color_space, raw=bytes(data))
    if "desc" in tags:
        prof.description = _parse_desc(tags["desc"]) or prof.description
    if "wtpt" in tags:
        prof.white = _parse_xyz(tags["wtpt"])

    def trc_of(tag):
        d = tags.get(tag)
        if d is None:
            return None
        if d[:4] == b"curv":
            return _parse_curv(d)
        if d[:4] == b"para":
            return _parse_para(d)
        return None

    if all(t in tags for t in ("rXYZ", "gXYZ", "bXYZ")):
        prof.matrix = np.column_stack([_parse_xyz(tags["rXYZ"]),
                                       _parse_xyz(tags["gXYZ"]),
                                       _parse_xyz(tags["bXYZ"])])
        for ch, tag in (("r", "rTRC"), ("g", "gTRC"), ("b", "bTRC")):
            t = trc_of(tag)
            if t:
                prof.trc[ch] = t
    k = trc_of("kTRC")
    if k:
        prof.trc["k"] = k
    return prof


def read_icc(path: str) -> IccProfile:
    with open(path, "rb") as f:
        return read_icc_bytes(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _tag_xyz(v: np.ndarray) -> bytes:
    return b"XYZ " + b"\0" * 4 + b"".join(
        struct.pack(">I", _s15f16(float(x))) for x in v)


def _tag_curv(trc: Trc) -> bytes:
    if trc.kind == "gamma":
        return b"curv" + b"\0" * 4 + struct.pack(">IH", 1,
                                                 int(round(trc.gamma * 256)))
    if trc.kind == "table":
        t = np.clip(np.round(trc.table * 65535.0), 0, 65535).astype(">u2")
        return b"curv" + b"\0" * 4 + struct.pack(">I", len(t)) + t.tobytes()
    # parametric
    body = struct.pack(">HH", trc.para_type, 0)
    body += b"".join(struct.pack(">I", _s15f16(p)) for p in trc.para)
    return b"para" + b"\0" * 4 + body


def _tag_desc(text: str) -> bytes:
    enc = text.encode("ascii", "replace") + b"\0"
    return (b"desc" + b"\0" * 4 + struct.pack(">I", len(enc)) + enc
            + b"\0" * 12 + b"\0" * 67)


def write_icc_bytes(prof: IccProfile) -> bytes:
    tags = [(b"desc", _tag_desc(prof.description)),
            (b"wtpt", _tag_xyz(prof.white))]
    if prof.matrix is not None:
        tags += [(b"rXYZ", _tag_xyz(prof.matrix[:, 0])),
                 (b"gXYZ", _tag_xyz(prof.matrix[:, 1])),
                 (b"bXYZ", _tag_xyz(prof.matrix[:, 2]))]
        for ch, tag in (("r", b"rTRC"), ("g", b"gTRC"), ("b", b"bTRC")):
            tags.append((tag, _tag_curv(prof.trc.get(ch, Trc("gamma", 1.0)))))
    elif "k" in prof.trc:
        tags.append((b"kTRC", _tag_curv(prof.trc["k"])))

    table_size = 4 + 12 * len(tags)
    offset = 128 + table_size
    entries = b""
    body = b""
    for sig, data in tags:
        pad = (-len(data)) % 4
        entries += struct.pack(">4sII", sig, offset, len(data))
        body += data + b"\0" * pad
        offset += len(data) + pad
    total = 128 + table_size + len(body)

    hdr = bytearray(128)
    struct.pack_into(">I", hdr, 0, total)
    hdr[4:8] = b"stpu"                       # CMM id
    struct.pack_into(">I", hdr, 8, 0x04300000)   # version 4.3
    hdr[12:16] = b"mntr"
    hdr[16:20] = prof.color_space.encode("ascii")[:4].ljust(4)
    hdr[20:24] = b"XYZ "
    hdr[36:40] = b"acsp"
    # PCS illuminant = D50
    struct.pack_into(">III", hdr, 68, _s15f16(_D50[0]), _s15f16(_D50[1]),
                     _s15f16(_D50[2]))
    return bytes(hdr) + struct.pack(">I", len(tags)) + entries + body


def write_icc(prof: IccProfile, path: str) -> None:
    with open(path, "wb") as f:
        f.write(write_icc_bytes(prof))


def srgb_profile() -> IccProfile:
    """A real sRGB .icc (D50-adapted primaries + parametric sRGB TRC)."""
    m_d65 = np.array([[0.4124564, 0.3575761, 0.1804375],
                      [0.2126729, 0.7151522, 0.0721750],
                      [0.0193339, 0.1191920, 0.9503041]])
    m = bradford_adapt(m_d65, _D65, _D50)
    trc = Trc("para", para_type=3,
              para=(2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045))
    return IccProfile(description="sRGB (siril_tpu)", matrix=m,
                      trc={"r": trc, "g": trc, "b": trc})
