"""ICC colour management — counterpart of ``siril_tpu/ops/icc.py``
(``PROFILES``:30, ``_decode_trc``:40, ``_encode_trc``:53,
``assign_profile``:66, ``_builtin_icc``:101, ``remove_profile``:126,
``current_profile_key``:134, ``_profile_transforms``:142,
``convert_to_profile``:191; reference ``src/core/icc_profile.c``).

The built-in working profiles (sRGB, linear sRGB, Rec2020, grayscale) are
matrix + TRC transforms; a ``.icc`` file goes through ``ops/icc_file``'s
parser, and the raw bytes travel with the image (``SirilImage
.icc_profile``, the FITS ``ICCProfile`` extension).  ``icc_convert_to``
decodes, converts through XYZ (D65) and encodes in float64 on the
device, with ``torch.linalg.solve`` for the 3 × 3 system, as the JAX
package does in numpy.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device

# RGB→XYZ matrices (D65)
_SRGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                      [0.2126729, 0.7151522, 0.0721750],
                      [0.0193339, 0.1191920, 0.9503041]])
_REC2020toXYZ = np.array([[0.636958, 0.144617, 0.168881],
                          [0.262700, 0.677998, 0.059302],
                          [0.000000, 0.028073, 1.060985]])

PROFILES = {
    "srgb": ("sRGB", _SRGB2XYZ, "srgb"),
    "srgblinear": ("Linear sRGB", _SRGB2XYZ, "linear"),
    "rec2020": ("Rec2020", _REC2020toXYZ, "rec2020"),
    "rec2020linear": ("Linear Rec2020", _REC2020toXYZ, "linear"),
    "graysrgb": ("Gray sRGB-TRC", None, "srgb"),
    "graylinear": ("Gray linear", None, "linear"),
}

_REC_A, _REC_B = 1.09929682680944, 0.018053968510807


def decode_trc(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A built-in curve, encoded → linear (float64)."""
    if kind == "linear":
        return x
    if kind == "srgb":
        return torch.where(x <= 0.04045, x / 12.92,
                           ((x + 0.055) / 1.055) ** 2.4)
    if kind == "rec2020":
        return torch.where(x < _REC_B * 4.5, x / 4.5,
                           ((x + _REC_A - 1) / _REC_A) ** (1 / 0.45))
    raise ValueError(kind)


def encode_trc(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A built-in curve, linear → encoded (float64), clipped to [0, 1]
    first."""
    x = torch.clamp(x, 0.0, 1.0)
    if kind == "linear":
        return x
    if kind == "srgb":
        return torch.where(x <= 0.0031308, 12.92 * x,
                           1.055 * x ** (1 / 2.4) - 0.055)
    if kind == "rec2020":
        return torch.where(x < _REC_B, 4.5 * x,
                           _REC_A * x ** 0.45 - (_REC_A - 1))
    raise ValueError(kind)


def _pos(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def _interp64(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """``np.interp`` in float64 on ``x``'s device: slope·(x − xp[j]) +
    fp[j] on [xp[j], xp[j+1]), fp[0] / fp[-1] outside."""
    xp = torch.as_tensor(np.asarray(xp, np.float64), device=x.device)
    fp = torch.as_tensor(np.asarray(fp, np.float64), device=x.device)
    j = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1,
                    0, xp.numel() - 2)
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    f = slope * (x - xp[j]) + fp[j]
    f = torch.where(x >= xp[-1], fp[-1], f)
    return torch.where(x < xp[0], fp[0], f)


def trc_decode(trc, x: torch.Tensor) -> torch.Tensor:
    """``Trc.decode`` (icc_file.py:81) on a float64 tensor."""
    trc._validate()
    x = torch.clamp(x, 0.0, 1.0)
    if trc.kind == "gamma":
        return x ** trc.gamma
    if trc.kind == "table":
        pos = np.linspace(0.0, 1.0, len(trc.table))
        return _interp64(x, pos, trc.table)
    g = trc.para + (0.0,) * 7
    t = trc.para_type
    if t == 0:
        return x ** g[0]
    if t == 1:
        a, b = g[1], g[2]
        return torch.where(x >= -b / a, _pos(a * x + b) ** g[0], 0.0)
    if t == 2:
        a, b, c = g[1], g[2], g[3]
        return torch.where(x >= -b / a, _pos(a * x + b) ** g[0] + c, c)
    if t == 3:
        a, b, c, d = g[1], g[2], g[3], g[4]
        return torch.where(x >= d, _pos(a * x + b) ** g[0], c * x)
    if t == 4:
        a, b, c, d, e, f = g[1], g[2], g[3], g[4], g[5], g[6]
        return torch.where(x >= d, _pos(a * x + b) ** g[0] + e,
                           c * x + f)
    raise ValueError(f"parametric curve type {t}")


def trc_encode(trc, y: torch.Tensor) -> torch.Tensor:
    """``Trc.encode`` (icc_file.py:110) on a float64 tensor: the analytic
    inverse of a gamma or parametric curve, a table's by interpolation in
    its sampled inverse."""
    trc._validate()
    y = torch.clamp(y, 0.0, 1.0)
    if trc.kind == "gamma":
        return y ** (1.0 / trc.gamma)
    if trc.kind == "para":
        g = trc.para + (0.0,) * 7
        t = trc.para_type
        ginv = 1.0 / g[0]
        if t == 0:
            return y ** ginv
        if t == 1:
            a, b = g[1], g[2]
            return (_pos(y) ** ginv - b) / a
        if t == 2:
            a, b, c = g[1], g[2], g[3]
            return (_pos(y - c) ** ginv - b) / a
        if t == 3:
            a, b, c, d = g[1], g[2], g[3], g[4]
            thr = max(a * d + b, 0.0) ** g[0]
            return torch.where(y >= thr, (_pos(y) ** ginv - b) / a,
                               y / max(c, 1e-12))
        if t == 4:
            a, b, c, d, e, f = g[1], g[2], g[3], g[4], g[5], g[6]
            thr = max(a * d + b, 0.0) ** g[0] + e
            return torch.where(y >= thr, (_pos(y - e) ** ginv - b) / a,
                               (y - f) / max(c, 1e-12))
    xs = np.linspace(0.0, 1.0, 4096)
    ys = trc.decode(xs)
    order = np.argsort(ys)
    return _interp64(y, ys[order], xs[order])


def assign_profile(img: SirilImage, profile: str) -> SirilImage:
    """icc_assign: tag without converting pixels; ``profile`` is a
    built-in name or a ``.icc`` / ``.icm`` file, whose bytes the image
    carries (built-ins carry generated bytes)."""
    if profile.lower().endswith((".icc", ".icm")) or os.path.exists(profile):
        from siril_tpu_torch.ops.icc_file import read_icc

        prof = read_icc(profile)
        out = img.copy()
        out.icc_profile = prof.raw
        out.keywords.extra["ICCPROF"] = prof.description
        out.log_history(f"Assigned ICC profile {prof.description}")
        return out
    key = profile.lower().replace("-", "").replace("_", "")
    if key not in PROFILES:
        raise ValueError(f"unknown profile '{profile}' "
                         f"(available: {', '.join(PROFILES)}, or a .icc "
                         "file path)")
    out = img.copy()
    out.keywords.extra["ICCPROF"] = PROFILES[key][0]
    from siril_tpu_torch.ops.icc_file import write_icc_bytes

    out.icc_profile = write_icc_bytes(_builtin_icc(key))
    out.log_history(f"Assigned ICC profile {PROFILES[key][0]}")
    return out


def _builtin_icc(key: str):
    """IccProfile object for a built-in matrix + TRC profile."""
    from siril_tpu_torch.ops.icc_file import (
        _D50,
        _D65,
        IccProfile,
        Trc,
        bradford_adapt,
    )

    name, m, trc_kind = PROFILES[key]
    if trc_kind == "srgb":
        trc = Trc("para", para_type=3,
                  para=(2.4, 1.0 / 1.055, 0.055 / 1.055,
                        1.0 / 12.92, 0.04045))
    elif trc_kind == "rec2020":
        a, b = _REC_A, _REC_B
        trc = Trc("para", para_type=3,
                  para=(1.0 / 0.45, 1.0 / a, (a - 1.0) / a, 1.0 / 4.5,
                        b * 4.5))
    else:
        trc = Trc("gamma", 1.0)
    if m is None:
        return IccProfile(description=name, color_space="GRAY",
                          trc={"k": trc})
    m50 = bradford_adapt(np.asarray(m), _D65, _D50)
    return IccProfile(description=name, matrix=m50,
                      trc={"r": trc, "g": trc, "b": trc})


def remove_profile(img: SirilImage) -> SirilImage:
    out = img.copy()
    out.keywords.extra.pop("ICCPROF", None)
    out.icc_profile = None
    out.log_history("Removed ICC profile")
    return out


def current_profile_key(img: SirilImage) -> str:
    name = str(img.keywords.extra.get("ICCPROF", "sRGB"))
    for k, (n, _, _) in PROFILES.items():
        if n.lower() == name.lower():
            return k
    return "srgb"


def _per_channel(fn_of: Callable, x: torch.Tensor) -> torch.Tensor:
    return torch.stack([fn_of(c, x.shape[0])(x[c])
                        for c in range(x.shape[0])])


def profile_transforms(img: SirilImage, spec: str):
    """(decode to linear D65, encode from linear D65, RGB→XYZ matrix or
    None, name, raw bytes or None) of a built-in name, a ``.icc`` path,
    or the image's embedded profile ('')."""
    if spec == "" and img.icc_profile:
        from siril_tpu_torch.ops.icc_file import read_icc_bytes

        prof = read_icc_bytes(img.icc_profile)
    elif spec.lower().endswith((".icc", ".icm")) or \
            (spec and os.path.exists(spec)):
        from siril_tpu_torch.ops.icc_file import read_icc

        prof = read_icc(spec)
    else:
        key = (spec or "srgb").lower().replace("-", "").replace("_", "")
        if key not in PROFILES:
            raise ValueError(f"unknown profile '{spec}'")
        name, m, trc_kind = PROFILES[key]
        return (lambda x: decode_trc(x, trc_kind),
                lambda x: encode_trc(x, trc_kind),
                None if m is None else np.asarray(m), name, None)

    trcs = prof.trc
    if prof.is_gray or prof.matrix is None:
        t = trcs.get("k") or next(iter(trcs.values()), None)
        dec = (lambda x: trc_decode(t, x)) if t else (lambda x: x)
        enc = (lambda x: trc_encode(t, x)) if t else (lambda x: x)
        return dec, enc, None, prof.description, prof.raw

    def chan_trc(c, nchans):
        # mono data under an RGB profile uses the r-curve
        return trcs.get("rgb"[c] if nchans >= 3 else "r") or trcs.get("k")

    def curve(fn):
        def of(c, nchans):
            t = chan_trc(c, nchans)
            return (lambda x: fn(t, x)) if t else (lambda x: x)
        return of

    return (lambda x: _per_channel(curve(trc_decode), x),
            lambda x: _per_channel(curve(trc_encode), x),
            prof.matrix_d65(), prof.description, prof.raw)


def convert_tensor(data: torch.Tensor, img: SirilImage, dest: str):
    """(converted float64 (C, H, W), destination name, its raw bytes or
    None): decode with the image's profile, through XYZ when the
    matrices differ, encode with ``dest``'s."""
    src_spec = "" if img.icc_profile else current_profile_key(img)
    dec_src, _, m_src, _, _ = profile_transforms(img, src_spec)
    _, enc_dst, m_dst, dst_name, raw_dst = profile_transforms(img, dest)
    lin = dec_src(data)
    # same-primary profiles compare equal within the s15f16 quantization
    # and the Bradford round trip (icc.py:202-204)
    if data.shape[0] == 3 and m_src is not None and m_dst is not None and \
            not np.allclose(m_src, m_dst, atol=5e-4):
        dev = data.device
        xyz = torch.from_numpy(np.asarray(m_src, np.float64)).to(dev) @ \
            lin.reshape(3, -1)
        lin = torch.linalg.solve(
            torch.from_numpy(np.asarray(m_dst, np.float64)).to(dev),
            xyz).reshape(lin.shape)
    return enc_dst(torch.clamp(lin, 0.0, 1.0)), dst_name, raw_dst


def convert_to_profile(img: SirilImage, dest: str,
                       device: DeviceLike = None) -> SirilImage:
    """icc_convert_to: convert the pixels between profiles (built-in
    names or ``.icc`` files; the embedded profile is the source when
    present) in float64 on ``device``."""
    data = torch.from_numpy(img.host()).to(resolve_device(device)).double()
    out_d, dst_name, raw_dst = convert_tensor(data, img, dest)
    out = img.copy(data=np.ascontiguousarray(out_d.float().cpu().numpy()))
    out.keywords.extra["ICCPROF"] = dst_name
    if raw_dst is not None:
        out.icc_profile = raw_dst
    else:
        dst_key = dest.lower().replace("-", "").replace("_", "")
        if dst_key in PROFILES:
            from siril_tpu_torch.ops.icc_file import write_icc_bytes

            out.icc_profile = write_icc_bytes(_builtin_icc(dst_key))
    out.log_history(f"Converted to ICC profile {dst_name}")
    return out
