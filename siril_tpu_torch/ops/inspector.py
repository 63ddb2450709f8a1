"""CCD inspector — counterpart of ``siril_tpu/ops/inspector.py``
(``TiltResult``:19, ``sensor_tilt``:27, ``aberration_inspector``:54,
``fix_xtrans_af``:73, ``intensity_profile``:105, ``save_profile_plot``
:149; reference ``src/algos/ccd-inspector.c``, ``fix_xtrans_af.c`` and
``core/cut.c``).

``tilt`` detects stars on the device and compares the median FWHM of the
four corner quadrants with the centre's; ``inspector`` tiles 3 × 3
panels of the frame; ``fix_xtrans`` scales the autofocus rows of an
X-Trans sensor by three row phases, with exact medians taken on the
device; ``profile`` samples a line bilinearly on the device
(``ops/interp.sample_plane``).  The ``.dat`` file is always written; the
``.png`` companion only where matplotlib is installed.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device

_log = logging.getLogger(__name__)


@dataclass
class TiltResult:
    fwhm_center: float
    fwhm_corners: Tuple[float, float, float, float]   # TL, TR, BL, BR
    tilt_pct: float
    nb_stars: int


def _upload(a: np.ndarray, device: DeviceLike) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        resolve_device(device))


def sensor_tilt(img: SirilImage, layer: int = 0,
                device: DeviceLike = None) -> TiltResult:
    """`tilt`: the median star FWHM of each corner quadrant against the
    centre's; tilt = (max − min) / mean of the corners."""
    from siril_tpu_torch.registration.starfinder import detect_stars

    lay = img.host()[min(layer, img.nchans - 1)]
    H, W = lay.shape
    stars = detect_stars(_upload(lay, device))
    if len(stars) < 10:
        raise ValueError(f"not enough stars for tilt analysis ({len(stars)})")

    def region_fwhm(x0, x1, y0, y1):
        f = [s.fwhmx for s in stars if x0 <= s.x0 < x1 and y0 <= s.y0 < y1]
        return float(np.median(f)) if f else 0.0

    hw, hh = W / 2, H / 2
    corners = (region_fwhm(0, hw, 0, hh), region_fwhm(hw, W, 0, hh),
               region_fwhm(0, hw, hh, H), region_fwhm(hw, W, hh, H))
    center = region_fwhm(W * 0.25, W * 0.75, H * 0.25, H * 0.75)
    valid = [c for c in corners if c > 0]
    tilt = 100.0 * (max(valid) - min(valid)) / np.mean(valid) if valid else 0.0
    _log.info("Tilt: corners TL=%.2f TR=%.2f BL=%.2f BR=%.2f, center=%.2f, "
              "tilt=%.1f%%", *corners, center, tilt)
    return TiltResult(center, corners, tilt, len(stars))


def aberration_inspector(img: SirilImage, panel: int = 200,
                         grid: int = 3) -> SirilImage:
    """`inspector`: a grid × grid mosaic of panels from the corners, the
    edges and the centre."""
    data = img.host()
    C, H, W = data.shape
    p = min(panel, H // grid, W // grid)
    out = np.zeros((C, p * grid, p * grid), np.float32)
    for gy in range(grid):
        for gx in range(grid):
            sy = int((H - p) * gy / (grid - 1)) if grid > 1 else 0
            sx = int((W - p) * gx / (grid - 1)) if grid > 1 else 0
            out[:, gy * p:(gy + 1) * p, gx * p:(gx + 1) * p] = \
                data[:, sy:sy + p, sx:sx + p]
    res = img.copy(data=out)
    res.log_history("Aberration inspector mosaic")
    return res


def fix_xtrans_af(img: SirilImage,
                  af_box: Optional[Tuple[int, int, int, int]] = None,
                  sample_box: Optional[Tuple[int, int, int, int]] = None,
                  device: DeviceLike = None) -> SirilImage:
    """fix_xtrans: scale each of the three row phases of the AF box by the
    ratio of the sample box's median to its own (when within 0.5-2).  The
    sample box overlaps the AF box, so each phase reads the rows the
    earlier ones rescaled, as in the JAX package (views, in place)."""
    from siril_tpu_torch.ops.statistics import median_t

    data = _upload(img.host(), device).clone()
    C, H, W = data.shape
    if af_box is None:
        af_box = (W // 4, H // 4, W // 2, H // 2)
    x, y, w, h = af_box
    sx, sy, sw, sh = sample_box or (max(x - w // 4, 0), max(y - h // 4, 0),
                                    w, h)
    for c in range(C):
        af = data[c, y:y + h, x:x + w]
        sample = data[c, sy:sy + sh, sx:sx + sw]
        for phase in range(3):
            af_rows = af[phase::3]
            s_rows = sample[phase::3]
            if af_rows.numel() and s_rows.numel():
                ratio = median_t(s_rows) / torch.clamp_min(
                    median_t(af_rows), 1e-9)
                if 0.5 < float(ratio) < 2.0:
                    af[phase::3] = torch.clamp(af_rows * ratio, 0, 1)
    out = img.copy(data=np.ascontiguousarray(data.cpu().numpy()))
    out.log_history("Fixed X-Trans AF pixels")
    return out


def intensity_profile(img: SirilImage, p0: Tuple[float, float],
                      p1: Tuple[float, float], layer: Optional[int] = None,
                      width: int = 1, spacing: float = 1.0,
                      arcsec: bool = False,
                      device: DeviceLike = None) -> np.ndarray:
    """`profile` (core/cut.c): bilinear samples along the line p0 → p1
    every ``spacing`` px, averaged across a band ``width`` px wide;
    (n, 1 + C): the distance (in arcsec with ``arcsec`` and a WCS), then
    each channel."""
    from siril_tpu_torch.ops.interp import INTERP_BILINEAR, sample_plane

    dev = resolve_device(device)
    length = np.hypot(p1[0] - p0[0], p1[1] - p0[1])
    n = max(int(length / max(spacing, 1e-6)) + 1, 2)
    t = np.linspace(0.0, 1.0, n)
    xs0 = p0[0] + t * (p1[0] - p0[0])
    ys0 = p0[1] + t * (p1[1] - p0[1])
    if width > 1:
        ux, uy = (p1[0] - p0[0]) / length, (p1[1] - p0[1]) / length
        px, py = -uy, ux
        offs = np.arange(width) - (width - 1) / 2.0
        xs0 = (xs0[None, :] + offs[:, None] * px).ravel()
        ys0 = (ys0[None, :] + offs[:, None] * py).ravel()
    xs = torch.from_numpy(xs0.astype(np.float32)).to(dev)
    ys = torch.from_numpy(ys0.astype(np.float32)).to(dev)
    data = _upload(img.host(), dev)
    chans = range(img.nchans) if layer is None else [layer]
    dist = t * length
    if arcsec and img.wcs is not None:
        dist = dist * img.wcs.pixel_scale_arcsec
    cols = [dist]
    for c in chans:
        v = sample_plane(data[c], ys, xs, INTERP_BILINEAR)
        if width > 1:
            v = v.reshape(width, n).mean(dim=0)
        cols.append(v.cpu().numpy())
    return np.stack(cols, axis=1)


def save_profile_plot(profile: np.ndarray, dat_path: str,
                      png_path: Optional[str] = None,
                      title: str = "Intensity profile") -> None:
    """The ``.dat`` always; the ``.png`` where matplotlib is installed."""
    np.savetxt(dat_path, profile, header="distance " + " ".join(
        f"ch{c}" for c in range(profile.shape[1] - 1)))
    if png_path:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 4.5))
            colors = ["#d62728", "#2ca02c", "#1f77b4"]
            for c in range(1, profile.shape[1]):
                ax.plot(profile[:, 0], profile[:, c],
                        color=colors[(c - 1) % 3], lw=1.0,
                        label=f"channel {c - 1}")
            ax.set_xlabel("distance (px)")
            ax.set_ylabel("intensity")
            ax.set_title(title)
            ax.legend()
            fig.tight_layout()
            fig.savefig(png_path, dpi=110)
            plt.close(fig)
        except ImportError:
            pass
