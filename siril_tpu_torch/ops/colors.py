"""Colour science — counterpart of ``siril_tpu/ops/colors.py``
(src/algos/colors.c): RGB ↔ HSL / HSV / XYZ / CIE L*a*b* (:29-143), SCNR
green-noise removal (``scnr``:146), hue-band saturation
(``saturation``:174), ``negative`` (:203), the 3×3 colour matrix
(``apply_ccm``:212), ``split_channels`` (:229) and ``rgb_compose`` (:259).

The conversions are elementwise float32 torch maps over (H, W) planes, in
the JAX package's operation order; the ops run on ``device`` (CUDA unless
"cpu").  ``satu``'s background threshold comes from the host statistics
of the layers' mean, as in the JAX package.  ``align_rgb_channels``
(:278) registers R and B onto G by the phase correlation of
``registration/shift.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.stretch import finish, upload

# ---------------------------------------------------------------------------
# RGB ↔ HSL / HSV
# ---------------------------------------------------------------------------


def _hue(r, g, b, mx, d):
    dsafe = torch.where(d == 0.0, 1.0, d)
    hr = torch.where(mx == r, (g - b) / dsafe % 6.0, 0.0)
    hg = torch.where((mx == g) & (mx != r), (b - r) / dsafe + 2.0, 0.0)
    hb = torch.where((mx == b) & (mx != r) & (mx != g),
                     (r - g) / dsafe + 4.0, 0.0)
    return hr + hg + hb


def rgb_to_hsl(r, g, b):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    l = 0.5 * (mx + mn)
    d = mx - mn
    s = torch.where(d == 0.0, 0.0,
                    torch.where(l > 0.5,
                                d / torch.clamp_min(2.0 - mx - mn, 1e-30),
                                d / torch.clamp_min(mx + mn, 1e-30)))
    h = _hue(r, g, b, mx, d) / 6.0
    h = torch.where(d == 0.0, 0.0, h % 1.0)
    return h, s, l


def _select(hp, c, x):
    """The sextant choice of hsl_to_rgb / hsv_to_rgb (jnp.select)."""
    z = 0.0 * c
    conds = [hp < 1, hp < 2, hp < 3, hp < 4, hp < 5]

    def pick(choices, default):
        out = default
        for cond, v in zip(reversed(conds), reversed(choices)):
            out = torch.where(cond, v, out)
        return out

    return (pick([c, x, z, z, x], c), pick([x, c, c, x, z], z),
            pick([z, z, x, c, c], x))


def hsl_to_rgb(h, s, l):
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    hp = (h % 1.0) * 6.0
    x = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = l - c / 2.0
    r, g, b = _select(hp, c, x)
    return r + m, g + m, b + m


def rgb_to_hsv(r, g, b):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    s = torch.where(mx == 0.0, 0.0, d / torch.clamp_min(mx, 1e-30))
    h = torch.where(d == 0.0, 0.0, (_hue(r, g, b, mx, d) / 6.0) % 1.0)
    return h, s, mx


def hsv_to_rgb(h, s, v):
    c = v * s
    hp = (h % 1.0) * 6.0
    x = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = v - c
    r, g, b = _select(hp, c, x)
    return r + m, g + m, b + m


# ---------------------------------------------------------------------------
# RGB ↔ XYZ ↔ CIE L*a*b* (D65, linear sRGB)
# ---------------------------------------------------------------------------

_M_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]], np.float32)
_M_XYZ2RGB = np.linalg.inv(_M_RGB2XYZ).astype(np.float32)
_WHITE = np.array([0.95047, 1.0, 1.08883], np.float32)


def _mat3(M, a, b, c):
    f = [[float(v) for v in row] for row in M]
    return tuple(f[i][0] * a + f[i][1] * b + f[i][2] * c for i in range(3))


def rgb_to_xyz(r, g, b):
    return _mat3(_M_RGB2XYZ, r, g, b)


def xyz_to_rgb(x, y, z):
    return _mat3(_M_XYZ2RGB, x, y, z)


def _f_lab(t):
    d = 6.0 / 29.0
    return torch.where(t > d ** 3, _cbrt(t), t / (3 * d * d) + 4.0 / 29.0)


def _cbrt(t):
    """Cube root rounded once to float32 (torch has no cbrt)."""
    return (torch.sign(t) * torch.abs(t.double()) ** (1.0 / 3.0)).float()


def _finv_lab(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t ** 3, 3 * d * d * (t - 4.0 / 29.0))


def xyz_to_lab(x, y, z):
    fx = _f_lab(x / float(_WHITE[0]))
    fy = _f_lab(y / float(_WHITE[1]))
    fz = _f_lab(z / float(_WHITE[2]))
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def lab_to_xyz(L, a, b):
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    return (float(_WHITE[0]) * _finv_lab(fx),
            float(_WHITE[1]) * _finv_lab(fy),
            float(_WHITE[2]) * _finv_lab(fz))


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------


def _rgb(img: SirilImage, what: str):
    if img.nchans != 3:
        raise ValueError(f"{what} requires an RGB image")


def scnr_tensor(d: torch.Tensor, scnr_type: str = "avgneutral",
                amount: float = 1.0,
                preserve_lightness: bool = True) -> torch.Tensor:
    """SCNR of a (3, H, W) tensor: G limited to the average or maximum of
    R and B, the lightness kept in HSL unless ``preserve_lightness`` is
    off; clipped to [0, 1]."""
    r, g, b = d[0], d[1], d[2]
    m = 0.5 * (r + b) if scnr_type in ("avgneutral", "0") else \
        torch.maximum(r, b)
    g2 = torch.minimum(g, m)
    if amount < 1.0:
        g2 = g * (1.0 - amount) + g2 * amount
    if preserve_lightness:
        _, _, l0 = rgb_to_hsl(r, g, b)
        h1, s1, _ = rgb_to_hsl(r, g2, b)
        out = torch.stack(hsl_to_rgb(h1, s1, l0))
    else:
        out = torch.stack([r, g2, b])
    return torch.clamp(out, 0.0, 1.0)


def scnr(img: SirilImage, scnr_type: str = "avgneutral",
         amount: float = 1.0, preserve_lightness: bool = True,
         device: DeviceLike = None) -> SirilImage:
    """SCNR green removal (filters/scnr.c, ``scnr_tensor``)."""
    _rgb(img, "SCNR")
    return finish(img, scnr_tensor(upload(img, device), scnr_type, amount,
                                   preserve_lightness), f"SCNR ({scnr_type})")


def saturation_tensor(d: torch.Tensor, amount: float, thresh: float = 0.0,
                      hue_min: float = 0.0,
                      hue_max: float = 360.0) -> torch.Tensor:
    """The HSL saturation of a (3, H, W) tensor × (1 + amount) where the
    hue is in [hue_min, hue_max] (wrapping) and the lightness above
    ``thresh``; clipped to [0, 1]."""
    h, s, l = rgb_to_hsl(d[0], d[1], d[2])
    hdeg = h * 360.0
    if hue_min <= hue_max:
        in_band = (hdeg >= hue_min) & (hdeg <= hue_max)
    else:
        in_band = (hdeg >= hue_min) | (hdeg <= hue_max)
    apply = in_band & (l > thresh)
    s2 = torch.where(apply, torch.clamp(s * (1.0 + amount), 0.0, 1.0), s)
    return torch.clamp(torch.stack(hsl_to_rgb(h, s2, l)), 0.0, 1.0)


def saturation(img: SirilImage, amount: float,
               background_factor: float = 0.0, hue_min: float = 0.0,
               hue_max: float = 360.0, device: DeviceLike = None
               ) -> SirilImage:
    """``satu`` (filters/saturation.c): ``saturation_tensor`` above
    median + factor·noise of the layers' mean (host statistics)."""
    from siril_tpu_torch.ops.statistics import STATS_BASIC, compute_stats_np

    _rgb(img, "satu")
    thresh = 0.0
    if background_factor > 0.0:
        st = compute_stats_np(img.host().mean(axis=0), STATS_BASIC)
        thresh = st.median + background_factor * st.bgnoise
    out = saturation_tensor(upload(img, device), amount, thresh, hue_min,
                            hue_max)
    return finish(img, out, f"Saturation enhancement ({amount:+.2f})")


def negative(img: SirilImage, device: DeviceLike = None) -> SirilImage:
    """``neg``: 1 − x."""
    return finish(img, 1.0 - upload(img, device), "Negative transformation")


def ccm_tensor(d: torch.Tensor, matrix, gamma: float = 1.0) -> torch.Tensor:
    """A 3×3 colour matrix on a (3, H, W) tensor, then an optional gamma;
    clipped to [0, 1]."""
    M = torch.from_numpy(np.asarray(matrix, np.float32).reshape(3, 3)).to(
        d.device)
    out = (M @ d.reshape(3, -1)).reshape(d.shape)
    if gamma != 1.0:
        out = torch.pow(torch.clamp(out, 0.0, 1.0), 1.0 / gamma)
    return torch.clamp(out, 0.0, 1.0)


def apply_ccm(img: SirilImage, matrix, gamma: float = 1.0,
              device: DeviceLike = None) -> SirilImage:
    """``ccm`` (``ccm_tensor``)."""
    _rgb(img, "ccm")
    return finish(img, ccm_tensor(upload(img, device), matrix, gamma),
                  "Color conversion matrix applied")


def split_channels(img: SirilImage, space: str = "rgb",
                   device: DeviceLike = None):
    """``split``: the RGB, HSL, HSV or Lab planes as three mono images."""
    _rgb(img, "split")
    d = upload(img, device)
    if space == "rgb":
        planes, names = (d[0], d[1], d[2]), ("R", "G", "B")
    elif space == "hsl":
        planes, names = rgb_to_hsl(d[0], d[1], d[2]), ("H", "S", "L")
    elif space == "hsv":
        planes, names = rgb_to_hsv(d[0], d[1], d[2]), ("H", "S", "V")
    elif space == "lab":
        L, a, b = xyz_to_lab(*rgb_to_xyz(d[0], d[1], d[2]))
        planes = (L / 100.0, (a + 128.0) / 255.0, (b + 128.0) / 255.0)
        names = ("L", "a", "b")
    else:
        raise ValueError(f"unknown colorspace {space}")
    out = []
    for p, n in zip(planes, names):
        im = img.copy(data=np.ascontiguousarray(p.cpu().numpy())[None])
        im.keywords.filter = n
        out.append(im)
    return out


def rgb_compose(r: SirilImage, g: SirilImage, b: SirilImage,
                lum: "SirilImage" = None,
                device: DeviceLike = None) -> SirilImage:
    """``rgbcomp``: three mono images as RGB; with ``lum``, the LRGB
    composition (the hue and saturation of RGB, the lightness of the
    luminance layer, in HSL)."""
    data = np.stack([r.host()[0], g.host()[0], b.host()[0]])
    if lum is not None:
        ld = lum.host()
        L = ld[0] if ld.shape[0] == 1 else (0.2126 * ld[0] + 0.7152 * ld[1]
                                            + 0.0722 * ld[2])
        t = upload(r.copy(data=data), device)
        h, sat, _ = rgb_to_hsl(t[0], t[1], t[2])
        lt = torch.from_numpy(np.clip(L, 0.0, 1.0)).to(t.device)
        data = torch.stack(hsl_to_rgb(h, sat, lt)).cpu().numpy()
    out = r.copy(data=np.ascontiguousarray(data, np.float32))
    out.log_history("LRGB composition" if lum is not None
                    else "RGB composition")
    return out


def align_rgb_channels(img: SirilImage,
                       device: DeviceLike = None) -> SirilImage:
    """Compositing channel alignment (src/compositing/align_rgb.c,
    ``siril_tpu/ops/colors.py:278``): R and B registered onto G by phase
    correlation with the parabola's sub-pixel refinement, each shifted
    by the gather warp with bilinear taps unless both of its shifts are
    under 0.05 px, on ``device``.  A mono image is returned as it is."""
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.ops.interp import INTERP_BILINEAR, warp_homography
    from siril_tpu_torch.registration.shift import phase_correlate

    if img.nchans != 3:
        return img
    dev = resolve_device(device)
    data = img.host()
    d = phase_correlate(data[1], np.stack([data[0], data[2]]), device=dev)
    out = data.copy()
    for k, c in enumerate((0, 2)):
        dx, dy = float(d[k][0]), float(d[k][1])
        if abs(dx) < 0.05 and abs(dy) < 0.05:
            continue
        H = np.eye(3)
        H[0, 2], H[1, 2] = dx, dy
        out[c] = warp_homography(torch.from_numpy(data[c][None]).to(dev), H,
                                 (img.height, img.width), INTERP_BILINEAR,
                                 clamp=False)[0].cpu().numpy()
    res = img.copy(data=out)
    res.log_history("RGB channel alignment")
    return res
