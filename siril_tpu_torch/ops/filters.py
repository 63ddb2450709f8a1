"""Image filters — counterpart of ``siril_tpu/ops/filters.py``: the
gaussian blur (``gaussian_blur_chw``:42, ``gauss``:59), ``unsharp`` (:66),
the median filter (``median_filter``:83), banding removal
(``fix_banding``:114), CLAHE (:151), the edge-preserving filters
(``bilateral``:203, ``_box`` / ``guided_filter``:234-273), the FFT tool
(``fftd`` / ``ffti``:276-316), ``linear_match`` (:319), ``rgradient``
(:350), ``unpurple`` (:393), ``ddp`` (:417) and the threshold family
(:429-466).

The device filters are float32 torch code on ``device`` (CUDA unless
"cpu").  The separable convolutions are shifted multiply-adds, not
``conv2d``: cuDNN rounds a float32 convolution's inputs to TF32 by default
(a 10-bit mantissa), and no op of this module may run under TF32.  The
median filter takes the k² shifted copies of a block of rows at a time,
so that a 4096² RGB image at k = 9 needs about 1 GiB of them, not 16 GB.
The guided filter's box means come from a float64 integral image: the
JAX package's float32 one is up to 3.5e-4 off on a 2048² sky of 0.1
(``scripts/box_departure.py``; ROADMAP §3,
``tests/test_torch_filters.py::test_box_departure``).
CLAHE counts its tiles' histograms and interpolates their tables on the
device (in float64 where numpy promotes, so that it is bit-equal to the
JAX package's host numpy); the tables themselves, banding,
``linear_match``, the threshold family and ``fill`` are host numpy, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.stretch import finish, upload

#: bytes of shifted copies the median filter takes at a time
MEDIAN_BLOCK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# separable convolution (shifted multiply-adds: no TF32)
# ---------------------------------------------------------------------------


def pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    """(C, H, W) padded by r on both sides of H and W, edges replicated."""
    return F.pad(x[None], (r, r, r, r), mode="replicate")[0]


def sep_pass(xp: torch.Tensor, k, dim: int, n: int,
             dil: int = 1) -> torch.Tensor:
    """Σ_j k[j]·xp[…, i + j·dil, …] along ``dim`` for i < n (a VALID
    convolution with the kernel dilated by ``dil``), in float32."""
    acc = None
    for j, kj in enumerate(np.asarray(k, np.float32)):
        s = xp.narrow(dim, j * dil, n)
        acc = s * float(kj) if acc is None else torch.add(acc, s,
                                                          alpha=float(kj))
    return acc


def sep_conv(x: torch.Tensor, k, dil: int = 1) -> torch.Tensor:
    """(C, H, W) convolved by the separable kernel k ⊗ k (dilated by
    ``dil``) over the edge-replicated image: rows first, then columns."""
    H, W = x.shape[-2], x.shape[-1]
    r = (len(k) // 2) * dil
    xp = pad_edge(x, r)
    y = sep_pass(xp, k, 2, W, dil)
    return sep_pass(y, k, 1, H, dil)


# ---------------------------------------------------------------------------
# gaussian blur (rt/gauss.cc equivalent)
# ---------------------------------------------------------------------------


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_chw(data: torch.Tensor, sigma: float) -> torch.Tensor:
    """(C, H, W) → (C, H, W) gaussian blur, edge-replicated (OpenCV
    border), on ``data``'s device."""
    return sep_conv(data.float(), _gauss_kernel1d(sigma))


def gauss(img: SirilImage, sigma: float,
          device: DeviceLike = None) -> SirilImage:
    out = gaussian_blur_chw(upload(img, device), sigma)
    return finish(img, out, f"Gaussian filter (sigma={sigma:.2f})")


def unsharp(img: SirilImage, sigma: float, amount: float,
            device: DeviceLike = None) -> SirilImage:
    """cvUnsharpFilter semantics: amount=0 → pure blur, amount=1 →
    identity, amount>1 → sharpening (out = amount·img + (1−amount)·blur)."""
    d = upload(img, device)
    g = gaussian_blur_chw(d, sigma)
    out = torch.clamp(amount * d + (1.0 - amount) * g, 0.0, 1.0)
    return finish(img, out, f"Unsharp (sigma={sigma:.2f}, "
                  f"amount={amount:.2f})")


# ---------------------------------------------------------------------------
# median filter (filters/median.c)
# ---------------------------------------------------------------------------


def median_blocks(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """The k × k median of every pixel of (C, H, W) over the
    edge-replicated image (k odd: the middle value, as ``jnp.median``),
    a block of rows at a time."""
    C, H, W = x.shape
    r = ksize // 2
    xp = pad_edge(x, r)
    rows = max(1, MEDIAN_BLOCK_BYTES // (ksize * ksize * C * W * 4))
    out = torch.empty_like(x)
    for y0 in range(0, H, rows):
        n = min(rows, H - y0)
        win = xp[:, y0:y0 + n + 2 * r].unfold(1, ksize, 1).unfold(
            2, ksize, 1)                            # (C, n, W, k, k)
        out[:, y0:y0 + n] = win.reshape(C, n, W, ksize * ksize).median(
            -1).values
    return out


def median_filter(img: SirilImage, ksize: int = 3, modulation: float = 1.0,
                  iterations: int = 1,
                  device: DeviceLike = None) -> SirilImage:
    if ksize % 2 == 0:
        raise ValueError("ksize must be odd")
    out = upload(img, device)
    for _ in range(max(iterations, 1)):
        out = modulation * median_blocks(out, ksize) + \
            (1.0 - modulation) * out
    return finish(img, out, f"Median filter ({ksize}x{ksize}, "
                  f"mod={modulation:.2f})")


# ---------------------------------------------------------------------------
# banding (filters/banding.c BandingEngine_float:326) — host numpy
# ---------------------------------------------------------------------------


def fix_banding(img: SirilImage, sigma: float = 1.0, amount: float = 1.0,
                protect_highlights: bool = True,
                vertical: bool = False) -> SirilImage:
    """Row-banding removal: per-row median vs channel background; values
    above bg + mad·MAD_NORM/sigma excluded when protecting highlights."""
    from siril_tpu_torch.ops.statistics import (
        STATS_BASIC,
        STATS_MAD,
        compute_stats_np,
    )

    MAD_NORM = 1.4826
    data = img.host().copy()
    if vertical:
        data = np.ascontiguousarray(np.swapaxes(data, 1, 2))
    C, H, W = data.shape
    for c in range(C):
        st = compute_stats_np(data[c], STATS_BASIC | STATS_MAD)
        background = st.median
        if protect_highlights and sigma > 0:
            reject = background + (1.0 / sigma) * st.mad * MAD_NORM
            masked = np.where(data[c] < reject, data[c], np.nan)
            row_med = np.nanmedian(masked, axis=1)
            row_med = np.where(np.isnan(row_med),
                               np.median(data[c], axis=1), row_med)
        else:
            row_med = np.median(data[c], axis=1)
        fix = (background - row_med) * amount
        data[c] = np.clip(data[c] + fix[:, None], 0.0, 1.0)
    if vertical:
        data = np.ascontiguousarray(np.swapaxes(data, 1, 2))
    res = img.copy(data=data.astype(np.float32))
    res.log_history(f"Canon Banding Reduction (amount={amount:.2f})")
    return res


# ---------------------------------------------------------------------------
# CLAHE (filters/clahe.c — OpenCV CLAHE equivalent)
# ---------------------------------------------------------------------------


def _clahe_luts(counts: np.ndarray, sizes: np.ndarray,
                clip_limit: float) -> np.ndarray:
    """The tiles' mapping tables from their 256-bin histograms (T, T,
    256) and pixel counts (T, T): clipped, the excess spread evenly, the
    normalised cumulative sum (float64 on the host, as the JAX package's
    numpy)."""
    nbins = counts.shape[-1]
    luts = np.zeros(counts.shape, np.float32)
    for i in range(counts.shape[0]):
        for j in range(counts.shape[1]):
            hist = counts[i, j].astype(np.float64)
            n = int(sizes[i, j])
            clip = max(clip_limit * n / nbins, 1.0)
            excess = np.maximum(hist - clip, 0.0).sum()
            hist = np.minimum(hist, clip) + excess / nbins
            luts[i, j] = (np.cumsum(hist) / n).astype(np.float32)
    return luts


def clahe_tensor(d: torch.Tensor, clip_limit: float = 2.0,
                 tile_size: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of (C, H, W),
    OpenCV-style: per-tile clipped histograms (counted on the device) →
    per-tile mapping tables (host) → bilinear interpolation between the
    tables' values (on the device, in float64 as numpy promotes it, then
    float32)."""
    nbins = 256
    T = tile_size
    C, H, W = d.shape
    dev = d.device
    ty = max(H // T, 1)
    tx = max(W // T, 1)
    # the last tile of a row or a column runs to the image's edge
    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)
    tile = (torch.clamp(yy // ty, max=T - 1)[:, None] * T
            + torch.clamp(xx // tx, max=T - 1)[None, :])
    sizes = torch.bincount(tile.reshape(-1), minlength=T * T).cpu().numpy()

    def axis(n, t):
        """The two tables' indices and the weight of the second along an
        axis of n pixels in tiles of t (numpy's float64, uploaded: the
        card divides by a scalar through its reciprocal)."""
        f = (np.arange(n) + 0.5) / t - 0.5
        i0 = np.clip(np.floor(f).astype(int), 0, T - 1)
        w = np.clip(f - i0, 0.0, 1.0)
        return (torch.from_numpy(i0).to(dev),
                torch.from_numpy(np.clip(i0 + 1, 0, T - 1)).to(dev),
                torch.from_numpy(w).to(dev))

    i0, i1, wy = axis(H, ty)
    j0, j1, wx = axis(W, tx)
    wy = wy[:, None]
    wx = wx[None, :]
    out = torch.empty_like(d)
    for c in range(C):
        q = torch.clamp((d[c] * (nbins - 1)).to(torch.int32), 0,
                        nbins - 1).long()
        counts = torch.bincount((tile * nbins + q).reshape(-1),
                                minlength=T * T * nbins)
        luts = torch.from_numpy(_clahe_luts(
            counts.cpu().numpy().reshape(T, T, nbins),
            sizes.reshape(T, T), clip_limit)).to(dev).reshape(-1)

        def v(i, j):
            return luts[(i[:, None] * T + j[None, :]) * nbins + q]

        out[c] = ((1 - wy) * ((1 - wx) * v(i0, j0) + wx * v(i0, j1)) +
                  wy * ((1 - wx) * v(i1, j0) + wx * v(i1, j1))).float()
    return out


def clahe(img: SirilImage, clip_limit: float = 2.0, tile_size: int = 8,
          device: DeviceLike = None) -> SirilImage:
    out = clahe_tensor(upload(img, device), clip_limit, tile_size)
    res = img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history(f"CLAHE (clip={clip_limit:.1f}, tiles={tile_size})")
    return res


# ---------------------------------------------------------------------------
# EPF: bilateral + guided filter (filters/epf.c, opencv/guidedfilter.cpp)
# ---------------------------------------------------------------------------


def bilateral_tensor(x: torch.Tensor, g: torch.Tensor, d: float = 5.0,
                     sigma_col: float = 0.1, sigma_spatial: float = 3.0,
                     mod: float = 1.0) -> torch.Tensor:
    """The bilateral filter of (C, H, W) ``x`` with range weights from
    the guide ``g`` over a (2r+1)² window, r = round(d / 2) (to even, as
    Python rounds), blended with ``x`` by ``mod``."""
    r = max(int(round(d / 2)) if d > 0 else int(3 * sigma_spatial), 1)
    H, W = x.shape[-2], x.shape[-1]
    xp = pad_edge(x, r)
    gp = pad_edge(g, r)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    inv2ss = 1.0 / (2.0 * sigma_spatial * sigma_spatial)
    inv2sc = 1.0 / (2.0 * sigma_col * sigma_col)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            ws = math.exp(-(dy * dy + dx * dx) * inv2ss)
            xs = xp[:, r + dy: r + dy + H, r + dx: r + dx + W]
            gs = gp[:, r + dy: r + dy + H, r + dx: r + dx + W]
            w = ws * torch.exp(-((gs - g) ** 2) * inv2sc)
            num = num + w * xs
            den = den + w
    out = num / torch.clamp_min(den, 1e-9)
    return mod * out + (1.0 - mod) * x


def bilateral(img: SirilImage, d: float = 5.0, sigma_col: float = 0.1,
              sigma_spatial: float = 3.0, mod: float = 1.0,
              guide: Optional[SirilImage] = None,
              device: DeviceLike = None) -> SirilImage:
    x = upload(img, device)
    g = upload(guide, device) if guide is not None else x
    return finish(img, bilateral_tensor(x, g, d, sigma_col, sigma_spatial,
                                        mod), "Bilateral filter")


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """The (2r+1)² mean of every pixel of (C, H, W) over the
    edge-replicated image, from a float64 integral image, in float32."""
    xp = pad_edge(x, r).double()
    c = torch.cumsum(torch.cumsum(xp, dim=1), dim=2)
    c = F.pad(c, (1, 0, 1, 0))
    size = 2 * r + 1
    s = (c[:, size:, size:] - c[:, :-size, size:] -
         c[:, size:, :-size] + c[:, :-size, :-size])
    return (s / (size * size)).float()


def guided_tensor(x: torch.Tensor, g: torch.Tensor, radius: int = 8,
                  eps: float = 1e-3, mod: float = 1.0) -> torch.Tensor:
    """He et al. guided filter of (C, H, W) ``x`` by ``g``, blended by
    ``mod``, clipped to [0, 1]."""
    mean_g = box_mean(g, radius)
    mean_x = box_mean(x, radius)
    corr_gx = box_mean(g * x, radius)
    corr_gg = box_mean(g * g, radius)
    var_g = corr_gg - mean_g * mean_g
    cov_gx = corr_gx - mean_g * mean_x
    a = cov_gx / (var_g + eps)
    b = mean_x - a * mean_g
    out = box_mean(a, radius) * g + box_mean(b, radius)
    return torch.clamp(mod * out + (1.0 - mod) * x, 0.0, 1.0)


def guided_filter(img: SirilImage, radius: int = 8, eps: float = 1e-3,
                  mod: float = 1.0, guide: Optional[SirilImage] = None,
                  device: DeviceLike = None) -> SirilImage:
    """The guided filter (opencv/guidedfilter.cpp equivalent)."""
    x = upload(img, device)
    g = upload(guide, device) if guide is not None else x
    return finish(img, guided_tensor(x, g, radius, eps, mod),
                  "Guided filter")


# ---------------------------------------------------------------------------
# FFT tool (filters/fft.c: fftd/ffti)
# ---------------------------------------------------------------------------


def fftd_tensor(d: torch.Tensor, shifted: bool = True):
    """(normalized modulus, phase in [0, 1], per-layer maxima) of the 2-D
    FFT of (C, H, W)."""
    Fd = torch.fft.fft2(d)
    if shifted:
        Fd = torch.fft.fftshift(Fd, dim=(-2, -1))
    mod = torch.abs(Fd)
    mx = mod.reshape(mod.shape[0], -1).amax(dim=1)[:, None, None]
    modn = mod / torch.clamp_min(mx, 1e-30)
    phase = (torch.angle(Fd) + np.pi) / (2.0 * np.pi)
    return modn, phase, mx


def ffti_tensor(mod: torch.Tensor, phase: torch.Tensor, mx=None,
                shifted: bool = True) -> torch.Tensor:
    """The inverse of ``fftd_tensor``, clipped to [0, 1]."""
    if mx is not None:
        mod = mod * torch.as_tensor(np.asarray(mx, np.float32),
                                    device=mod.device)[:, None, None]
    ph = phase * (2.0 * np.pi) - np.pi
    Fd = torch.polar(mod, ph)
    if shifted:
        Fd = torch.fft.ifftshift(Fd, dim=(-2, -1))
    return torch.clamp(torch.fft.ifft2(Fd).real, 0.0, 1.0)


def fftd(img: SirilImage, shifted: bool = True, device: DeviceLike = None):
    """Decompose into (modulus, phase) images (fftd command)."""
    modn, phase, mx = fftd_tensor(upload(img, device), shifted)
    mimg = img.copy(data=np.ascontiguousarray(modn.cpu().numpy()))
    mimg.keywords.extra["FFTNORM"] = [float(v) for v in
                                      mx.cpu().numpy().ravel()]
    mimg.keywords.extra["FFTSHIFT"] = shifted
    pimg = img.copy(data=np.ascontiguousarray(phase.cpu().numpy()))
    return mimg, pimg


def ffti(mod_img: SirilImage, phase_img: SirilImage,
         device: DeviceLike = None) -> SirilImage:
    mx = mod_img.keywords.extra.get("FFTNORM")
    shifted = bool(mod_img.keywords.extra.get("FFTSHIFT", True))
    out = ffti_tensor(upload(mod_img, device), upload(phase_img, device),
                      mx, shifted)
    res = mod_img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history("Inverse FFT")
    return res


# ---------------------------------------------------------------------------
# linear match (filters/linear_match.c + fitting.c) — host numpy
# ---------------------------------------------------------------------------


def linear_match(img: SirilImage, ref: SirilImage, low: float = 1e-7,
                 high: float = 0.92) -> SirilImage:
    """Per-channel linear fit of image to reference on pixels within
    [low, high] in both images."""
    data = img.host()
    rdata = ref.host()
    out = np.empty_like(data)
    coeffs = []
    for c in range(data.shape[0]):
        x = data[c].ravel()
        y = rdata[min(c, rdata.shape[0] - 1)].ravel()
        m = (x > low) & (x < high) & (y > low) & (y < high)
        if m.sum() < 10:
            out[c] = data[c]
            coeffs.append((1.0, 0.0))
            continue
        A = np.vstack([x[m], np.ones(m.sum())]).T
        (a, b), *_ = np.linalg.lstsq(A, y[m], rcond=None)
        out[c] = np.clip(a * data[c] + b, 0.0, 1.0)
        coeffs.append((float(a), float(b)))
    res = img.copy(data=out.astype(np.float32))
    res.log_history("Linear match: " +
                    ", ".join(f"a={a:.5f} b={b:.5f}" for a, b in coeffs))
    return res


# ---------------------------------------------------------------------------
# rgradient — Larson–Sekanina (filters/rgradient.c:87-180)
# ---------------------------------------------------------------------------


def rgradient_tensor(d: torch.Tensor, xc: float, yc: float, dr: float,
                     da_deg: float) -> torch.Tensor:
    """out = clip(2I − I(r−dR, θ+dα) − I(r−dR, θ−dα)) − min."""
    from siril_tpu_torch.ops.interp import INTERP_BILINEAR, sample_plane

    C, H, W = d.shape
    da = math.radians(da_deg)
    dev = d.device
    px = torch.arange(W, device=dev, dtype=torch.float32)[None, :] - xc
    py = torch.arange(H, device=dev, dtype=torch.float32)[:, None] - yc
    px, py = torch.broadcast_tensors(px, py)
    r = torch.sqrt(px * px + py * py)
    theta = torch.atan2(py, px)

    def coords(dth):
        rr = torch.clamp_min(r - dr, 0.0)
        tt = theta + dth
        return yc + rr * torch.sin(tt), xc + rr * torch.cos(tt)

    sy1, sx1 = coords(da)
    sy2, sx2 = coords(-da)
    outs = []
    for c in range(C):
        a = sample_plane(d[c], sy1, sx1, INTERP_BILINEAR)
        b = sample_plane(d[c], sy2, sx2, INTERP_BILINEAR)
        outs.append(torch.clamp_max(2.0 * d[c] - a - b, 1.0))
    out = torch.stack(outs)
    return torch.clamp(out - out.min(), 0.0, 1.0)


def rgradient(img: SirilImage, xc: float, yc: float, dr: float,
              da_deg: float, device: DeviceLike = None) -> SirilImage:
    out = rgradient_tensor(upload(img, device), xc, yc, dr, da_deg)
    res = img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history(f"RGradient (dR={dr:.1f}, dA={da_deg:.1f})")
    return res


# ---------------------------------------------------------------------------
# unpurple (filters/unpurple.c): purple-fringe removal
# ---------------------------------------------------------------------------


def unpurple_tensor(d: torch.Tensor, blue_threshold: float = 0.2,
                    strength: float = 1.0, star_mask=None) -> torch.Tensor:
    r, g, b = d[0], d[1], d[2]
    # purple fringe: blue strongly exceeding green near bright areas
    fringe = (b > g + blue_threshold) & (r > g * 0.8)
    if star_mask is not None:
        fringe = fringe & torch.as_tensor(np.asarray(star_mask, bool),
                                          device=d.device)
    b2 = torch.where(fringe, g + (b - g) * (1.0 - strength), b)
    return torch.stack([r, g, b2])


def unpurple(img: SirilImage, blue_threshold: float = 0.2,
             strength: float = 1.0, star_mask=None,
             device: DeviceLike = None) -> SirilImage:
    if img.nchans != 3:
        raise ValueError("unpurple requires RGB")
    out = unpurple_tensor(upload(img, device), blue_threshold, strength,
                          star_mask)
    return finish(img, out, "Unpurple")


# ---------------------------------------------------------------------------
# ddp + simple threshold family (command surface helpers)
# ---------------------------------------------------------------------------


def ddp_tensor(d: torch.Tensor, level: float, coef: float,
               sigma: float) -> torch.Tensor:
    """ddp (proto.h:181): out = coef · I / (I_blur + level)."""
    blur = gaussian_blur_chw(d, sigma) if sigma > 0 else d
    return torch.clamp(coef * d / (blur + level), 0.0, 1.0)


def ddp(img: SirilImage, level: float, coef: float, sigma: float,
        device: DeviceLike = None) -> SirilImage:
    out = ddp_tensor(upload(img, device), level, coef, sigma)
    return finish(img, out, f"DDP (level={level:.4f}, coef={coef:.2f})")


def _host_result(img: SirilImage, out: np.ndarray, msg: str) -> SirilImage:
    r = img.copy(data=out)
    r.log_history(msg)
    return r


def threshlo(img: SirilImage, level: float) -> SirilImage:
    return _host_result(img, np.maximum(img.host(), np.float32(level)),
                        f"threshlo {level}")


def threshhi(img: SirilImage, level: float) -> SirilImage:
    return _host_result(img, np.minimum(img.host(), np.float32(level)),
                        f"threshhi {level}")


def thresh(img: SirilImage, lo: float, hi: float) -> SirilImage:
    return _host_result(img, np.clip(img.host(), np.float32(lo),
                                     np.float32(hi)), f"thresh {lo} {hi}")


def nozero(img: SirilImage, level: float) -> SirilImage:
    d = img.host()
    return _host_result(img, np.where(d == 0.0, np.float32(level), d),
                        f"nozero {level}")


def fill(img: SirilImage, level: float, area=None) -> SirilImage:
    d = img.host().copy()
    if area is None:
        d[:] = level
    else:
        x, y, w, h = area
        d[:, y:y + h, x:x + w] = level
    return img.copy(data=d)
