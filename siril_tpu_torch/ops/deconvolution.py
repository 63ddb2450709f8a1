"""Deconvolution — counterpart of ``siril_tpu/ops/deconvolution.py``: the
synthetic PSFs of ``makepsf`` (``make_psf``:34, host numpy), the PSF from
stars (``psf_from_stars``:73: the stars from the port's star finder on the
image's device, the patches' medians on the host), the OTF (``_psf_otf``
:107) and the solvers Richardson–Lucy (``richardson_lucy``:119, with TV
regularization, gradient-descent steps and the early stop), Wiener
(``wiener``:187) and split-Bregman TV (``split_bregman_tv``:203).

The solvers are float32 torch FFT loops on ``device`` (CUDA unless
"cpu").  The JAX package's ``while_loop`` becomes a Python loop; its early
stop reads the mean update on the host each iteration only when
``stop_delta`` is set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.stretch import finish, upload

PSF_GAUSSIAN = 0
PSF_MOFFAT = 1
PSF_DISC = 2
PSF_AIRY = 3


# ---------------------------------------------------------------------------
# synthetic PSFs (makepsf)
# ---------------------------------------------------------------------------


def make_psf(kind: int = PSF_GAUSSIAN, size: int = 31, fwhm: float = 5.0,
             beta: float = 2.2, ratio: float = 1.0, angle_deg: float = 0.0,
             diameter: float = 5.0, obstruction: float = 0.0) -> np.ndarray:
    """Synthetic PSF kernel (size×size, normalized to sum 1)."""
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    dx = xx - c
    dy = yy - c
    th = math.radians(angle_deg)
    ca, sa = math.cos(th), math.sin(th)
    u = ca * dx - sa * dy
    v = (sa * dx + ca * dy) / max(ratio, 1e-3)
    r = np.sqrt(u * u + v * v)
    if kind == PSF_GAUSSIAN:
        sigma = fwhm / 2.3548
        k = np.exp(-0.5 * (r / sigma) ** 2)
    elif kind == PSF_MOFFAT:
        alpha = fwhm / (2.0 * math.sqrt(2.0 ** (1.0 / beta) - 1.0))
        k = (1.0 + (r / alpha) ** 2) ** (-beta)
    elif kind == PSF_DISC:
        k = (r <= diameter / 2.0).astype(np.float64)
    elif kind == PSF_AIRY:
        from scipy.special import j1

        x = np.pi * r * (diameter / max(size, 1)) + 1e-12
        airy = (2.0 * j1(x) / x) ** 2
        if obstruction > 0:
            e = obstruction
            airy = ((2.0 * (j1(x) - e * j1(e * x)) / x) ** 2
                    / (1 - e * e) ** 2)
        k = airy
    else:
        raise ValueError(f"unknown PSF kind {kind}")
    k = np.maximum(k, 0.0)
    return (k / k.sum()).astype(np.float32)


def psf_from_stars(img: SirilImage, layer: int = 0, size: int = 31,
                   device: DeviceLike = None) -> np.ndarray:
    """makepsf from detected stars: the median of the recentred patches
    of the 30 brightest unsaturated stars."""
    from siril_tpu_torch.registration.starfinder import detect_stars

    lay = img.host()[min(layer, img.nchans - 1)]
    found = detect_stars(torch.from_numpy(lay).to(resolve_device(device)))
    stars = [s for s in found if not s.has_saturated][:30]
    if not stars:
        raise ValueError("no usable stars for PSF estimation")
    H, W = lay.shape
    half = size // 2
    patches = []
    for s in stars:
        x0, y0 = int(round(s.x0)), int(round(s.y0))
        if x0 - half < 0 or y0 - half < 0 or x0 + half + 1 > W or \
           y0 + half + 1 > H:
            continue
        p = lay[y0 - half:y0 + half + 1,
                x0 - half:x0 + half + 1].astype(np.float64)
        p = p - np.median(p)
        if p.max() > 0:
            patches.append(p / p.max())
    if not patches:
        raise ValueError("no usable star patches")
    k = np.maximum(np.median(np.stack(patches), axis=0), 0.0)
    return (k / k.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def psf_otf(psf: np.ndarray, shape, device) -> torch.Tensor:
    """Zero-padded, centre-shifted real OTF of the kernel (rfft2)."""
    H, W = shape
    kh, kw = psf.shape
    pad = np.zeros((H, W), np.float32)
    pad[:kh, :kw] = psf
    pad = np.roll(pad, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    return torch.fft.rfft2(torch.from_numpy(pad).to(device))


def _gradient(u: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim``: central differences inside,
    one-sided at the ends, spacing 1."""
    n = u.shape[dim]
    mid = (u.narrow(dim, 2, n - 2) - u.narrow(dim, 0, n - 2)) / 2.0
    first = u.narrow(dim, 1, 1) - u.narrow(dim, 0, 1)
    last = u.narrow(dim, n - 1, 1) - u.narrow(dim, n - 2, 1)
    return torch.cat([first, mid, last], dim=dim)


def richardson_lucy_tensor(d: torch.Tensor, psf: np.ndarray,
                           iterations: int = 20, tv_alpha: float = 0.0,
                           multiplicative: bool = True,
                           step: float = 0.0005,
                           stop_delta: float = 0.0) -> torch.Tensor:
    """RL deconvolution of (C, H, W), clipped to [0, 1]."""
    C, H, W = d.shape
    otf = psf_otf(psf, (H, W), d.device)
    otf_c = torch.conj(otf)

    def conv(x, o):
        return torch.fft.irfft2(torch.fft.rfft2(x) * o, s=(H, W))

    def tv_term(u, corr):
        gy = _gradient(u, -2)
        gx = _gradient(u, -1)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
        div = _gradient(gx / mag, -1) + _gradient(gy / mag, -2)
        return corr / torch.clamp_min(1.0 - tv_alpha * div, 0.3)

    x0 = torch.clamp_min(d, 1e-7)
    u = x0
    for _ in range(iterations):
        est = conv(u, otf)
        if multiplicative:
            corr = conv(x0 / torch.clamp_min(est, 1e-7), otf_c)
            if tv_alpha > 0.0:
                corr = tv_term(u, corr)
            nxt = torch.clamp(u * corr, 0.0, 10.0)
        else:
            # gradient descent on the Poisson likelihood
            grad = conv(1.0 - x0 / torch.clamp_min(est, 1e-7), otf_c)
            nxt = torch.clamp(u - step * 65535.0 * grad, 0.0, 10.0)
        if stop_delta > 0.0:
            delta = float(torch.abs(nxt - u).mean())
            u = nxt
            if not delta > stop_delta:
                break
        else:
            u = nxt
    return torch.clamp(u, 0.0, 1.0)


def richardson_lucy(img: SirilImage, psf: np.ndarray, iterations: int = 20,
                    tv_alpha: float = 0.0,
                    multiplicative: bool = True, step: float = 0.0005,
                    stop_delta: float = 0.0,
                    device: DeviceLike = None) -> SirilImage:
    """RL deconvolution (`rl` command): multiplicative updates (default)
    or gradient-descent updates (-gdstep), optional TV regularization,
    and early stopping when the mean update falls to ``stop_delta``
    (-stop)."""
    out = richardson_lucy_tensor(upload(img, device), psf, iterations,
                                 tv_alpha, multiplicative, step, stop_delta)
    return finish(img, out, f"RL deconvolution ({iterations} iters, "
                  f"{'mult' if multiplicative else 'gd'})")


def wiener_tensor(d: torch.Tensor, psf: np.ndarray,
                  alpha: float = 1.0 / 500.0) -> torch.Tensor:
    """X = Y·H*/(|H|²+α), clipped to [0, 1]."""
    C, H, W = d.shape
    otf = psf_otf(psf, (H, W), d.device)
    Xf = torch.fft.rfft2(d) * torch.conj(otf) / (torch.abs(otf) ** 2 + alpha)
    return torch.clamp(torch.fft.irfft2(Xf, s=(H, W)), 0.0, 1.0)


def wiener(img: SirilImage, psf: np.ndarray, alpha: float = 1.0 / 500.0,
           device: DeviceLike = None) -> SirilImage:
    """Wiener deconvolution (deconvolve.cpp:144)."""
    return finish(img, wiener_tensor(upload(img, device), psf, alpha),
                  f"Wiener deconvolution (alpha={alpha:.5f})")


def split_bregman_tensor(d: torch.Tensor, psf: np.ndarray,
                         lam: float = 3000.0,
                         iterations: int = 10) -> torch.Tensor:
    """Split-Bregman TV iteration: x-update in the Fourier domain,
    shrinkage of the gradient field, Bregman update; clipped to [0, 1]."""
    C, H, W = d.shape
    dev = d.device
    otf = psf_otf(psf, (H, W), dev)
    mu = lam
    gamma = mu / 8.0
    dx = np.zeros((H, W), np.float32)
    dx[0, 0], dx[0, -1] = 1.0, -1.0
    dy = np.zeros((H, W), np.float32)
    dy[0, 0], dy[-1, 0] = 1.0, -1.0
    Dx = torch.fft.rfft2(torch.from_numpy(dx).to(dev))
    Dy = torch.fft.rfft2(torch.from_numpy(dy).to(dev))
    denom = (torch.abs(otf) ** 2 * mu
             + gamma * (torch.abs(Dx) ** 2 + torch.abs(Dy) ** 2) + 1e-8)
    Ktb = torch.conj(otf) * torch.fft.rfft2(d) * mu

    def div(px, py):
        return (px - torch.roll(px, 1, -1)) + (py - torch.roll(py, 1, -2))

    u = d
    bx = torch.zeros_like(d)
    by = torch.zeros_like(d)
    for _ in range(iterations):
        sx = (torch.roll(u, -1, -1) - u) + bx
        sy = (torch.roll(u, -1, -2) - u) + by
        mag = torch.sqrt(sx * sx + sy * sy + 1e-12)
        shrink = torch.clamp_min(mag - 1.0 / gamma, 0.0) / mag
        wx = sx * shrink
        wy = sy * shrink
        bx = sx - wx
        by = sy - wy
        rhs = Ktb + gamma * torch.fft.rfft2(-div(wx - bx, wy - by))
        u = torch.fft.irfft2(rhs / denom, s=(H, W))
    return torch.clamp(u, 0.0, 1.0)


def split_bregman_tv(img: SirilImage, psf: np.ndarray, lam: float = 3000.0,
                     iterations: int = 10,
                     device: DeviceLike = None) -> SirilImage:
    """Split-Bregman TV deconvolution (`sb` command, deconvBregman.cpp)."""
    out = split_bregman_tensor(upload(img, device), psf, lam, iterations)
    return finish(img, out, f"Split-Bregman TV deconvolution "
                  f"({iterations} iters)")
