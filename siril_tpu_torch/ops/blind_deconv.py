"""Blind PSF estimation — counterpart of ``siril_tpu/ops/blind_deconv.py``
(``makepsf blind [-l0|-si] [-multiscale]``): the ℓ0-descent engine
(``_l0_fns``:124, ``estimate_kernel_l0``:180), the spectral-irregularity
engine (``_pr_step_fns``:308, ``estimate_kernel_si``:332) and the dispatch
(``estimate_kernel_blind``:395).

The iterations (the ℓ0 half-quadratic latent update and the
gradient-domain kernel least squares, the HIO / error-reduction phase
retrieval steps) are complex64 torch FFT code on ``device`` (CUDA unless
"cpu"); the bookkeeping — patch search, kernel cleanup with its connected
components, the autocorrelation spectrum, the support radius, the random
restarts from a seeded numpy generator and the candidate scoring — is the
JAX package's host numpy, copied.  The ℓ0 threshold λ/β is a power of two
times λ/λ (β starts at 2λ and doubles), so it is exact in both packages.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# shared helpers (host numpy)
# ---------------------------------------------------------------------------


def _grey(img: np.ndarray) -> np.ndarray:
    """(C,H,W) or (H,W) → grey (H,W), normalized to [0,1]."""
    a = np.asarray(img, np.float32)
    if a.ndim == 3:
        a = a.mean(axis=0)
    lo, hi = float(a.min()), float(a.max())
    if hi > lo:
        a = (a - lo) / (hi - lo)
    return a


def _psf2otf_np(k: np.ndarray, shape) -> np.ndarray:
    h, w = shape
    kh, kw = k.shape
    pad = np.zeros(shape, np.float32)
    pad[:kh, :kw] = k
    pad = np.roll(pad, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    return np.fft.fft2(pad)


def _kernel_cleanup(k: np.ndarray, threshold_max: float = 0.02) -> np.ndarray:
    """Positivity, max-threshold, dominant connected component, centroid
    re-centering, sum normalization (estimate_kernel.hpp:260-300)."""
    k = np.maximum(k, 0.0)
    if k.max() <= 0:
        out = np.zeros_like(k)
        out[k.shape[0] // 2, k.shape[1] // 2] = 1.0
        return out
    k = np.where(k < k.max() * threshold_max, 0.0, k)
    # dominant 8-connected component (flood fill from the max)
    lab = _connected_components(k > 0)
    if lab.max() > 0:
        best = np.argmax([k[lab == i].sum() for i in range(1, lab.max() + 1)]) + 1
        k = np.where(lab == best, k, 0.0)
    # centroid re-center via integer roll
    tot = k.sum()
    if tot > 0:
        ys, xs = np.mgrid[0:k.shape[0], 0:k.shape[1]]
        cy = (ys * k).sum() / tot
        cx = (xs * k).sum() / tot
        k = np.roll(k, (int(round(k.shape[0] / 2 - cy - 0.5)),
                        int(round(k.shape[1] / 2 - cx - 0.5))), axis=(0, 1))
        k = k / k.sum()
    return k.astype(np.float32)


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """Tiny 8-connected labeling (kernel-sized inputs only)."""
    lab = np.zeros(mask.shape, np.int32)
    cur = 0
    for y in range(mask.shape[0]):
        for x in range(mask.shape[1]):
            if mask[y, x] and lab[y, x] == 0:
                cur += 1
                stack = [(y, x)]
                lab[y, x] = cur
                while stack:
                    yy, xx = stack.pop()
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            ny, nx = yy + dy, xx + dx
                            if (0 <= ny < mask.shape[0]
                                    and 0 <= nx < mask.shape[1]
                                    and mask[ny, nx] and lab[ny, nx] == 0):
                                lab[ny, nx] = cur
                                stack.append((ny, nx))
    return lab


# ---------------------------------------------------------------------------
# ℓ0 descent (BLIND_L0)
# ---------------------------------------------------------------------------


def _c64(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as complex64 on ``device`` (``jnp.asarray`` of a
    complex128 array without x64)."""
    return torch.from_numpy(np.asarray(a).astype(np.complex64)).to(device)


@functools.lru_cache(maxsize=16)
def _deriv_otfs(h: int, w: int, device: torch.device):
    """The forward-difference OTFs (circular) and Σ|D|²."""
    dx = np.zeros((h, w), np.float32)
    dx[0, 0] = -1
    dx[0, 1] = 1
    dy = np.zeros((h, w), np.float32)
    dy[0, 0] = -1
    dy[1, 0] = 1
    fdx = _c64(np.fft.fft2(dx), device)
    fdy = _c64(np.fft.fft2(dy), device)
    return fdx, fdy, torch.abs(fdx) ** 2 + torch.abs(fdy) ** 2


def l0_u_update(v: torch.Tensor, k_otf: torch.Tensor, lam: float,
                beta_init: float) -> torch.Tensor:
    """ℓ0 half-quadratic latent update (Algorithm 2): hard-threshold the
    gradient field at λ/β, FFT quadratic solve, β ×2 until 1e5."""
    h, w = v.shape
    fdx, fdy, dtd = _deriv_otfs(h, w, v.device)
    fv = torch.fft.fft2(v)
    ktf = torch.conj(k_otf) * fv
    ktk = torch.abs(k_otf) ** 2
    lam32 = np.float32(lam)
    beta = np.float32(beta_init)
    u = v
    while beta < 1e5:
        fu = torch.fft.fft2(u)
        gx = torch.fft.ifft2(fu * fdx).real
        gy = torch.fft.ifft2(fu * fdy).real
        n2 = gx * gx + gy * gy
        keep = n2 >= float(lam32 / beta)
        gx = torch.where(keep, gx, 0.0)
        gy = torch.where(keep, gy, 0.0)
        adj = torch.fft.fft2(gx) * torch.conj(fdx) + \
            torch.fft.fft2(gy) * torch.conj(fdy)
        num = ktf + float(beta) * adj
        u = torch.fft.ifft2(num / (ktk + float(beta) * dtd)).real
        beta = np.float32(beta * np.float32(2.0))
    return u


def l0_k_update(u: torch.Tensor, v: torch.Tensor, gamma: float,
                ks: int) -> torch.Tensor:
    """Gradient-domain kernel least squares (Algorithm 3), the centre
    ks × ks of the shifted estimate."""
    h, w = v.shape
    fdx, fdy, _ = _deriv_otfs(h, w, v.device)
    fu = torch.fft.fft2(u)
    fv = torch.fft.fft2(v)
    fgux, fguy = fu * fdx, fu * fdy
    fgvx, fgvy = fv * fdx, fv * fdy
    num = torch.conj(fgux) * fgvx + torch.conj(fguy) * fgvy
    den = torch.abs(fgux) ** 2 + torch.abs(fguy) ** 2 + gamma
    otf = torch.fft.fftshift(torch.fft.ifft2(num / den).real)
    top = h // 2 - ks // 2
    left = w // 2 - ks // 2
    return otf[top:top + ks, left:left + ks]


def estimate_kernel_l0(image: np.ndarray, ks: int = 15,
                       lam: float = 1e-3, lam_ratio: float = 0.7,
                       lam_min: float = 1e-4, gamma: float = 20.0,
                       iterations: int = 10, multiscale: bool = False,
                       patch: int = 256,
                       device: DeviceLike = None) -> np.ndarray:
    """ℓ0-descent blind kernel estimation (BLIND_L0,
    deconvolution.c:131/375)."""
    dev = resolve_device(device)
    if ks % 2 == 0:
        ks += 1
    v_full = _grey(image)
    v = _best_patch(v_full, min(patch, min(v_full.shape)))

    scales = [(v, ks)]
    if multiscale:
        sf = 0.5
        vv, kss = v, ks
        while min(vv.shape) * sf > 64 and int(kss * sf) >= 3:
            vv = vv[::2, ::2]
            kss = int(kss * sf)
            kss += (kss + 1) % 2
            scales.append((vv, kss))
    scales = scales[::-1]

    def k_est(u, vs, kss):
        return _kernel_cleanup(l0_k_update(
            torch.from_numpy(np.ascontiguousarray(u)).to(dev),
            torch.from_numpy(np.ascontiguousarray(vs)).to(dev), gamma,
            kss).cpu().numpy())

    k = None
    u = None
    for si_, (vs, kss) in enumerate(scales):
        h, w = vs.shape
        if u is None or u.shape != vs.shape:
            u = vs
        lam_s = lam
        k = k_est(u, vs, kss)
        for i in range(iterations):
            k_otf = _c64(_psf2otf_np(k, (h, w)), dev)
            u = l0_u_update(torch.from_numpy(np.ascontiguousarray(vs)).to(
                dev), k_otf, lam_s, 2.0 * lam_s).cpu().numpy()
            k = k_est(u, vs, kss)
            lam_s = max(lam_s * lam_ratio, lam_min)
        if si_ + 1 < len(scales):
            # upsample the latent image for the next scale
            u = np.kron(u, np.ones((2, 2), np.float32))
            nh, nw = scales[si_ + 1][0].shape
            u = u[:nh, :nw]
            if u.shape != (nh, nw):
                u = np.pad(u, ((0, nh - u.shape[0]), (0, nw - u.shape[1])),
                           mode="edge")
    # resize the final kernel to the requested ks if multiscale ended
    # smaller
    if k.shape[0] != ks:
        kk = np.zeros((ks, ks), np.float32)
        off = ks // 2 - k.shape[0] // 2
        kk[off:off + k.shape[0], off:off + k.shape[1]] = k
        k = kk / max(kk.sum(), 1e-12)
    return k


def _best_patch(v: np.ndarray, size: int) -> np.ndarray:
    """Deterministic high-variance patch search (searchBlurredPatch
    gf_estimate.cpp:38-66 uses random sampling; a strided grid scan is
    equivalent and reproducible)."""
    h, w = v.shape
    size = min(size, h, w)
    best, by, bx = -1.0, 0, 0
    step = max(1, min(h - size, w - size) // 12) if (h > size and w > size) \
        else 1
    for y in range(0, max(h - size, 1), step):
        for x in range(0, max(w - size, 1), step):
            p = v[y:y + size, x:x + size]
            var = float(p.var())
            if var > best:
                best, by, bx = var, y, x
    return np.ascontiguousarray(v[by:by + size, bx:bx + size])


# ---------------------------------------------------------------------------
# spectral irregularities (BLIND_SI)
# ---------------------------------------------------------------------------


def _kernel_spectrum(v: np.ndarray, ks: int) -> Tuple[np.ndarray, int]:
    """Estimate |F(k)| on a (4ks × 4ks) grid from the whitened-image
    autocorrelation: for gradient-sparse content (astro star fields) the
    gradient autocorrelation ≈ kernel autocorrelation on a pedestal of
    image structure; subtract the pedestal value at the kernel-support
    boundary and clip to 0 (the 2D analog of adjustAutocorrelations'
    'subtract mu_theta and clip', gf_estimate.cpp:115-156), then the
    power spectrum is its Fourier transform."""
    n = 4 * ks
    gx = np.diff(v, axis=1, prepend=v[:, :1])
    gy = np.diff(v, axis=0, prepend=v[:1, :])
    f2 = np.abs(np.fft.fft2(gx)) ** 2 + np.abs(np.fft.fft2(gy)) ** 2
    ac_full = np.real(np.fft.ifft2(f2))
    h, w = v.shape
    d = np.arange(-ks, ks + 1)
    dyy, dxx = np.meshgrid(d, d, indexing="ij")
    ac_win = ac_full[dyy % h, dxx % w]
    # pedestal = mean on the boundary ring max(|dy|,|dx|) == ks
    ring = np.maximum(np.abs(dyy), np.abs(dxx)) == ks
    mu = float(ac_win[ring].mean())
    ac_adj = np.maximum(ac_win - mu, 0.0)
    acs = np.zeros((n, n))
    acs[dyy % n, dxx % n] = ac_adj
    ps = np.maximum(np.real(np.fft.fft2(acs)), 0.0)
    ps /= max(ps[0, 0], 1e-30)          # DC = (Σk)² = 1
    return np.sqrt(ps), n


def _support_radius(v: np.ndarray, ks: int) -> int:
    """Kernel support from the first minimum of the whitened image
    autocorrelation (initialSupportEstimation analog, radial)."""
    gx = np.diff(v, axis=1, prepend=v[:, :1])
    ac = np.real(np.fft.ifft2(np.abs(np.fft.fft2(gx)) ** 2))
    prof = ac[0, :2 * ks].copy()
    prof /= max(prof[0], 1e-30)
    i = 1
    while i < len(prof) - 1 and prof[i + 1] < prof[i]:
        i += 1
    return max(2, min(i, ks // 2 + 1))


def _magnitude_projection(g: torch.Tensor, mag: torch.Tensor):
    gf = torch.fft.fft2(g)
    gf = mag * torch.exp(1j * torch.angle(gf))
    return torch.fft.ifft2(gf).real


def pr_step(g: torch.Tensor, mag: torch.Tensor, support: torch.Tensor,
            beta: float) -> torch.Tensor:
    """One HIO iteration with magnitude projection + support /
    nonnegativity object constraint."""
    g2 = _magnitude_projection(g, mag)
    good = (g2 >= 0) & support
    return torch.where(good, g2, g - beta * g2)


def pr_er(g: torch.Tensor, mag: torch.Tensor,
          support: torch.Tensor) -> torch.Tensor:
    """One error-reduction iteration."""
    g2 = _magnitude_projection(g, mag)
    return torch.where((g2 >= 0) & support, g2, 0.0)


def estimate_kernel_si(image: np.ndarray, ks: int = 15,
                       restarts: int = 6, hio_iters: int = 120,
                       er_iters: int = 40, seed: int = 7,
                       patch: int = 256,
                       device: DeviceLike = None) -> np.ndarray:
    """Spectral-irregularity blind kernel estimation (BLIND_SI,
    gf_estimate.cpp gf_kernel Algorithm 1 re-derivation)."""
    dev = resolve_device(device)
    if ks % 2 == 0:
        ks += 1
    v = _grey(image)
    vpatch = _best_patch(v, min(patch, min(v.shape)))
    mag, n = _kernel_spectrum(vpatch, ks)
    rad = _support_radius(vpatch, ks)

    # support mask in the corner (kernel occupies [0:ks, 0:ks] wrapped)
    sup = np.zeros((n, n), bool)
    r = min(max(rad + 2, 3), ks // 2 + 1)
    yy, xx = np.mgrid[0:n, 0:n]
    dy = np.minimum(yy, n - yy)
    dx = np.minimum(xx, n - xx)
    sup[(dy <= r) & (dx <= r)] = True

    mag_t = torch.from_numpy(mag.astype(np.float32)).to(dev)
    sup_t = torch.from_numpy(sup).to(dev)
    rng = np.random.default_rng(seed)

    best_k, best_score = None, np.inf
    for t in range(restarts):
        g0 = rng.random((n, n)).astype(np.float32) * sup
        g = torch.from_numpy(g0.astype(np.float32)).to(dev)
        for _ in range(hio_iters):
            g = pr_step(g, mag_t, sup_t, 0.9)
        for _ in range(er_iters):
            g = pr_er(g, mag_t, sup_t)
        kfull = g.cpu().numpy()
        k = np.fft.fftshift(kfull)[n // 2 - ks // 2: n // 2 + ks // 2 + 1,
                                   n // 2 - ks // 2: n // 2 + ks // 2 + 1]
        for cand in (k, k[::-1, ::-1]):   # autocorrelation flip ambiguity
            ck = _kernel_cleanup(cand.copy(), threshold_max=0.05)
            score = _sparsity_score(vpatch, ck)
            if score < best_score:
                best_score, best_k = score, ck
    return best_k


def _sparsity_score(v: np.ndarray, k: np.ndarray) -> float:
    """ℓ½ gradient sparsity of a quick Wiener deconvolution of the patch
    — the reference's candidate-evaluation criterion (deconvBregman /
    evaluation in gf_estimate)."""
    otf = _psf2otf_np(k, v.shape)
    fv = np.fft.fft2(v)
    x = np.real(np.fft.ifft2(fv * np.conj(otf)
                             / (np.abs(otf) ** 2 + 3e-3)))
    gx = np.diff(x, axis=1)
    gy = np.diff(x, axis=0)
    return float(np.sqrt(np.abs(gx)).sum() + np.sqrt(np.abs(gy)).sum())


def estimate_kernel_blind(image: np.ndarray, ks: int = 15,
                          method: str = "l0", multiscale: bool = False,
                          lam: float = 1e-3,
                          comp: Optional[float] = None,
                          device: DeviceLike = None) -> np.ndarray:
    """makepsf blind dispatch (-l0 default / -si; -multiscale, -lambda=,
    -comp= — comp scales the SI restart budget)."""
    if method == "si":
        restarts = 6 if comp is None else max(2, int(round(6 * comp)))
        return estimate_kernel_si(image, ks, restarts=restarts,
                                  device=device)
    return estimate_kernel_l0(image, ks, lam=lam, multiscale=multiscale,
                              device=device)
