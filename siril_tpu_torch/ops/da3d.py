"""DA3D — counterpart of ``siril_tpu/ops/da3d.py`` (data-adaptive
dual-domain denoising refinement, ``denoise -da3d``): the batched patch
step (``_da3d_fn``:33: regression plane, bilateral weights, guided FFT
shrinkage of 64 × 64 patches), ``da3d`` (:103) and ``da3d_image`` (:151).

The JAX package cuts the patches out and adds the contributions back on
the host with Python loops over the stride-s/2 grid; here both are on the
device: the patches are an ``unfold`` view of the reflect-padded layer and
the contributions are summed back with ``fold`` in float64 (the host's
float64 accumulator), so that the result is the JAX package's up to the
order of those float64 additions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.device import DeviceLike, resolve_device


def da3d_patches(py: torch.Tensor, pg: torch.Tensor, sigma: float, r: int,
                 gamma_r: float, sigma_s: float):
    """py/pg: (P, s, s) noisy/guide patches → (P, s, s) refined
    contributions and (P, s, s) k² weights (DA3D.cpp lines 5-30)."""
    s = py.shape[-1]
    dev = py.device
    d = torch.arange(s, dtype=torch.float32, device=dev) - r
    coord_r = d[:, None].expand(s, s)
    coord_c = d[None, :].expand(s, s)
    spatial = coord_r * coord_r + coord_c * coord_c
    s32 = np.float32(sigma)
    sigma2 = float(s32 * s32)
    g_c = pg[:, r, r][:, None, None]

    def bilateral(g, grs2, ss2):
        return torch.exp(-((g - g_c) ** 2) / grs2 - spatial[None] / (2.0 * ss2))

    def wsum(a):
        return a.sum(dim=(1, 2), keepdim=True)

    # regression plane (lines 8-9): weighted LSQ y ~ a·dr + b·dc
    k_reg = bilateral(pg, float(np.float32(10.0 * gamma_r) * np.float32(
        sigma2)), 2.0 * sigma_s * sigma_s)
    sw = wsum(k_reg)
    # centre the coordinates under the weights for a clean solve
    cr = coord_r - wsum(k_reg * coord_r) / sw
    cc = coord_c - wsum(k_reg * coord_c) / sw
    yc = py - wsum(k_reg * py) / sw
    srr = wsum(k_reg * cr * cr)
    scc = wsum(k_reg * cc * cc)
    src = wsum(k_reg * cr * cc)
    syr = wsum(k_reg * yc * cr)
    syc = wsum(k_reg * yc * cc)
    det = srr * scc - src * src
    # degenerate weight support (k_reg ≈ delta) → no plane
    ok = det > 1e-6 * torch.clamp_min(srr * scc, 1e-12)
    safe = torch.where(ok, det, 1.0)
    a = torch.where(ok, (syr * scc - syc * src) / safe, 0.0)
    b = torch.where(ok, (syc * srr - syr * src) / safe, 0.0)
    plane = a * coord_r[None] + b * coord_c[None]
    y = py - plane                         # line 10
    g = pg - plane                         # line 11

    k = bilateral(g, float(np.float32(gamma_r) * np.float32(sigma2)),
                  sigma_s * sigma_s)       # line 12
    ksum = torch.clamp_min(wsum(k), 1e-12)
    yt = wsum(k * y) / ksum
    gt = wsum(k * g) / ksum
    m_y = k * y + (1.0 - k) * yt           # ModifyPatch (line 18)
    m_g = k * g + (1.0 - k) * gt           # line 19

    yf = torch.fft.fft2(m_y)               # line 20
    gf = torch.fft.fft2(m_g)               # line 21
    sigma_f2 = sigma2 * wsum(k * k)        # line 22
    x = (torch.abs(gf) ** 2) / torch.clamp_min(sigma_f2, 1e-30)
    shrink = torch.exp(-0.8 / torch.clamp_min(x, 1e-30))   # line 23
    shrink[:, 0, 0] = 1.0                                   # DC untouched
    y_hat = torch.fft.ifft2(yf * shrink).real               # line 24

    contrib = (y_hat - (1.0 - k) * yt + plane * k) * k      # lines 25-30
    return contrib, k * k


def da3d(noisy, guide, sigma: float, r: int = 31, sigma_s: float = 14.0,
         gamma_r: float = 0.7, device: DeviceLike = None) -> torch.Tensor:
    """Refine ``guide`` (the first-stage denoise of ``noisy``), one (H, W)
    layer (numpy or torch), on ``device``; returns the refined layer."""
    dev = resolve_device(device)
    s = 1
    while s < 2 * r + 1:
        s *= 2
    y = torch.as_tensor(np.asarray(noisy, np.float32) if isinstance(
        noisy, np.ndarray) else noisy, device=dev).float()
    g = torch.as_tensor(np.asarray(guide, np.float32) if isinstance(
        guide, np.ndarray) else guide, device=dev).float()
    h, w = y.shape
    stride = s // 2
    pad = s                       # margin so every pixel is interior
    # numpy's "reflect" padding as an index map (any pad, even past the
    # layer's size)
    ri = torch.from_numpy(np.pad(np.arange(h), pad, mode="reflect")).to(dev)
    ci = torch.from_numpy(np.pad(np.arange(w), pad, mode="reflect")).to(dev)
    ypad = y[ri][:, ci]
    gpad = g[ri][:, ci]
    hp, wp = ypad.shape
    nr = (hp - s) // stride + 1
    nc = (wp - s) // stride + 1
    py = ypad.unfold(0, s, stride).unfold(1, s, stride).reshape(-1, s, s)
    pg = gpad.unfold(0, s, stride).unfold(1, s, stride).reshape(-1, s, s)
    contrib, wgt = da3d_patches(py, pg, sigma, int(r), float(gamma_r),
                                float(sigma_s))
    # the patches' sums back onto the covered rows and columns
    ch, cw = (nr - 1) * stride + s, (nc - 1) * stride + s

    def fold(p):
        cols = p.double().reshape(nr * nc, s * s).T[None]
        return F.fold(cols, (ch, cw), s, stride=stride)[0, 0]

    acc = torch.zeros(hp, wp, dtype=torch.float64, device=dev)
    wacc = torch.zeros_like(acc)
    acc[:ch, :cw] = fold(contrib)
    wacc[:ch, :cw] = fold(wgt)
    out = torch.where(wacc > 1e-6, acc / torch.clamp_min(wacc, 1e-6),
                      gpad.double())
    return out[pad:pad + h, pad:pad + w].float()


def da3d_image(noisy, guide, sigma: float, device: DeviceLike = None,
               **kw) -> torch.Tensor:
    """(C, H, W) wrapper."""
    return torch.stack([da3d(noisy[c], guide[c], sigma, device=device, **kw)
                        for c in range(noisy.shape[0])])
