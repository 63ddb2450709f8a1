"""RCD (ratio-corrected demosaicing) — counterpart of
``siril_tpu/pallas/rcd.py`` (``_masks``:27, ``demosaic_rcd``:34), which
is whole-image jnp code with no Pallas kernel; here it is eager torch on
the CFA tensor's device.

1. Vertical/horizontal discrimination from box-smoothed squared
   directional Laplacian energies.
2. Green at the R/B sites from four cardinal ratio-corrected estimates
   (the neighbour scaled by the low-passed luminance ratio), blended by
   inverse-gradient weights and then by the discriminator.
3. Chroma in the colour-difference domain: diagonally at the opposite
   chroma sites, then cardinally at the green sites.

The shifts wrap around and read the other way from VNG's:
``_sh(a, dy, dx)[y, x] = a[y + dy, x + dx]``.  The result is clipped
below 0 only (``rcd.py:113``).
"""

from __future__ import annotations

import torch

from siril_tpu_torch.ops.demosaic import _cfa_masks

_EPS = 1e-5


def _sh(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx], wrapping."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))


def _smooth9(a: torch.Tensor) -> torch.Tensor:
    s = a
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1),
                   (-1, -1), (-1, 1), (1, -1), (1, 1)):
        s = s + _sh(a, dy, dx)
    return s / 9.0


def demosaic_rcd(cfa: torch.Tensor, pattern: str) -> torch.Tensor:
    """An (H, W) CFA with the 4-letter ``pattern`` → (3, H, W) RGB."""
    rm, gm, bm = _cfa_masks(pattern, *cfa.shape, device=cfa.device)
    x = cfa.float()
    eps = _EPS

    # 1. direction discrimination
    lap_v = torch.abs(2.0 * x - _sh(x, -2, 0) - _sh(x, 2, 0)) + \
        torch.abs(_sh(x, -1, 0) - _sh(x, 1, 0))
    lap_h = torch.abs(2.0 * x - _sh(x, 0, -2) - _sh(x, 0, 2)) + \
        torch.abs(_sh(x, 0, -1) - _sh(x, 0, 1))
    Vs = _smooth9(lap_v * lap_v)
    Hs = _smooth9(lap_h * lap_h)
    vh = Vs / torch.clamp(Vs + Hs, min=eps)

    # 2. green at R/B sites from ratio-corrected estimates
    lpf = (4.0 * x + 2.0 * (_sh(x, -1, 0) + _sh(x, 1, 0) + _sh(x, 0, -1)
                            + _sh(x, 0, 1))
           + _sh(x, -1, -1) + _sh(x, -1, 1) + _sh(x, 1, -1)
           + _sh(x, 1, 1)) / 12.0

    def ratio_est(dy, dx):
        l2 = _sh(lpf, 2 * dy, 2 * dx)
        corr = (lpf - l2) / torch.clamp(lpf + l2, min=eps)
        return _sh(x, dy, dx) * (1.0 + corr)

    def inv_grad(dy, dx):
        return 1.0 / (eps + torch.abs(_sh(x, 2 * dy, 2 * dx) - x)
                      + torch.abs(_sh(x, dy, dx) - _sh(x, -dy, -dx)))

    gN, gS = ratio_est(-1, 0), ratio_est(1, 0)
    gW, gE = ratio_est(0, -1), ratio_est(0, 1)
    wN, wS = inv_grad(-1, 0), inv_grad(1, 0)
    wW, wE = inv_grad(0, -1), inv_grad(0, 1)
    gV = (wN * gN + wS * gS) / torch.clamp(wN + wS, min=eps)
    gH = (wW * gW + wE * gE) / torch.clamp(wW + wE, min=eps)
    # vh ≈ 1: strong vertical detail, interpolate horizontally
    green = torch.where(gm, x, vh * gH + (1.0 - vh) * gV)

    # 3. chroma in the colour-difference domain
    def chroma(mask):
        d = torch.where(mask, x - green, 0.0)
        m = mask.to(x.dtype)
        diag = ((-1, -1), (-1, 1), (1, -1), (1, 1))
        numd = sum(_sh(d, dy, dx) for dy, dx in diag)
        dend = sum(_sh(m, dy, dx) for dy, dx in diag)
        d1 = torch.where(mask, d, numd / torch.clamp(dend, min=eps))
        m1 = torch.maximum(m, (dend > 0).to(x.dtype))
        dm = d1 * m1
        card = ((-1, 0), (1, 0), (0, -1), (0, 1))
        numc = sum(_sh(dm, dy, dx) for dy, dx in card)
        denc = sum(_sh(m1, dy, dx) for dy, dx in card)
        return torch.where(m1 > 0, d1, numc / torch.clamp(denc, min=eps))

    r = torch.where(rm, x, green + chroma(rm))
    b = torch.where(bm, x, green + chroma(bm))
    return torch.clamp(torch.stack([r, green, b]), min=0.0)
