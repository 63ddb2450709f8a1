"""The extended Bayer demosaics — counterpart of
``siril_tpu/ops/demosaic_ext.py`` (``_sh``:40, ``_masked_bilinear``:51,
``_rb_from_differences``:63, ``_cd_smooth``:71, ``_dir_green``:84, AHD
``_ahd_fn``:106, LMMSE ``_lmmse_fn``:185, DCB ``_dcb_fn``:249, HPHD
``_hphd_fn``:274, IGV ``_igv_fn``:298, AMaZE ``_amaze_fn``:331,
``demosaic_ext``:380).

Each method is the JAX package's whole-image formulation of the
published algorithm (shift-and-select stencils), in eager torch on the
CFA tensor's device:

- AHD: H/V directional greens, homogeneity maps in a YC space, a
  3×3-smoothed ballot (ties to the second-derivative criterion);
- LMMSE: directional colour differences, 9-tap smoothing, a linear
  minimum mean-square-error estimate per direction, blended by inverse
  residual variance;
- DCB: a hard H/V decision, then two colour-difference refinements;
- HPHD: heterogeneity projections, a hard H/V decision;
- IGV: gradient-inverse-weighted green from four directions, two
  refinements;
- AMaZE: derivative-variance weighted H/V colour differences, a clamp to
  the local green envelope and a median-of-3 on the chroma.

R and B come from the colour differences over their CFA sites.  Every
shift clamps at the edge: ``_sh(a, dy, dx)[y, x] = a[clamp(y + dy),
clamp(x + dx)]``.  The result is clipped to [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from siril_tpu_torch.ops.demosaic import _cfa_masks, effective_pattern


def _sh(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[clamp(y + dy), clamp(x + dx)] of an (H, W) plane."""
    h, w = a.shape
    pad = max(abs(dy), abs(dx))
    if pad == 0:
        return a
    ap = F.pad(a[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    return ap[pad + dy: pad + dy + h, pad + dx: pad + dx + w]


_BILINEAR_TAPS = [(0, 0, 4.0), (0, 1, 2.0), (0, -1, 2.0), (1, 0, 2.0),
                  (-1, 0, 2.0), (1, 1, 1.0), (1, -1, 1.0), (-1, 1, 1.0),
                  (-1, -1, 1.0)]


def _tapsum(a: torch.Tensor, taps) -> torch.Tensor:
    """Σ w·_sh(a, dy, dx) in the taps' order."""
    acc = 0
    for dy, dx, wt in taps:
        acc = acc + wt * _sh(a, dy, dx)
    return acc


def _masked_bilinear(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized convolution: the bilinear fill of a masked channel."""
    m = mask.to(x.dtype)
    return _tapsum(x * m, _BILINEAR_TAPS) / torch.clamp(
        _tapsum(m, _BILINEAR_TAPS), min=1e-12)


def _rb_from_differences(x, g, rm, bm):
    """R and B from the bilinear fills of R − G and B − G over their
    sites."""
    r = g + _masked_bilinear((x - g) * rm, rm)
    b = g + _masked_bilinear((x - g) * bm, bm)
    return r, b


def _cd_smooth(x, g, rm, bm):
    """G − X smoothed over each colour's own sites (G − R over R, G − B
    over B)."""
    d = g - x
    return torch.where(rm, _masked_bilinear(d * rm, rm),
                       _masked_bilinear(d * bm, bm))


def _d2h(x):
    return torch.abs(2.0 * x - _sh(x, 0, -2) - _sh(x, 0, 2))


def _d2v(x):
    return torch.abs(2.0 * x - _sh(x, -2, 0) - _sh(x, 2, 0))


def _ha_h(x):
    """(G_w + G_e)/2 + (2X − X_ww − X_ee)/4 (Hamilton–Adams)."""
    return 0.5 * (_sh(x, 0, -1) + _sh(x, 0, 1)) \
        + 0.25 * (2.0 * x - _sh(x, 0, -2) - _sh(x, 0, 2))


def _ha_v(x):
    return 0.5 * (_sh(x, -1, 0) + _sh(x, 1, 0)) \
        + 0.25 * (2.0 * x - _sh(x, -2, 0) - _sh(x, 2, 0))


def _dir_green(x, gm):
    """Directional green candidates (H, V) at the non-green sites."""
    return torch.where(gm, x, _ha_h(x)), torch.where(gm, x, _ha_v(x))


def _refine(x, g, rm, bm, cm, rounds: int = 2):
    """DCB's and IGV's refinement: G at the chroma sites pulled halfway
    to the smoothed colour difference."""
    for _ in range(rounds):
        d = torch.where(cm, g - x, 0.0)
        g = torch.where(cm, x + 0.5 * (d + _cd_smooth(x, g, rm, bm)), g)
    return g


def _ahd(x, rm, gm, bm):
    gh, gv = _dir_green(x, gm)
    rh, bh = _rb_from_differences(x, gh, rm, bm)
    rv, bv = _rb_from_differences(x, gv, rm, bm)

    def yc(r, g, b):
        return 0.25 * (r + 2.0 * g + b), r - g, b - g

    yh, ch1, ch2 = yc(rh, gh, bh)
    yv, cv1, cv2 = yc(rv, gv, bv)
    elh = torch.maximum(torch.abs(yh - _sh(yh, 0, 1)),
                        torch.abs(yh - _sh(yh, 0, -1)))
    elv = torch.maximum(torch.abs(yv - _sh(yv, 1, 0)),
                        torch.abs(yv - _sh(yv, -1, 0)))
    e_l = torch.minimum(elh, elv) + 1e-7

    def cdist2(c1, c2, dy, dx):
        return (c1 - _sh(c1, dy, dx)) ** 2 + (c2 - _sh(c2, dy, dx)) ** 2

    ech = torch.maximum(cdist2(ch1, ch2, 0, 1), cdist2(ch1, ch2, 0, -1))
    ecv = torch.maximum(cdist2(cv1, cv2, 1, 0), cdist2(cv1, cv2, -1, 0))
    e_c = torch.minimum(ech, ecv) + 1e-12

    def homogeneity(yy, c1, c2):
        hom = torch.zeros_like(yy)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            ok = (torch.abs(yy - _sh(yy, dy, dx)) <= e_l) & \
                (cdist2(c1, c2, dy, dx) <= e_c)
            hom = hom + ok.to(yy.dtype)
        return hom

    box = [(dy, dx, 1.0) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    hh = _tapsum(homogeneity(yh, ch1, ch2), box)
    hv = _tapsum(homogeneity(yv, cv1, cv2), box)
    pick_h = torch.where(hh == hv, _d2h(x) <= _d2v(x), hh > hv)
    return (torch.where(pick_h, rh, rv), torch.where(pick_h, gh, gv),
            torch.where(pick_h, bh, bv))


def _lmmse(x, rm, gm, bm):
    cm = rm | bm
    gh, gv = _dir_green(x, gm)
    dh = torch.where(cm, gh - x, x - _ha_h(x))
    dv = torch.where(cm, gv - x, x - _ha_v(x))
    wts = (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0)
    tot = sum(wts)

    def along(a, k, horiz):
        return _sh(a, 0, k) if horiz else _sh(a, k, 0)

    def stats(d, horiz):
        m = sum(wi * along(d, k - 4, horiz) for k, wi in enumerate(wts)) \
            / tot
        r2 = (d - m) ** 2
        var = sum(along(r2, k, horiz) for k in range(-4, 5)) / 9.0
        res = sum(along(r2, k, horiz) for k in range(-1, 2)) / 3.0
        return m, var, res

    mh, vh, nh = stats(dh, True)
    mv, vv, nv = stats(dv, False)
    eh = mh + vh / torch.clamp(vh + nh, min=1e-12) * (dh - mh)
    ev = mv + vv / torch.clamp(vv + nv, min=1e-12) * (dv - mv)
    rh_ = torch.clamp(vh - vh * vh / torch.clamp(vh + nh, min=1e-12),
                      min=1e-12)
    rv_ = torch.clamp(vv - vv * vv / torch.clamp(vv + nv, min=1e-12),
                      min=1e-12)
    wh = rv_ / (rh_ + rv_)
    g = torch.where(cm, x + (wh * eh + (1.0 - wh) * ev), x)
    r, b = _rb_from_differences(x, g, rm, bm)
    return r, g, b


def _dcb(x, rm, gm, bm):
    cm = rm | bm
    gh, gv = _dir_green(x, gm)
    g = torch.where(gm, x, torch.where(_d2h(x) <= _d2v(x), gh, gv))
    g = _refine(x, g, rm, bm, cm)
    r, b = _rb_from_differences(x, g, rm, bm)
    return r, g, b


def _hphd(x, rm, gm, bm):
    d2h = _d2h(x) + torch.abs(_sh(x, 0, -1) - _sh(x, 0, 1))
    d2v = _d2v(x) + torch.abs(_sh(x, -1, 0) - _sh(x, 1, 0))
    ph = sum(_sh(d2h, k, 0) for k in range(-2, 3))
    pv = sum(_sh(d2v, 0, k) for k in range(-2, 3))
    gh, gv = _dir_green(x, gm)
    g = torch.where(gm, x, torch.where(ph <= pv, gh, gv))
    r, b = _rb_from_differences(x, g, rm, bm)
    return r, g, b


def _igv(x, rm, gm, bm):
    cm = rm | bm
    eps = 1e-5

    def wdir(dy, dx):
        return 1.0 / (eps + torch.abs(x - _sh(x, 2 * dy, 2 * dx))
                      + torch.abs(_sh(x, dy, dx) - _sh(x, -dy, -dx)))

    def gdir(dy, dx):
        return _sh(x, dy, dx) + 0.5 * (x - _sh(x, 2 * dy, 2 * dx))

    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))          # E, W, S, N
    ws = [wdir(*d) for d in dirs]
    gs = [gdir(*d) for d in dirs]
    num = ws[0] * gs[0] + ws[1] * gs[1] + ws[2] * gs[2] + ws[3] * gs[3]
    g = torch.where(gm, x, num / (ws[0] + ws[1] + ws[2] + ws[3]))
    g = _refine(x, g, rm, bm, cm)
    r, b = _rb_from_differences(x, g, rm, bm)
    return r, g, b


def _amaze(x, rm, gm, bm):
    cm = rm | bm
    eps = 1e-5
    gh, gv = _dir_green(x, gm)
    dh = torch.where(cm, gh - x, 0.0)
    dv = torch.where(cm, gv - x, 0.0)

    def dirvar(d, horiz):
        a = _sh(d, 0, -2) if horiz else _sh(d, -2, 0)
        c = _sh(d, 0, 2) if horiz else _sh(d, 2, 0)
        m = (d + a + c) / 3.0
        return (d - m) ** 2 + (a - m) ** 2 + (c - m) ** 2

    vh = dirvar(dh, True) + eps
    vv = dirvar(dv, False) + eps
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        vh = vh + _sh(vh, dy, dx)
        vv = vv + _sh(vv, dy, dx)
    wh = vv / (vh + vv)
    g = torch.where(cm, x + (wh * dh + (1.0 - wh) * dv), x)
    n4 = [_sh(g, 0, 1), _sh(g, 0, -1), _sh(g, 1, 0), _sh(g, -1, 0)]
    gmax = torch.maximum(torch.maximum(n4[0], n4[1]),
                         torch.maximum(n4[2], n4[3]))
    gmin = torch.minimum(torch.minimum(n4[0], n4[1]),
                         torch.minimum(n4[2], n4[3]))
    spread = 0.25 * (gmax - gmin)
    over = torch.minimum(torch.maximum(g, gmin - spread), gmax + spread)
    g = torch.where(cm, over, g)
    r, b = _rb_from_differences(x, g, rm, bm)

    def med3(c):
        a1, a3 = _sh(c, 0, -1), _sh(c, 0, 1)
        return torch.minimum(torch.maximum(torch.minimum(a1, c), a3),
                             torch.maximum(a1, c))

    return g + med3(r - g), g, g + med3(b - g)


_METHODS = {"ahd": _ahd, "lmmse": _lmmse, "dcb": _dcb, "hphd": _hphd,
            "igv": _igv, "amaze": _amaze}


def demosaic_ext(cfa: torch.Tensor, pattern: str, method: str
                 ) -> torch.Tensor:
    """One of the extended methods on an (H, W) CFA → (3, H, W), clipped
    to [0, 1]."""
    pat = effective_pattern(pattern)
    rm, gm, bm = _cfa_masks(pat, *cfa.shape, device=cfa.device)
    r, g, b = _METHODS[method](cfa.float(), rm, gm, bm)
    return torch.clamp(torch.stack([r, g, b]), 0.0, 1.0)
