"""Histogram stretches — counterpart of ``siril_tpu/ops/stretch.py``: the
midtones transfer function and autostretch (``mtf``:40,
``mtf_pseudoinverse``:53, ``find_linked_midtones_balance``:73,
``find_unlinked_midtones_balance``:111, ``apply_mtf``:135,
``autostretch``:150; src/filters/mtf.c), the generalized hyperbolic
stretches (``ght_setup``:198, ``ght``:400, ``apply_ght``:461; ght.c), the
asinh stretch (``asinh_stretch``:494; asinh.c), ``linstretch`` (:535) and
curves (``apply_curve``:540; curve_transform.c).

The transfer functions are elementwise float32 torch code on ``device``
(CUDA unless "cpu"), in the JAX package's operation order.  Their
coefficients are Python floats computed on the host in float64
(``ght_setup``); applied to a float32 tensor they round to float32 once,
as JAX's weakly typed scalars do, so that a pixel takes the same branch of
``ght``'s nested ``where`` in both packages.  The parameter finders read
the host statistics (``ops/statistics.compute_stats_np``).  torch has no
``interp``: ``interp`` here is ``jnp.interp``'s formula (clamped ends,
``searchsorted`` on the grid, a linear blend).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.statistics import (
    STATS_MAD,
    compute_stats_np,
    per_layer,
)

AS_DEFAULT_SHADOWS_CLIPPING = -2.80   # mtf.h:12
AS_DEFAULT_TARGET_BACKGROUND = 0.25   # mtf.h:13
MAD_NORM = 1.4826


def upload(img: SirilImage, device: DeviceLike) -> torch.Tensor:
    """The image's pixels as a float32 tensor on ``device``."""
    return torch.from_numpy(img.host()).to(resolve_device(device))


def finish(img: SirilImage, out: torch.Tensor, msg: str) -> SirilImage:
    """A copy of ``img`` holding ``out`` blended through the image's mask,
    fetched to the host, with ``msg`` in its history."""
    res = img.copy(data=np.ascontiguousarray(
        img.apply_mask_blend(out).cpu().numpy()))
    res.log_history(msg)
    return res


def interp(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` on ``x``'s device: fp[0] left of the
    grid, fp[-1] right of it, else fp[i−1] + (x − xp[i−1])/dx·df."""
    xp = torch.as_tensor(np.asarray(xp, np.float32), device=x.device)
    fp = torch.as_tensor(np.asarray(fp, np.float32), device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


# ---------------------------------------------------------------------------
# MTF (mtf.c:118-138, 298-364)
# ---------------------------------------------------------------------------


@dataclass
class MTFParams:
    shadows: float = 0.0
    midtones: float = 0.2
    highlights: float = 1.0


def mtf(x: torch.Tensor, m: float, lo: float, hi: float) -> torch.Tensor:
    """MTF (mtf.c:125): 0 at or below ``lo``, 1 at or above ``hi``, the
    midtones transfer of the rescaled value between."""
    xr = (x - lo) / max(hi - lo, 1e-30)
    num = (m - 1.0) * xr
    den = (2.0 * m - 1.0) * xr - m
    y = num / torch.where(den == 0, 1e-30, den)
    return torch.where(x <= lo, 0.0, torch.where(x >= hi, 1.0, y))


def mtf_pseudoinverse(y: torch.Tensor, p: MTFParams) -> torch.Tensor:
    """(mtf.c:118)"""
    num = ((p.shadows + p.highlights) * p.midtones - p.shadows) * y - \
        p.shadows * p.midtones + p.shadows
    den = (2.0 * p.midtones - 1.0) * y - p.midtones + 1.0
    return num / torch.where(den == 0, 1e-30, den)


def _mtf_scalar(x, m, lo, hi):
    if x <= lo:
        return 0.0
    if x >= hi:
        return 1.0
    xr = (x - lo) / (hi - lo)
    return ((m - 1.0) * xr) / (((2.0 * m - 1.0) * xr) - m)


def _layer_stats(img: SirilImage):
    """Median and MAD of each layer, on the host (the finders read only
    these two fields of the JAX package's STATS_BASIC | STATS_MAD)."""
    return per_layer(lambda x: compute_stats_np(x, STATS_MAD), img.host())


def find_linked_midtones_balance(
        img: SirilImage,
        shadows_clipping: float = AS_DEFAULT_SHADOWS_CLIPPING,
        target_bg: float = AS_DEFAULT_TARGET_BACKGROUND) -> MTFParams:
    """Autostretch parameters shared by every layer (mtf.c:298-364)."""
    stats = _layer_stats(img)
    nc = len(stats)
    inverted = sum(1 for s in stats if s.median > 0.5)
    p = MTFParams()
    if inverted < nc:
        c0 = m = 0.0
        for s in stats:
            mad = s.mad * MAD_NORM or 0.001
            c0 += s.median + shadows_clipping * mad
            m += s.median
        c0 = max(c0 / nc, 0.0)
        m2 = m / nc - c0
        p.shadows = c0
        p.midtones = _mtf_scalar(m2, target_bg, 0.0, 1.0)
        p.highlights = 1.0
    else:
        c1 = m = 0.0
        for s in stats:
            mad = s.mad * MAD_NORM or 0.001
            m += s.median
            c1 += s.median - shadows_clipping * mad
        c1 = min(c1 / nc, 1.0)
        m2 = c1 - m / nc
        p.midtones = 1.0 - _mtf_scalar(m2, target_bg, 0.0, 1.0)
        p.shadows = 0.0
        p.highlights = c1
    return p


def find_unlinked_midtones_balance(
        img: SirilImage,
        shadows_clipping: float = AS_DEFAULT_SHADOWS_CLIPPING,
        target_bg: float = AS_DEFAULT_TARGET_BACKGROUND):
    """Autostretch parameters of each layer (the unlinked variant)."""
    out = []
    for s in _layer_stats(img):
        mad = s.mad * MAD_NORM or 0.001
        p = MTFParams()
        if s.median <= 0.5:
            c0 = max(s.median + shadows_clipping * mad, 0.0)
            p.shadows = c0
            p.midtones = _mtf_scalar(s.median - c0, target_bg, 0.0, 1.0)
        else:
            c1 = min(s.median - shadows_clipping * mad, 1.0)
            p.midtones = 1.0 - _mtf_scalar(c1 - s.median, target_bg, 0.0,
                                           1.0)
            p.highlights = c1
        out.append(p)
    return out


def apply_mtf(img: SirilImage, params, linked: bool = True,
              device: DeviceLike = None) -> SirilImage:
    """The MTF of ``params`` (one MTFParams, or one a layer)."""
    data = upload(img, device)
    if isinstance(params, MTFParams):
        out = mtf(data, params.midtones, params.shadows, params.highlights)
    else:
        out = torch.stack([mtf(data[c], params[c].midtones,
                               params[c].shadows, params[c].highlights)
                           for c in range(data.shape[0])])
    return finish(img, out, "MTF stretch")


def invmtf(img: SirilImage, p: MTFParams,
           device: DeviceLike = None) -> SirilImage:
    """The ``invmtf`` command's image: the pseudo-inverse clipped to
    [0, 1] (no history line, no mask, as the JAX command)."""
    out = torch.clamp(mtf_pseudoinverse(upload(img, device), p), 0.0, 1.0)
    return img.copy(data=np.ascontiguousarray(out.cpu().numpy()))


def autostretch(img: SirilImage,
                shadows_clipping: float = AS_DEFAULT_SHADOWS_CLIPPING,
                target_bg: float = AS_DEFAULT_TARGET_BACKGROUND,
                linked: bool = True, device: DeviceLike = None
                ) -> SirilImage:
    if linked:
        p = find_linked_midtones_balance(img, shadows_clipping, target_bg)
    else:
        p = find_unlinked_midtones_balance(img, shadows_clipping, target_bg)
    return apply_mtf(img, p, linked, device=device)


# ---------------------------------------------------------------------------
# GHT (ght.c:59-345)
# ---------------------------------------------------------------------------

STRETCH_LINEAR = 0
STRETCH_PAYNE_NORMAL = 1
STRETCH_PAYNE_INVERSE = 2
STRETCH_ASINH = 3
STRETCH_INVASINH = 4

# colour stretch models (payload)
COL_INDEP = 0
COL_HUMANLUM = 1
COL_EVENLUM = 2
COL_SAT = 3


@dataclass
class GHTParams:
    B: float = 0.0
    D: float = 1.0
    LP: float = 0.0
    SP: float = 0.0
    HP: float = 1.0
    BP: float = 0.0
    stretchtype: int = STRETCH_PAYNE_NORMAL
    payne_colourstretchmodel: int = COL_INDEP


class _C:
    """ght_compute_params."""

    def __init__(self):
        for k in ("qlp q0 qwp q1 q a1 b1 a2 b2 c2 d2 e2 a3 b3 c3 d3 e3 "
                  "a4 b4 LPT SPT HPT").split():
            setattr(self, k, 0.0)


def _setup_normal(c, B, D, LP, SP, HP):
    pw, ex = math.pow, math.exp
    if B == -1.0:
        c.qlp = -math.log1p(D * (SP - LP))
        c.q0 = c.qlp - D * LP / (1.0 + D * (SP - LP))
        c.qwp = math.log1p(D * (HP - SP))
        c.q1 = c.qwp + D * (1.0 - HP) / (1.0 + D * (HP - SP))
        c.q = 1.0 / (c.q1 - c.q0)
        # the JAX package's slope D·q/(1 + D(SP − LP)), continuous at LP
        # (ght.c:72 has its reciprocal)
        c.b1 = D * c.q / (1.0 + D * (SP - LP))
        c.a2 = -c.q0 * c.q
        c.b2 = -c.q
        c.c2 = 1.0 + D * SP
        c.d2 = -D
        c.a3 = -c.q0 * c.q
        c.b3 = c.q
        c.c3 = 1.0 - D * SP
        c.d3 = D
        c.a4 = (c.qwp - c.q0 - D * HP / (1.0 + D * (HP - SP))) * c.q
        c.b4 = c.q * D / (1.0 + D * (HP - SP))
    elif B < 0.0:
        B = -B
        c.qlp = (1.0 - pw(1.0 + D * B * (SP - LP), (B - 1.0) / B)) / (B - 1.0)
        c.q0 = c.qlp - D * LP * pw(1.0 + D * B * (SP - LP), -1.0 / B)
        c.qwp = (pw(1.0 + D * B * (HP - SP), (B - 1.0) / B) - 1.0) / (B - 1.0)
        c.q1 = c.qwp + D * (1.0 - HP) * pw(1.0 + D * B * (HP - SP), -1.0 / B)
        c.q = 1.0 / (c.q1 - c.q0)
        c.b1 = D * pw(1.0 + D * B * (SP - LP), -1.0 / B) * c.q
        c.a2 = (1.0 / (B - 1.0) - c.q0) * c.q
        c.b2 = -c.q / (B - 1.0)
        c.c2 = 1.0 + D * B * SP
        c.d2 = -D * B
        c.e2 = (B - 1.0) / B
        c.a3 = (-1.0 / (B - 1.0) - c.q0) * c.q
        c.b3 = c.q / (B - 1.0)
        c.c3 = 1.0 - D * B * SP
        c.d3 = D * B
        c.e3 = (B - 1.0) / B
        c.a4 = (c.qwp - c.q0
                - D * HP * pw(1.0 + D * B * (HP - SP), -1.0 / B)) * c.q
        c.b4 = D * pw(1.0 + D * B * (HP - SP), -1.0 / B) * c.q
    elif B == 0.0:
        c.qlp = ex(-D * (SP - LP))
        c.q0 = c.qlp - D * LP * ex(-D * (SP - LP))
        c.qwp = 2.0 - ex(-D * (HP - SP))
        c.q1 = c.qwp + D * (1.0 - HP) * ex(-D * (HP - SP))
        c.q = 1.0 / (c.q1 - c.q0)
        c.b1 = D * ex(-D * (SP - LP)) * c.q
        c.a2 = -c.q0 * c.q
        c.b2 = c.q
        c.c2 = -D * SP
        c.d2 = D
        c.a3 = (2.0 - c.q0) * c.q
        c.b3 = -c.q
        c.c3 = D * SP
        c.d3 = -D
        c.a4 = (c.qwp - c.q0 - D * HP * ex(-D * (HP - SP))) * c.q
        c.b4 = D * ex(-D * (HP - SP)) * c.q
    else:
        c.qlp = pw(1.0 + D * B * (SP - LP), -1.0 / B)
        c.q0 = c.qlp - D * LP * pw(1.0 + D * B * (SP - LP), -(1.0 + B) / B)
        c.qwp = 2.0 - pw(1.0 + D * B * (HP - SP), -1.0 / B)
        c.q1 = c.qwp + D * (1.0 - HP) * pw(1.0 + D * B * (HP - SP),
                                           -(1.0 + B) / B)
        c.q = 1.0 / (c.q1 - c.q0)
        c.b1 = D * pw(1.0 + D * B * (SP - LP), -(1.0 + B) / B) * c.q
        c.a2 = -c.q0 * c.q
        c.b2 = c.q
        c.c2 = 1.0 + D * B * SP
        c.d2 = -D * B
        c.e2 = -1.0 / B
        c.a3 = (2.0 - c.q0) * c.q
        c.b3 = -c.q
        c.c3 = 1.0 - D * B * SP
        c.d3 = D * B
        c.e3 = -1.0 / B
        c.a4 = (c.qwp - c.q0 - D * HP * pw(1.0 + D * B * (HP - SP),
                                           -(B + 1.0) / B)) * c.q
        c.b4 = D * pw(1.0 + D * B * (HP - SP), -(B + 1.0) / B) * c.q


def _setup_inverse(c, B, D, LP, SP, HP):
    pw, ex = math.pow, math.exp
    if B == -1.0:
        c.qlp = -math.log1p(D * (SP - LP))
        c.q0 = c.qlp - D * LP / (1.0 + D * (SP - LP))
        c.qwp = math.log1p(D * (HP - SP))
        c.q1 = c.qwp + D * (1.0 - HP) / (1.0 + D * (HP - SP))
        c.q = 1.0 / (c.q1 - c.q0)
        c.LPT = (c.qlp - c.q0) * c.q
        # the JAX package's SPT = −q0·q, the forward value at SP
        # (ght.c:152 has q0·q, which leaves the first inverse branch
        # unreachable)
        c.SPT = -c.q0 * c.q
        c.HPT = (c.qwp - c.q0) * c.q
        c.b1 = (1.0 + D * (SP - LP)) / (D * c.q)
        c.a2 = (1.0 + D * SP) / D
        c.b2 = -1.0 / D
        c.c2 = -c.q0
        c.d2 = -1.0 / c.q
        c.a3 = -(1.0 - D * SP) / D
        c.b3 = 1.0 / D
        c.c3 = c.q0
        c.d3 = 1.0 / c.q
        c.a4 = HP + (c.q0 - c.qwp) * (1 + D * (HP - SP)) / D
        c.b4 = (1.0 + D * (HP - SP)) / (c.q * D)
    elif B < 0.0:
        B = -B
        c.qlp = (1.0 - pw(1.0 + D * B * (SP - LP), (B - 1.0) / B)) / (B - 1.0)
        c.q0 = c.qlp - D * LP * pw(1.0 + D * B * (SP - LP), -1.0 / B)
        c.qwp = (pw(1.0 + D * B * (HP - SP), (B - 1.0) / B) - 1.0) / (B - 1.0)
        c.q1 = c.qwp + D * (1.0 - HP) * pw(1.0 + D * B * (HP - SP), -1.0 / B)
        c.q = 1.0 / (c.q1 - c.q0)
        c.LPT = (c.qlp - c.q0) * c.q
        c.SPT = -c.q0 * c.q
        c.HPT = (c.qwp - c.q0) * c.q
        c.b1 = pw(1.0 + D * B * (SP - LP), 1.0 / B) / (c.q * D)
        c.a2 = (1.0 + D * B * SP) / (D * B)
        c.b2 = -1.0 / (D * B)
        c.c2 = -c.q0 * (B - 1.0) + 1.0
        c.d2 = (1.0 - B) / c.q
        c.e2 = B / (B - 1.0)
        c.a3 = (D * B * SP - 1.0) / (D * B)
        c.b3 = 1.0 / (D * B)
        c.c3 = 1.0 + c.q0 * (B - 1)
        c.d3 = (B - 1.0) / c.q
        c.e3 = B / (B - 1.0)
        c.a4 = (c.q0 - c.qwp) / (D * pw(1.0 + D * B * (HP - SP), -1.0 / B)) \
            + HP
        c.b4 = 1.0 / (D * pw(1.0 + D * B * (HP - SP), -1.0 / B) * c.q)
    elif B == 0.0:
        c.qlp = ex(-D * (SP - LP))
        c.q0 = c.qlp - D * LP * ex(-D * (SP - LP))
        c.qwp = 2.0 - ex(-D * (HP - SP))
        c.q1 = c.qwp + D * (1.0 - HP) * ex(-D * (HP - SP))
        c.q = 1.0 / (c.q1 - c.q0)
        c.LPT = (c.qlp - c.q0) * c.q
        c.SPT = (1.0 - c.q0) * c.q
        c.HPT = (c.qwp - c.q0) * c.q
        c.b1 = 1.0 / (D * ex(-D * (SP - LP)) * c.q)
        c.a2 = SP
        c.b2 = 1.0 / D
        c.c2 = c.q0
        c.d2 = 1.0 / c.q
        c.a3 = SP
        c.b3 = -1.0 / D
        c.c3 = 2.0 - c.q0
        c.d3 = -1.0 / c.q
        c.a4 = (c.q0 - c.qwp) / (D * ex(-D * (HP - SP))) + HP
        c.b4 = 1.0 / (D * ex(-D * (HP - SP)) * c.q)
    else:
        c.qlp = pw(1.0 + D * B * (SP - LP), -1.0 / B)
        c.q0 = c.qlp - D * LP * pw(1.0 + D * B * (SP - LP), -(1.0 + B) / B)
        c.qwp = 2.0 - pw(1.0 + D * B * (HP - SP), -1.0 / B)
        c.q1 = c.qwp + D * (1.0 - HP) * pw(1.0 + D * B * (HP - SP),
                                           -(1.0 + B) / B)
        c.q = 1.0 / (c.q1 - c.q0)
        c.LPT = (c.qlp - c.q0) * c.q
        c.SPT = (1.0 - c.q0) * c.q
        c.HPT = (c.qwp - c.q0) * c.q
        c.b1 = 1.0 / (D * pw(1.0 + D * B * (SP - LP), -(1.0 + B) / B) * c.q)
        c.a2 = 1.0 / (D * B) + SP
        c.b2 = -1.0 / (D * B)
        c.c2 = c.q0
        c.d2 = 1.0 / c.q
        c.e2 = -B
        c.a3 = -1.0 / (D * B) + SP
        c.b3 = 1.0 / (D * B)
        c.c3 = 2.0 - c.q0
        c.d3 = -1.0 / c.q
        c.e3 = -B
        c.a4 = (c.q0 - c.qwp) / (D * pw(1.0 + D * B * (HP - SP),
                                        -(B + 1.0) / B)) + HP
        c.b4 = 1.0 / (D * pw(1.0 + D * B * (HP - SP), -(B + 1.0) / B) * c.q)


def _setup_asinh(c, stretchtype, D, LP, SP, HP):
    ln, sq = math.log, math.sqrt
    c.qlp = -ln(D * (SP - LP) + sq(D * D * (SP - LP) ** 2 + 1.0))
    c.q0 = c.qlp - LP * D * (D * D * (SP - LP) ** 2 + 1.0) ** -0.5
    c.qwp = ln(D * (HP - SP) + sq(D * D * (HP - SP) ** 2 + 1.0))
    c.q1 = c.qwp + (1.0 - HP) * D * (D * D * (HP - SP) ** 2 + 1.0) ** -0.5
    c.q = 1.0 / (c.q1 - c.q0)
    c.a1 = 0.0
    c.b1 = D * (D * D * (SP - LP) ** 2 + 1.0) ** -0.5 * c.q
    c.a2 = -c.q0 * c.q
    c.b2 = -c.q
    c.c2 = -D
    c.d2 = D * D
    c.e2 = SP
    c.a3 = -c.q0 * c.q
    c.b3 = c.q
    c.c3 = D
    c.d3 = D * D
    c.e3 = SP
    c.a4 = (c.qwp - HP * D * (D * D * (HP - SP) ** 2 + 1.0) ** -0.5
            - c.q0) * c.q
    c.b4 = D * (D * D * (HP - SP) ** 2 + 1.0) ** -0.5 * c.q
    if stretchtype == STRETCH_INVASINH:
        c.LPT = c.a1 + c.b1 * LP
        c.SPT = c.a2 + c.b2 * ln(c.c2 * (SP - c.e2)
                                 + sq(c.d2 * (SP - c.e2) ** 2 + 1.0))
        c.HPT = c.a4 + c.b4 * HP


def ght_setup(B, D, LP, SP, HP, stretchtype) -> _C:
    """GHTsetup (ght.c:59): the coefficients, float64 on the host."""
    c = _C()
    if D == 0.0 or stretchtype == STRETCH_LINEAR:
        return c
    if stretchtype == STRETCH_PAYNE_NORMAL:
        _setup_normal(c, B, D, LP, SP, HP)
    elif stretchtype == STRETCH_PAYNE_INVERSE:
        _setup_inverse(c, B, D, LP, SP, HP)
    elif stretchtype in (STRETCH_ASINH, STRETCH_INVASINH):
        _setup_asinh(c, stretchtype, D, LP, SP, HP)
    return c


def _clog(v: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(v, 1e-30))


def _cpow(v: torch.Tensor, e: float) -> torch.Tensor:
    return torch.pow(torch.clamp_min(v, 1e-30), float(np.float32(e)))


def ght(x: torch.Tensor, p: GHTParams, c: Optional[_C] = None
        ) -> torch.Tensor:
    """GHT of a float32 tensor (ght.c:278-345)."""
    if c is None:
        c = ght_setup(p.B, p.D, p.LP, p.SP, p.HP, p.stretchtype)
    B, D, LP, SP, HP = p.B, p.D, p.LP, p.SP, p.HP
    st = p.stretchtype
    if st == STRETCH_LINEAR:
        return torch.clamp_min((x - p.BP) / (1.0 - p.BP), 0.0)
    xi = torch.clamp_min((x - 0.0) / 1.0, 0.0)
    if D == 0.0:
        return xi
    if st == STRETCH_PAYNE_NORMAL:
        if B == -1.0:
            r1 = c.a2 + c.b2 * _clog(c.c2 + c.d2 * xi)
            r2 = c.a3 + c.b3 * _clog(c.c3 + c.d3 * xi)
        elif B != 0.0:
            r1 = c.a2 + c.b2 * _cpow(c.c2 + c.d2 * xi, c.e2)
            r2 = c.a3 + c.b3 * _cpow(c.c3 + c.d3 * xi, c.e3)
        else:
            r1 = c.a2 + c.b2 * torch.exp(c.c2 + c.d2 * xi)
            r2 = c.a3 + c.b3 * torch.exp(c.c3 + c.d3 * xi)
        return torch.where(xi < LP, c.b1 * xi,
                           torch.where(xi < SP, r1,
                                       torch.where(xi < HP, r2,
                                                   c.a4 + c.b4 * xi)))
    if st == STRETCH_PAYNE_INVERSE:
        if B == -1.0:
            r1 = c.a2 + c.b2 * torch.exp(c.c2 + c.d2 * xi)
            r2 = c.a3 + c.b3 * torch.exp(c.c3 + c.d3 * xi)
        elif B != 0.0:
            r1 = c.a2 + c.b2 * _cpow(c.c2 + c.d2 * xi, c.e2)
            r2 = c.a3 + c.b3 * _cpow(c.c3 + c.d3 * xi, c.e3)
        else:
            r1 = c.a2 + c.b2 * _clog(c.c2 + c.d2 * xi)
            r2 = c.a3 + c.b3 * _clog(c.c3 + c.d3 * xi)
        return torch.where(xi < c.LPT, c.b1 * xi,
                           torch.where(xi < c.SPT, r1,
                                       torch.where(xi < c.HPT, r2,
                                                   c.a4 + c.b4 * xi)))
    if st == STRETCH_ASINH:
        v1 = c.c2 * (xi - c.e2) + torch.sqrt(c.d2 * (xi - c.e2) ** 2 + 1.0)
        r1 = c.a2 + c.b2 * _clog(v1)
        v2 = c.c3 * (xi - c.e3) + torch.sqrt(c.d3 * (xi - c.e3) ** 2 + 1.0)
        r2 = c.a3 + c.b3 * _clog(v2)
        return torch.where(xi < LP, c.a1 + c.b1 * xi,
                           torch.where(xi < SP, r1,
                                       torch.where(xi < HP, r2,
                                                   c.a4 + c.b4 * xi)))
    # STRETCH_INVASINH
    e1 = torch.exp((c.a2 - xi) / c.b2)
    r1 = c.e2 - (e1 - 1.0 / e1) / (2.0 * c.c2)
    e2 = torch.exp((c.a3 - xi) / c.b3)
    r2 = c.e3 - (e2 - 1.0 / e2) / (2.0 * c.c3)
    return torch.where(xi < c.LPT, (xi - c.a1) / max(c.b1, 1e-30),
                       torch.where(xi < c.SPT, r1,
                                   torch.where(xi < c.HPT, r2,
                                               (xi - c.a4) / max(c.b4,
                                                                 1e-30))))


def ght_colour(data: torch.Tensor, p: GHTParams) -> torch.Tensor:
    """The GHT of a (C, H, W) tensor with the colour model of ``p``
    (apply_linked_ght_to_fbuf_*): every layer on its own, a luminance's
    stretch as one gain, or the HSL saturation; clipped to [0, 1]."""
    from siril_tpu_torch.ops.colors import hsl_to_rgb, rgb_to_hsl

    c = ght_setup(p.B, p.D, p.LP, p.SP, p.HP, p.stretchtype)
    model = p.payne_colourstretchmodel
    if data.shape[0] == 3 and model in (COL_HUMANLUM, COL_EVENLUM):
        w = (0.2126, 0.7152, 0.0722) if model == COL_HUMANLUM else \
            (1 / 3, 1 / 3, 1 / 3)
        lum = w[0] * data[0] + w[1] * data[1] + w[2] * data[2]
        sl = ght(lum, p, c)
        k = torch.where(lum == 0.0, 0.0,
                        sl / torch.where(lum == 0, 1.0, lum))
        return torch.clamp(data * k[None], 0.0, 1.0)
    if data.shape[0] == 3 and model == COL_SAT:
        h, s, lg = rgb_to_hsl(data[0], data[1], data[2])
        s2 = torch.clamp(ght(s, p, c), 0.0, 1.0)
        return torch.stack(hsl_to_rgb(h, s2, lg))
    return torch.clamp(ght(data, p, c), 0.0, 1.0)


def apply_ght(img: SirilImage, p: GHTParams,
              device: DeviceLike = None) -> SirilImage:
    """``ght`` and its family on the image (``ght_colour``)."""
    return finish(img, ght_colour(upload(img, device), p),
                  f"GHT (D={p.D:.2f} B={p.B:.2f})")


# ---------------------------------------------------------------------------
# asinh stretch (asinh.c:167-230)
# ---------------------------------------------------------------------------


def asinh_tensor(data: torch.Tensor, beta: float, offset: float = 0.0,
                 human_luminance: bool = False,
                 rescale: bool = False) -> torch.Tensor:
    """The asinh stretch of a (C, H, W) tensor: one gain a pixel from the
    (human or even) luminance of an RGB image."""
    fr = 0.2126 if human_luminance else 1.0 / 3.0
    fg = 0.7152 if human_luminance else 1.0 / 3.0
    fb = 0.0722 if human_luminance else 1.0 / 3.0
    inv1mo = 1.0 / (1.0 - offset)
    ab = math.asinh(beta) if beta != 0 else 1.0
    prime = torch.clamp_min((data - offset) * inv1mo, 0.0)

    def gain(x):
        if beta == 0:
            return torch.where(x == 0.0, 0.0, 1.0)
        return torch.where(x == 0.0, 0.0, torch.asinh(beta * x)
                           / (torch.where(x == 0, 1.0, x) * ab))

    if data.shape[0] != 3:
        return torch.clamp(prime * gain(prime[0])[None], 0.0, 1.0)
    x = fr * prime[0] + fg * prime[1] + fb * prime[2]
    sf = torch.clamp_min(prime * gain(x)[None], 0.0)
    if rescale:
        mx = sf.amax(dim=0)
        scale = torch.where(mx > 1.0, 1.0 / torch.clamp_min(mx, 1e-30), 1.0)
        return sf * scale[None]
    return torch.clamp_max(sf, 1.0)


def asinh_stretch(img: SirilImage, beta: float, offset: float = 0.0,
                  human_luminance: bool = False, rescale: bool = False,
                  device: DeviceLike = None) -> SirilImage:
    out = asinh_tensor(upload(img, device), beta, offset, human_luminance,
                       rescale)
    return finish(img, out, f"Asinh Transformation: (stretch={beta:6.1f}, "
                  f"bp={offset:7.5f})")


# ---------------------------------------------------------------------------
# linstretch (linear BP) and curves
# ---------------------------------------------------------------------------


def linstretch(img: SirilImage, bp: float,
               device: DeviceLike = None) -> SirilImage:
    return apply_ght(img, GHTParams(BP=bp, stretchtype=STRETCH_LINEAR),
                     device=device)


def apply_curve(img: SirilImage, points, algo: str = "spline",
                channels=(True, True, True),
                device: DeviceLike = None) -> SirilImage:
    """curve_transform.c: a monotone cubic-spline (a 1024-entry table
    through scipy's CubicSpline, on the host) or linear curve through the
    control points [(x, y), …] in [0, 1]."""
    pts = sorted((float(a), float(b)) for a, b in points)
    xs = np.array([p[0] for p in pts], np.float64)
    ys = np.array([p[1] for p in pts], np.float64)
    if algo == "linear" or len(pts) < 3:
        grid, lut = xs, ys
    else:
        from scipy.interpolate import CubicSpline

        grid = np.linspace(0.0, 1.0, 1024)
        lut = np.clip(CubicSpline(xs, ys)(grid), 0.0, 1.0)
    data = upload(img, device)
    chans = []
    for ci in range(data.shape[0]):
        do = channels[ci] if ci < len(channels) else True
        chans.append(interp(data[ci], grid, lut) if do else data[ci])
    out = torch.clamp(torch.stack(chans), 0.0, 1.0)
    return finish(img, out, "Curves transform")
