"""Bayer demosaicing — counterpart of ``siril_tpu/ops/demosaic.py``
(``BAYER_PATTERNS`` and the method ids :25-49, ``effective_pattern``:55,
``_cfa_masks``:66, ``_conv2same``:74, ``demosaic_bilinear``:111,
``demosaic_super_pixel``:123, ``demosaic_vng``:146 with ``_vng_fn``:164,
``debayer``:213, ``debayer_image``:239).

Torch code on the CFA tensor's device: an (H, W) float32 CFA → a
(3, H, W) RGB tensor (super-pixel: (3, H/2, W/2)).  The methods:
bilinear and VNG here, RCD (the default, ``core/settings.py:30`` of the
JAX package) in ``ops/rcd.py``, AHD, AMaZE, DCB, HPHD, IGV and LMMSE in
``ops/demosaic_ext.py``, X-Trans in ``ops/xtrans.py``.

Each function keeps the reference's border rule: the bilinear
convolution reads zeros outside the frame, VNG's shifts wrap around
(``jnp.roll``, which ``torch.roll`` matches), RCD's wrap the other way
and the extended methods clamp at the edge.  The convolutions are
explicit weighted sums of shifted slices, not ``conv2d``, so that no
TF32 convolution runs on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device

BAYER_PATTERNS = ("RGGB", "BGGR", "GBRG", "GRBG")

# interpolation ids: the reference's interpolation_method enum order
# (settings.h:68-79), then super-pixel
BAYER_BILINEAR = 0
BAYER_VNG = 1
BAYER_AHD = 2
BAYER_AMAZE = 3
BAYER_DCB = 4
BAYER_HPHD = 5
BAYER_IGV = 6
BAYER_LMMSE = 7
BAYER_RCD = 8
XTRANS = 9
BAYER_SUPER_PIXEL = 10

METHOD_NAMES = {"bilinear": BAYER_BILINEAR, "vng": BAYER_VNG,
                "ahd": BAYER_AHD, "amaze": BAYER_AMAZE, "dcb": BAYER_DCB,
                "hphd": BAYER_HPHD, "igv": BAYER_IGV, "lmmse": BAYER_LMMSE,
                "rcd": BAYER_RCD, "xtrans": XTRANS,
                "super": BAYER_SUPER_PIXEL}

_EXT_METHODS = {BAYER_AHD: "ahd", BAYER_AMAZE: "amaze", BAYER_DCB: "dcb",
                BAYER_HPHD: "hphd", BAYER_IGV: "igv", BAYER_LMMSE: "lmmse"}

#: the default method (the JAX package's ``debayer_method`` setting)
DEFAULT_METHOD = BAYER_RCD


def effective_pattern(pattern: str, xoff: int = 0, yoff: int = 0,
                      top_down: bool = True, height: int = 0) -> str:
    """The pattern at the frame's origin after the CFA offsets
    (demosaicing.c:105-180); ``top_down`` and ``height`` are ignored, as
    the JAX package ignores them."""
    p = pattern.upper().strip()
    if p not in BAYER_PATTERNS:
        raise ValueError(f"unsupported Bayer pattern {pattern!r}")
    grid = np.array(list(p)).reshape(2, 2)
    grid = np.roll(grid, (-yoff % 2, -xoff % 2), axis=(0, 1))
    return "".join(grid.ravel())


def _cfa_masks(pattern: str, h: int, w: int, device=None):
    """(r, g, b) boolean (h, w) masks of the 2×2 pattern's sites."""
    p = np.array(list(pattern)).reshape(2, 2)
    out = []
    for c in "RGB":
        cell = torch.as_tensor(p == c, device=device)
        out.append(cell.repeat((h + 1) // 2, (w + 1) // 2)[:h, :w])
    return tuple(out)


def _conv3_same(x: torch.Tensor, k) -> torch.Tensor:
    """Zero-padded 3×3 cross-correlation of an (H, W) plane with the
    weights ``k`` (``_conv2same``'s ``padding="SAME"``), as weighted sums
    of shifted slices."""
    h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if k[i][j]:
                acc = acc + float(k[i][j]) * xp[i:i + h, j:j + w]
    return acc


_KG = [[0.0, 0.25, 0.0], [0.25, 1.0, 0.25], [0.0, 0.25, 0.0]]
_KRB = [[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]]
_KVNG = [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]


def _interp_masked(x: torch.Tensor, mask: torch.Tensor, k) -> torch.Tensor:
    """Normalized convolution of the masked plane (bilinear fill)."""
    num = _conv3_same(torch.where(mask, x, 0.0), k)
    den = _conv3_same(mask.to(x.dtype), k)
    return num / torch.clamp(den, min=1e-9)


def demosaic_bilinear(cfa: torch.Tensor, pattern: str) -> torch.Tensor:
    """Bilinear: three normalized convolutions over the masked planes."""
    rm, gm, bm = _cfa_masks(pattern, *cfa.shape, device=cfa.device)
    x = cfa.float()
    return torch.stack([_interp_masked(x, rm, _KRB),
                        _interp_masked(x, gm, _KG),
                        _interp_masked(x, bm, _KRB)])


def demosaic_super_pixel(cfa: torch.Tensor, pattern: str) -> torch.Tensor:
    """2×2 super-pixel → half-size RGB (the two greens averaged)."""
    h2, w2 = cfa.shape[0] // 2, cfa.shape[1] // 2
    q = cfa[: h2 * 2, : w2 * 2].float()
    p = np.array(list(pattern)).reshape(2, 2)
    planes = {"R": [], "G": [], "B": []}
    for dy in (0, 1):
        for dx in (0, 1):
            planes[p[dy, dx]].append(q[dy::2, dx::2])
    g = 0.5 * (planes["G"][0] + planes["G"][1])
    return torch.stack([planes["R"][0], g, planes["B"][0]])


_VNG_DIRS = [(-1, 0), (1, 0), (0, -1), (0, 1),
             (-1, -1), (-1, 1), (1, -1), (1, 1)]


def _roll(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y − dy, x − dx], wrapping (``jnp.roll``)."""
    return torch.roll(a, shifts=(dy, dx), dims=(0, 1))


def demosaic_vng(cfa: torch.Tensor, pattern: str) -> torch.Tensor:
    """Variable number of gradients, vectorized: 8 directional gradients
    a pixel; each channel averages its neighbours in the directions whose
    gradient is at most 1.5·min + 1e-6, else takes the bilinear fill."""
    rm, gm, bm = _cfa_masks(pattern, *cfa.shape, device=cfa.device)
    x = cfa.float()
    grads = [torch.abs(_roll(x, dy, dx) - _roll(x, -dy, -dx))
             + torch.abs(_roll(x, 2 * dy, 2 * dx) - x)
             for dy, dx in _VNG_DIRS]
    G = torch.stack(grads)
    thr = 1.5 * G.min(dim=0).values + 1e-6
    sel = (G <= thr[None]).to(x.dtype)

    def channel(mask):
        mf = mask.to(x.dtype)
        xm = torch.where(mask, x, 0.0)
        num = torch.zeros_like(x)
        den = torch.zeros_like(x)
        for i, (dy, dx) in enumerate(_VNG_DIRS):
            num = num + sel[i] * _roll(xm, dy, dx)
            den = den + sel[i] * _roll(mf, dy, dx)
        fallback = _interp_masked(x, mask, _KVNG)
        est = torch.where(den > 0, num / torch.clamp(den, min=1e-9),
                          fallback)
        return torch.where(mask, x, est)

    return torch.stack([channel(rm), channel(gm), channel(bm)])


def debayer(cfa: torch.Tensor, pattern: str, method: int = DEFAULT_METHOD,
            xoff: int = 0, yoff: int = 0) -> torch.Tensor:
    """An (H, W) CFA → (3, H, W) RGB (demosaicing.c:544).  36-character
    patterns are X-Trans and always take the X-Trans method, whatever
    ``method`` says (demosaicing_rtp.cpp:154)."""
    if pattern and len(pattern) == 36:
        from siril_tpu_torch.ops.xtrans import (
            compile_xtrans_pattern,
            demosaic_xtrans,
        )

        return demosaic_xtrans(cfa, compile_xtrans_pattern(pattern, xoff,
                                                           yoff))
    pat = effective_pattern(pattern, xoff, yoff)
    if method == BAYER_SUPER_PIXEL:
        return demosaic_super_pixel(cfa, pat)
    if method == BAYER_BILINEAR:
        return demosaic_bilinear(cfa, pat)
    if method == BAYER_VNG:
        return demosaic_vng(cfa, pat)
    if method in _EXT_METHODS:
        from siril_tpu_torch.ops.demosaic_ext import demosaic_ext

        return demosaic_ext(cfa, pat, _EXT_METHODS[method])
    from siril_tpu_torch.ops.rcd import demosaic_rcd

    return demosaic_rcd(cfa, pat)


def debayer_tensor(x: torch.Tensor, img: SirilImage) -> torch.Tensor:
    """Debayer a (1, H, W) tensor that holds ``img``'s pixels (a CFA
    image: ``img.is_cfa()``) with the default method and ``img``'s
    pattern and offsets, on the tensor's device → (3, H', W')."""
    kw = img.keywords
    return debayer(x[0], kw.bayer_pattern, DEFAULT_METHOD, kw.bayer_xoffset,
                   kw.bayer_yoffset)


def debayered_image(img: SirilImage, rgb: torch.Tensor,
                    history: str = "Debayer applied") -> SirilImage:
    """``img`` with the debayered pixels ``rgb`` fetched to the host: no
    pattern left, the same bit depth, one history line."""
    out = img.copy(data=rgb.cpu().numpy().astype(np.float32))
    out.keywords.bayer_pattern = ""
    out.log_history(history)
    return out


def debayer_image(img: SirilImage, device: DeviceLike = None
                  ) -> SirilImage:
    """``debayer_image`` with the default method: a CFA image debayered
    on ``device`` (CUDA unless "cpu"); any other image is returned as it
    is."""
    if not img.is_cfa():
        return img
    x = torch.from_numpy(img.host()).to(resolve_device(device))
    return debayered_image(img, debayer_tensor(x, img))
