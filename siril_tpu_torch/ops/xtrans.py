"""X-Trans (Fuji 6×6 CFA) demosaicing — counterpart of
``siril_tpu/ops/xtrans.py`` (``XTRANS_PATTERNS``:34,
``compile_xtrans_pattern``:43, ``_xtrans_masks``:62, ``_xtrans_fn``:68,
``demosaic_xtrans``:126, ``demosaic_xtrans_image``:137).

A Markesteijn-class method as whole-image stencils, in eager torch on
the CFA tensor's device: green at the R/B sites by gradient-inverse
weights over the green neighbours of the 8-neighbourhood, one
colour-difference refinement of green, then R and B in the
colour-difference domain in two filling passes (R and B sites are 8 of
36).  Shifts clamp at the edge; the result is clipped to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.ops.demosaic_ext import _masked_bilinear, _sh

# the 4 standard X-Trans phase patterns (demosaicing.c:44-71)
XTRANS_PATTERNS = (
    "GGRGGB" "GGBGGR" "BRGRBG" "GGBGGR" "GGRGGB" "RBGBRG",
    "RBGBRG" "GGRGGB" "GGBGGR" "BRGRBG" "GGBGGR" "GGRGGB",
    "GRGGBG" "BGBRGR" "GRGGBG" "GBGGRG" "RGRBGB" "GBGGRG",
    "GBGGRG" "RGRBGB" "GBGGRG" "GRGGBG" "BGBRGR" "GRGGBG",
)


def compile_xtrans_pattern(pattern: str, xoff: int = 0, yoff: int = 0,
                           flip: bool = False,
                           flip_offset: int = 0) -> np.ndarray:
    """A 36-character RGB string → a 6×6 int grid (0 R, 1 G, 2 B), with
    the bottom-up row flip (offset ``height % 6``) and the x/y phase
    offsets (compile_XTrans_pattern, demosaicing.c:172-215)."""
    if len(pattern) != 36:
        raise ValueError("X-Trans pattern must be 36 characters")
    rows = [pattern[i * 6:(i + 1) * 6] for i in range(6)]
    if flip:
        rows = [rows[(5 - i + flip_offset) % 6] for i in range(6)]
    grid = np.zeros((6, 6), np.int32)
    lut = {"R": 0, "G": 1, "B": 2}
    for y in range(6):
        for x in range(6):
            grid[(y + yoff) % 6, (x + xoff) % 6] = lut[rows[y][x]]
    return grid


def _xtrans_masks(grid: np.ndarray, h: int, w: int, device=None):
    g = torch.as_tensor(np.asarray(grid), device=device)
    tiled = g.repeat(h // 6 + 2, w // 6 + 2)[:h, :w]
    return tiled == 0, tiled == 1, tiled == 2


def demosaic_xtrans(cfa: torch.Tensor, grid: np.ndarray) -> torch.Tensor:
    """An (H, W) X-Trans CFA and its compiled 6×6 grid → (3, H, W)."""
    rm, gm, bm = _xtrans_masks(grid, *cfa.shape, device=cfa.device)
    x = cfa.float()
    cm = rm | bm
    gmf = gm.to(x.dtype)
    eps = 1e-5
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            gn = _sh(x, dy, dx)
            grad = torch.abs(gn - _sh(x, -dy, -dx)) + \
                torch.abs(x - _sh(x, 2 * dy, 2 * dx))
            wgt = _sh(gmf, dy, dx) / (eps + grad)
            num = num + wgt * gn
            den = den + wgt
    g = torch.where(gm, x, num / torch.clamp(den, min=1e-12))

    # green refinement: G − R and G − B smoothed over their own sites
    d = torch.where(cm, g - x, 0.0)
    dsm = torch.where(rm, _masked_bilinear(d * rm, rm),
                      _masked_bilinear(d * bm, bm))
    g = torch.where(cm, x + 0.5 * (d + dsm), g)

    def fill(mask):
        d1 = _masked_bilinear((x - g) * mask, mask)
        m = mask.to(x.dtype)
        have = torch.zeros_like(m)
        for dy, dx in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            have = have + _sh(m, dy, dx)
        reached = have > 0
        d2 = _masked_bilinear(torch.where(reached, d1, 0.0), reached)
        return g + torch.where(reached, d1, d2)

    return torch.clamp(torch.stack([fill(rm), g, fill(bm)]), 0.0, 1.0)


def demosaic_xtrans_image(img: SirilImage, pattern: str = None,
                          device=None) -> SirilImage:
    """X-Trans debayer of a CFA image with the header's 36-character
    pattern (or ``pattern``), on ``device`` (CUDA unless "cpu")."""
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.ops.demosaic import debayered_image

    kw = img.keywords
    pat = pattern or kw.bayer_pattern
    if pat is None or len(pat) != 36:
        raise ValueError("image has no 36-character X-Trans pattern")
    grid = compile_xtrans_pattern(pat, kw.bayer_xoffset or 0,
                                  kw.bayer_yoffset or 0)
    x = torch.from_numpy(img.host()[0]).to(resolve_device(device))
    return debayered_image(img, demosaic_xtrans(x, grid),
                           "X-Trans debayer applied")
