"""CFA channel extraction — counterpart of ``siril_tpu/ops/extraction.py``
(``_sites``:25, ``_color_at``:33, ``split_cfa``:38, ``merge_cfa``:50,
``extract_channel_sites``:65, ``extract_ha``:73, ``extract_green``:89,
``extract_ha_oiii``:103; reference ``src/algos/extraction.c``).

Host numpy, as in the reference: the operations are slices of the 2×2
cell, with no arithmetic beyond the means of ``extract_Green`` and
``extract_HaOIII``.
- split_cfa: the four CFA sites → four half-size images CFA0..CFA3
  (row-major over the 2×2 cell); merge_cfa, its inverse.
- extract_Ha: the red site, half size (or repeated ×2 with ``upscale``).
- extract_Green: the mean of the two green sites, half size.
- extract_HaOIII: Ha the red site, OIII the mean of the two greens and
  the blue; with ``resample="ha"`` both repeated ×2 to full size.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from siril_tpu_torch.core.image import SirilImage

_SITES = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _sites(cfa: np.ndarray) -> Dict[Tuple[int, int], np.ndarray]:
    h2, w2 = cfa.shape[0] // 2, cfa.shape[1] // 2
    q = cfa[: h2 * 2, : w2 * 2]
    return {(dy, dx): q[dy::2, dx::2] for dy, dx in _SITES}


def _color_at(pattern: str) -> Dict[Tuple[int, int], str]:
    p = np.array(list(pattern.upper())).reshape(2, 2)
    return {(dy, dx): p[dy, dx] for dy, dx in _SITES}


def _mono(img: SirilImage, plane: np.ndarray, filt: str = None
          ) -> SirilImage:
    out = img.copy(data=np.ascontiguousarray(plane)[None])
    out.keywords.bayer_pattern = ""
    if filt is not None:
        out.keywords.filter = filt
    return out


def _up2(a: np.ndarray) -> np.ndarray:
    return np.kron(a, np.ones((2, 2), np.float32))


def split_cfa(img: SirilImage) -> List[SirilImage]:
    """→ [CFA0, CFA1, CFA2, CFA3], half-size mono images."""
    s = _sites(img.host()[0])
    return [_mono(img, s[key]) for key in _SITES]


def merge_cfa(imgs, pattern: str) -> SirilImage:
    """Four half-size images in CFA0..CFA3 order → the mosaic, with
    ``pattern`` as its BAYERPAT."""
    if len(imgs) != 4:
        raise ValueError("merge_cfa needs exactly 4 images")
    subs = [im.host()[0] for im in imgs]
    h2, w2 = subs[0].shape
    out = np.zeros((h2 * 2, w2 * 2), np.float32)
    for sub, (dy, dx) in zip(subs, _SITES):
        out[dy::2, dx::2] = sub
    res = imgs[0].copy(data=out[None])
    res.keywords.bayer_pattern = pattern.upper()
    return res


def extract_channel_sites(img: SirilImage, color: str) -> List[np.ndarray]:
    """The half-size planes of every site of ``color`` (RGGB when the
    image has no pattern)."""
    colors = _color_at(img.keywords.bayer_pattern or "RGGB")
    sites = _sites(img.host()[0])
    return [sites[k] for k, c in colors.items() if c == color]


def extract_ha(img: SirilImage, upscale: bool = False) -> SirilImage:
    planes = extract_channel_sites(img, "R")
    if not planes:
        raise ValueError("no red sites in pattern")
    ha = planes[0].astype(np.float32)
    out = _mono(img, _up2(ha) if upscale else ha, "Ha")
    out.log_history("Extraction of Ha layer")
    return out


def extract_green(img: SirilImage) -> SirilImage:
    planes = extract_channel_sites(img, "G")
    if len(planes) < 2:
        raise ValueError("no green sites in pattern")
    g = 0.5 * (planes[0].astype(np.float32) + planes[1].astype(np.float32))
    out = _mono(img, g, "Green")
    out.log_history("Extraction of Green layer")
    return out


def extract_ha_oiii(img: SirilImage, resample: str = "oiii"):
    """(Ha, OIII) images of a dual-band session."""
    colors = _color_at(img.keywords.bayer_pattern or "RGGB")
    sites = _sites(img.host()[0])

    def of(color):
        return [sites[k].astype(np.float32) for k, c in colors.items()
                if c == color]

    ha, gs, b = of("R")[0], of("G"), of("B")[0]
    oiii = (gs[0] + gs[1] + b) / 3.0
    if resample == "ha":
        ha, oiii = _up2(ha), _up2(oiii)
    return _mono(img, ha, "Ha"), _mono(img, oiii, "OIII")
