"""Image masks — counterpart of ``siril_tpu/ops/masks.py``
(``src/core/masks.c``).

A mask is an (H, W) float32 numpy plane in [0, 1] attached to a
SirilImage; masked ops blend result = mask·new + (1−mask)·old
(``SirilImage.apply_mask_blend``).  Sources: channel, luminance, colour
distance (host numpy, as in the JAX package) and detected stars (the
port's star finder on ``device``, the blobs drawn on the host).
Modifiers: invert, threshold, fmul (host numpy), blur (the filters'
gaussian blur on ``device``), feather (scipy's EDT on the host) and
autostretch (the port's stretch).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device


def mask_from_channel(img: SirilImage, channel: int) -> np.ndarray:
    d = img.host()
    return d[min(channel, d.shape[0] - 1)].copy()


def mask_from_lum(img: SirilImage,
                  weights: Tuple[float, float, float] = (0.2126, 0.7152,
                                                         0.0722)
                  ) -> np.ndarray:
    d = img.host()
    if d.shape[0] == 1:
        return d[0].copy()
    return (weights[0] * d[0] + weights[1] * d[1] + weights[2] * d[2]
            ).astype(np.float32)


def mask_from_color(img: SirilImage, color: Tuple[float, float, float],
                    fuzz: float = 0.1) -> np.ndarray:
    """Similarity to a target RGB color: 1 at exact match, falls off with
    euclidean distance scaled by fuzz."""
    d = img.host()
    if d.shape[0] != 3:
        raise ValueError("color mask requires RGB")
    dist = np.sqrt(((d - np.asarray(color, np.float32)[:, None, None]) ** 2)
                   .mean(axis=0))
    m = np.clip(1.0 - dist / max(fuzz, 1e-6), 0.0, 1.0)
    return m.astype(np.float32)


def star_blobs(stars, H: int, W: int, grow: float = 1.5) -> np.ndarray:
    """Gaussian blobs at the stars' positions, σ their FWHM / 2.355 ×
    ``grow``, the maximum where they overlap."""
    m = np.zeros((H, W), np.float32)
    for s in stars:
        sig = max(s.fwhmx, 1.0) / 2.355 * grow
        r = int(4 * sig) + 1
        x0, x1 = max(int(s.x0) - r, 0), min(int(s.x0) + r + 1, W)
        y0, y1 = max(int(s.y0) - r, 0), min(int(s.y0) + r + 1, H)
        if x1 <= x0 or y1 <= y0:
            continue
        sub_y = np.arange(y0, y1)[:, None]
        sub_x = np.arange(x0, x1)[None, :]
        g = np.exp(-(((sub_x + 0.5 - s.x0) ** 2 + (sub_y + 0.5 - s.y0) ** 2)
                     / (2 * sig * sig)))
        m[y0:y1, x0:x1] = np.maximum(m[y0:y1, x0:x1], g.astype(np.float32))
    return m


def mask_from_stars(img: SirilImage, layer: int = 0, grow: float = 1.5,
                    device: DeviceLike = None) -> np.ndarray:
    """Star mask: gaussian blobs at detected star positions sized by the
    fitted FWHM (masks.c mask_from_stars)."""
    from siril_tpu_torch.registration.starfinder import detect_stars

    d = img.host()
    lay = d[min(layer, d.shape[0] - 1)]
    stars = detect_stars(torch.from_numpy(lay).to(resolve_device(device)))
    return star_blobs(stars, *lay.shape, grow=grow)


def mask_invert(mask: np.ndarray) -> np.ndarray:
    return (1.0 - mask).astype(np.float32)


def mask_blur(mask: np.ndarray, sigma: float,
              device: DeviceLike = None) -> np.ndarray:
    from siril_tpu_torch.ops.filters import gaussian_blur_chw

    m = torch.from_numpy(np.asarray(mask, np.float32)[None]).to(
        resolve_device(device))
    return np.ascontiguousarray(gaussian_blur_chw(m, sigma)[0].cpu().numpy())


def mask_feather(mask: np.ndarray, distance: int) -> np.ndarray:
    """Distance-ramp feather: binary mask edges ramp linearly over
    ``distance`` px (blending.c distance-ramp semantics)."""
    from scipy.ndimage import distance_transform_edt

    binary = mask > 0.5
    inside = distance_transform_edt(binary)
    ramp = np.clip(inside / max(distance, 1), 0.0, 1.0)
    return (ramp * binary).astype(np.float32)


def mask_threshold(mask: np.ndarray, lo: float, hi: float = 1.0,
                   binarize: bool = False) -> np.ndarray:
    m = np.where((mask >= lo) & (mask <= hi), mask, 0.0)
    if binarize:
        m = (m > 0).astype(np.float32)
    return m.astype(np.float32)


def mask_fmul(mask: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(mask * factor, 0.0, 1.0).astype(np.float32)


def mask_autostretch(mask: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
    from siril_tpu_torch.ops.stretch import find_linked_midtones_balance, mtf

    p = find_linked_midtones_balance(SirilImage(data=mask[None]))
    m = torch.from_numpy(np.asarray(mask, np.float32)).to(
        resolve_device(device))
    return np.ascontiguousarray(mtf(m, p.midtones, p.shadows,
                                    p.highlights).cpu().numpy())
