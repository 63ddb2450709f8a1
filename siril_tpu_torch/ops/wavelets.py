"""À-trous wavelet transform — counterpart of ``siril_tpu/ops/wavelets.py``:
the dilated separable smoother (``_atrous_smooth``:31), the pyramid
(``atrous_decompose`` / ``atrous_reconstruct``:49-76), the ``wavelet`` /
``wrecons`` pair (``wavelet_transform`` / ``wavelet_reconstruct``:79-96),
the Anscombe VST (``anscombe`` / ``anscombe_inverse_exact``:101-118) and
the layer-thresholding denoiser (``wavelet_denoise``:122).

Each scale is the filters' separable pass with the kernel dilated by 2^s
(shifted multiply-adds in float32, no TF32); the pyramid stays on the
image's device.  The detail planes' robust σ is the median of |w| as
``jnp.median`` takes it, the mean of the middle pair for an even count.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.filters import sep_conv
from siril_tpu_torch.ops.statistics import median_rows
from siril_tpu_torch.ops.stretch import finish, upload

WAVELET_LINEAR = 1      # kernel 1/4 1/2 1/4
WAVELET_BSPLINE = 2     # kernel 1/16 1/4 3/8 1/4 1/16

_KERNELS = {
    WAVELET_LINEAR: np.array([0.25, 0.5, 0.25], np.float32),
    WAVELET_BSPLINE: np.array([1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16],
                              np.float32),
}


def median_all(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of every element of ``x`` (0-d, ``x``'s dtype)."""
    flat = x.reshape(1, -1)
    return median_rows(flat, torch.ones_like(flat, dtype=torch.bool))[0]


def _atrous_smooth(x: torch.Tensor, ktype: int, scale: int) -> torch.Tensor:
    """One smoothing step with the kernel dilated by 2^scale."""
    return sep_conv(x, _KERNELS[ktype], 1 << scale)


def atrous_decompose(data: torch.Tensor, nb_layers: int,
                     ktype: int = WAVELET_BSPLINE) -> List[torch.Tensor]:
    """(C,H,W) → [w0, w1, …, w_{n-1}, residual] detail planes + residual."""
    cur = data.float()
    planes = []
    for s in range(nb_layers):
        sm = _atrous_smooth(cur, ktype, s)
        planes.append(cur - sm)
        cur = sm
    planes.append(cur)
    return planes


def atrous_reconstruct(planes: Sequence[torch.Tensor],
                       coeffs: Optional[Sequence[float]] = None):
    """Σ coeff_i · w_i + residual (wrecons)."""
    n = len(planes) - 1
    if coeffs is None:
        coeffs = [1.0] * n
    out = planes[-1]
    for i in range(n):
        c = coeffs[i] if i < len(coeffs) else 1.0
        out = out + c * planes[i]
    return out


def wavelet_transform(img: SirilImage, nb_layers: int,
                      ktype: int = WAVELET_BSPLINE,
                      device: DeviceLike = None) -> List[torch.Tensor]:
    """`wavelet` command: the plane list, kept by the session for a later
    `wrecons` (the reference's .wave temp files)."""
    return atrous_decompose(upload(img, device), nb_layers, ktype)


def wavelet_reconstruct(img: SirilImage, planes,
                        coeffs: Sequence[float]) -> SirilImage:
    out = torch.clamp(atrous_reconstruct(planes, coeffs), 0.0, 1.0)
    res = img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history(f"Wavelet reconstruction {list(coeffs)}")
    return res


# ---------------------------------------------------------------------------
# Anscombe VST (algos/anscombe.c)
# ---------------------------------------------------------------------------


def anscombe(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sqrt(torch.clamp_min(x + 3.0 / 8.0, 0.0))


def anscombe_inverse_exact(y: torch.Tensor) -> torch.Tensor:
    """Closed-form unbiased inverse (Makitalo & Foi approximation)."""
    y = torch.clamp_min(y, 1e-6)
    return (0.25 * y * y + 0.25 * math.sqrt(1.5) / y
            - 11.0 / 8.0 / (y * y)
            + 5.0 / 8.0 * math.sqrt(1.5) / (y * y * y) - 1.0 / 8.0)


# ---------------------------------------------------------------------------
# wavelet denoise (filters/wavelet_denoise.c)
# ---------------------------------------------------------------------------


def wavelet_denoise_tensor(d: torch.Tensor, nb_layers: int = 4,
                           thresholds: Optional[Sequence[float]] = None,
                           mode: str = "soft", use_vst: bool = False,
                           ktype: int = WAVELET_BSPLINE) -> torch.Tensor:
    """Per-layer coefficient thresholding of (C, H, W), clipped to [0, 1].

    threshold_i defaults to 3·σ_i / 2^i where σ_i is the robust noise of
    detail plane i (median |w| / 0.6745).  ``mode``: soft | hard |
    bishrink (bivariate shrink using the parent plane)."""
    if use_vst:
        d = anscombe(d)
    planes = atrous_decompose(d, nb_layers, ktype)
    out_planes = []
    for i in range(nb_layers):
        w = planes[i]
        sigma = median_all(torch.abs(w)) / 0.6745
        t = (thresholds[i] if thresholds and i < len(thresholds)
             else 3.0 * sigma / (1 << i))
        if mode == "hard":
            w2 = torch.where(torch.abs(w) > t, w, 0.0)
        elif mode == "bishrink" and i + 1 < nb_layers:
            parent = planes[i + 1]
            mag = torch.sqrt(w * w + parent * parent)
            shrink = torch.clamp_min(mag - t, 0.0) / torch.clamp_min(mag,
                                                                     1e-9)
            w2 = w * shrink
        else:  # soft
            w2 = torch.sign(w) * torch.clamp_min(torch.abs(w) - t, 0.0)
        out_planes.append(w2)
    out_planes.append(planes[-1])
    out = atrous_reconstruct(out_planes)
    if use_vst:
        out = anscombe_inverse_exact(out)
    return torch.clamp(out, 0.0, 1.0)


def wavelet_denoise(img: SirilImage, nb_layers: int = 4,
                    thresholds: Optional[Sequence[float]] = None,
                    mode: str = "soft", use_vst: bool = False,
                    ktype: int = WAVELET_BSPLINE,
                    device: DeviceLike = None) -> SirilImage:
    out = wavelet_denoise_tensor(upload(img, device), nb_layers, thresholds,
                                 mode, use_vst, ktype)
    return finish(img, out, f"Wavelet denoise ({mode}, {nb_layers} layers)")
