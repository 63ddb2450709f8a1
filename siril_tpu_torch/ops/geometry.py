"""Geometry — counterpart of ``siril_tpu/ops/geometry.py``
(``resample``:102): the resampling that ``seqextract_Ha -upscale`` takes,
on the gather warp (``ops/interp.resize``).  The other operations of the
reference's module (crop, rotate, mirror, binning) are not ported yet
(ROADMAP §1.5, the image ops).
"""

from __future__ import annotations

import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.interp import INTERP_LANCZOS4, resize


def resample(img: SirilImage, to_w: int, to_h: int,
             method: int = INTERP_LANCZOS4, clamp: bool = True,
             device: DeviceLike = None) -> SirilImage:
    """``img`` scaled to ``to_w`` × ``to_h`` on ``device`` (CUDA unless
    "cpu")."""
    x = torch.from_numpy(img.host()).to(resolve_device(device))
    out = img.copy(data=resize(x, to_w, to_h, method, clamp).cpu().numpy())
    out.log_history(f"Resample to {to_w}x{to_h}")
    return out
