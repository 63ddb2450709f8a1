"""Carry configuration and per-frame state from the JAX package to the
port.  There are no learned weights: what crosses is configuration
(``dataclasses.asdict`` of the JAX ``FusedArgs``, ``StackArgs``,
``StarFinderParams``, ``CalibArgs`` and ``RegArgs``;
``dataclasses.asdict`` of the port's own dataclasses goes back), the
calibration masters inside ``CalibArgs`` (``SirilImage`` as a dict: data,
keywords, bit depth, history, WCS) and per-frame data (``NormCoeffs`` arrays,
a sequence's registration data, the GESDT λ table), as plain dicts and
numpy arrays.  This module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from siril_tpu_torch.core.image import Keywords, SirilImage
from siril_tpu_torch.core.sequence import RegData
from siril_tpu_torch.ops.calibration import CalibArgs
from siril_tpu_torch.ops.normalization import NormCoeffs
from siril_tpu_torch.ops.stacking import StackArgs
from siril_tpu_torch.pipeline import FusedArgs
from siril_tpu_torch.registration.global_reg import RegArgs
from siril_tpu_torch.registration.starfinder import StarFinderParams


def _build(cls, d: Mapping):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**dict(d))


def stack_args(d: Mapping) -> StackArgs:
    return _build(StackArgs, d)


def starfinder_params(d: Mapping) -> StarFinderParams:
    return _build(StarFinderParams, d)


def siril_image(d: Mapping) -> SirilImage:
    """An image dict (``dataclasses.asdict`` of either package's
    SirilImage) → the port's SirilImage: its data, the keywords the port
    keeps, the bit depth, the history and the plate solution (``wcs``,
    as the port's ``ops.wcs.WCS``); the JAX package's other fields
    (header text, mask, ICC profile) stay behind."""
    from siril_tpu_torch.ops.wcs import WCS

    names = {f.name for f in dataclasses.fields(Keywords)}
    kw = Keywords(**{k: v for k, v in dict(d.get("keywords") or {}).items()
                     if k in names})
    w = d.get("wcs")
    return SirilImage(data=np.asarray(d["data"], np.float32), keywords=kw,
                      orig_bitdepth=int(d["orig_bitdepth"]),
                      history=list(d.get("history") or []),
                      wcs=_build(WCS, w) if w is not None else None)


def calib_args(d: Mapping) -> CalibArgs:
    d = dict(d)
    for k in ("bias", "dark", "flat"):
        if d.get(k) is not None:
            d[k] = siril_image(d[k])
    return _build(CalibArgs, d)


def reg_args(d: Mapping) -> RegArgs:
    d = dict(d)
    if "starfinder" in d:
        d["starfinder"] = starfinder_params(d["starfinder"])
    return _build(RegArgs, d)


def reg_data(d: Mapping) -> RegData:
    """A layer's registration data (``dataclasses.asdict`` of RegData)
    → the port's RegData, arrays copied with the reference's dtypes."""
    d = dict(d)
    rd = RegData(int(d.pop("n")))
    for k, v in d.items():
        if not hasattr(rd, k):
            raise ValueError(f"RegData: unknown field {k}")
        setattr(rd, k, np.array(v, dtype=getattr(rd, k).dtype))
    return rd


def fused_args(d: Mapping) -> FusedArgs:
    d = dict(d)
    if d.get("calib") is not None:
        d["calib"] = calib_args(d["calib"])
    if "stack" in d:
        d["stack"] = stack_args(d["stack"])
    if "starfinder" in d:
        d["starfinder"] = starfinder_params(d["starfinder"])
    return _build(FusedArgs, d)


def norm_coeffs(offset, mul, scale) -> NormCoeffs:
    """(L, N) normalization coefficient arrays → NormCoeffs (float64)."""
    arrs = [np.asarray(a, np.float64) for a in (offset, mul, scale)]
    if arrs[0].ndim != 2 or any(a.shape != arrs[0].shape for a in arrs):
        raise ValueError("offset, mul and scale must share an (L, N) shape")
    return NormCoeffs(*arrs)


def homographies(H) -> np.ndarray:
    """Registration homographies → (N, 3, 3) float64."""
    H = np.asarray(H, np.float64)
    if H.ndim != 3 or H.shape[1:] != (3, 3):
        raise ValueError(f"homographies must be (N, 3, 3), got {H.shape}")
    return H.copy()


def gesdt_table(critical, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """GESDT λ table → float32 tensor (the ``critical`` input of the
    GESDT kernel, K1d)."""
    return torch.as_tensor(np.asarray(critical, np.float32), device=device)
