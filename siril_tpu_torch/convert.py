"""Carry configuration and per-frame state from the JAX package to the
port.  There are no learned weights: what crosses is configuration
(``dataclasses.asdict`` of the JAX ``FusedArgs``, ``StackArgs`` and
``StarFinderParams``; ``dataclasses.asdict`` of the port's own dataclasses
goes back) and per-frame data (``NormCoeffs`` arrays,
registration homographies, the GESDT λ table), as plain dicts and numpy
arrays.  This module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from siril_tpu_torch.ops.normalization import NormCoeffs
from siril_tpu_torch.ops.stacking import StackArgs
from siril_tpu_torch.pipeline import FusedArgs
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


def fused_args(d: Mapping) -> FusedArgs:
    d = dict(d)
    if d.get("calib") is not None:
        raise NotImplementedError(
            "calibration arguments are not ported yet (ROADMAP §1, "
            "calibration + cosmetic)")
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
