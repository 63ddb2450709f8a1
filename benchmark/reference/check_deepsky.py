"""The comparison that decides ``correct`` in a deep-sky cell.

The reference reads the cell's input files itself, recomputes every
stage of the stack in float64 (``reference/deepsky.py``) and is held
against what the timed path wrote and returned:

- ``image_mean_abs``: the mean absolute difference of the stacked image
  the program wrote and the reference's, over every pixel.  It covers
  the calibration with the masters, the cosmetic correction, the
  estimators and normalization coefficients, the warp, the rejection and
  the mean: a coefficient off by δ on one frame moves the mean by δ/N.
- ``image_tile_max``: the largest mean absolute difference over the
  image's 32×32 tiles: a fault in a few rows or one region, which the
  mean over the image dilutes, shows here; a pixel where the two sides'
  rejection decided otherwise moves its tile by ~1e-6.
- ``rejected_rel``: the program's rejected totals (low, high) against
  the reference's, the larger relative gap.
- ``shift_max_px`` (registered cells): the largest distance of a frame's
  shift, as the program's registration found it, from the dither the
  generator drew.  The reference follows the program's shifts in its
  warp, so this number checks the registration on its own.

``control`` puts the reference computed in bfloat16 in the program's
place (shifts from the truth), for the limits' upper readings."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import deepsky
from benchmark.reference.fitsread import read_image


TILE = 32


def tile_max(diff: np.ndarray, t: int) -> float:
    """The largest mean of ``diff`` over t×t tiles (the edge tiles
    partial)."""
    H, W = diff.shape
    pad = np.zeros((-(-H // t) * t, -(-W // t) * t))
    cnt = np.zeros_like(pad)
    pad[:H, :W] = diff
    cnt[:H, :W] = 1.0
    s = pad.reshape(pad.shape[0] // t, t, -1, t).sum(axis=(1, 3))
    c = cnt.reshape(cnt.shape[0] // t, t, -1, t).sum(axis=(1, 3))
    return float((s / c).max())


def _params(traffic) -> deepsky.StackParams:
    a = traffic["check_args"]
    return deepsky.StackParams(norm=a["norm"], siglow=a["siglow"],
                               sighigh=a["sighigh"], ref_frame=0)


def _frames(cfg, traffic, workdir, dev, dtype):
    """The calibrated frames, in file order, on ``dev`` in ``dtype``."""
    a = traffic["check_args"]

    def load(name):
        return torch.from_numpy(np.ascontiguousarray(read_image(
            os.path.join(workdir, name + ".fit")))).to(dev, dtype)

    m = {k: load(k) for k in traffic["masters"]}
    hot = deepsky.hot_pixels(m["dark"], a["sig_hot"]) \
        if a["cosmetic"] else None
    n = int(cfg[traffic["frames_key"]])
    return [deepsky.calibrate(load(f"{a['prefix']}{k + 1:05d}"),
                              m.get("bias"), m.get("dark"), m.get("flat"),
                              hot) for k in range(n)]


def true_shifts(truth) -> np.ndarray:
    """The shift (dx, dy) frame → reference that registration should
    find: the reference frame's dither less the frame's."""
    d = np.asarray(truth["shifts"], np.float64)
    return d[0][None] - d


def reference_stack(cfg, traffic, workdir, shifts, dev,
                    dtype=torch.float64) -> deepsky.Stacked:
    frames = _frames(cfg, traffic, workdir, dev, dtype)
    register = traffic["check_args"]["register"]
    return deepsky.stack(frames, shifts if register else None,
                         _params(traffic))


def numbers(cfg, traffic, truth, image: np.ndarray, rejected,
            shifts: Optional[np.ndarray], ref: deepsky.Stacked
            ) -> Dict[str, float]:
    diff = np.abs(image.astype(np.float64) - ref.image)
    out = {"image_mean_abs": float(diff.mean()),
           "image_tile_max": tile_max(diff, TILE)}
    gaps = [abs(int(p) - int(r)) / max(int(r), 1)
            for p, r in zip(rejected, ref.rejected)]
    out["rejected_rel"] = float(max(gaps))
    if traffic["check_args"]["register"]:
        err = np.hypot(*(shifts - true_shifts(truth)).T)
        out["shift_max_px"] = float(np.nanmax(np.where(
            np.isfinite(err), err, np.inf)))
    return out


def judge(cfg, traffic, truth, workdir, outputs, dev) -> Dict[str, float]:
    """The numbers of the program's outputs (``image``: the path of the
    stacked FITS; ``rejected``: (low, high); ``shifts``: (N, 2))."""
    shifts = outputs.get("shifts")
    ref = reference_stack(cfg, traffic, workdir, shifts, dev)
    image = read_image(outputs["image"])
    return numbers(cfg, traffic, truth, image, outputs["rejected"], shifts,
                   ref)


def control(cfg, traffic, truth, workdir, dev,
            dtype=torch.bfloat16) -> Dict[str, float]:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place, its shifts the true ones."""
    shifts = true_shifts(truth) if traffic["check_args"]["register"] \
        else None
    low = reference_stack(cfg, traffic, workdir, shifts, dev, dtype)
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    ref = reference_stack(cfg, traffic, workdir, shifts, dev)
    return numbers(cfg, traffic, truth, low.image, low.rejected, shifts, ref)
