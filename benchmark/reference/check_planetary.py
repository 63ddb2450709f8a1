"""The comparison that decides ``correct`` in a planetary cell.

The reference reads the SER itself and recomputes in float64
(``reference/planetary.py``); it is held against the image ``mpp`` wrote
and the state it kept in its ``.mpp`` sidecar:

- ``quality_rel``: the largest relative gap of a frame's quality, or of
  an alignment point's patch quality, from the reference's.
- ``global_shift_max_px``: the largest distance of a frame's global
  shift from the reference's own phase correlation against its own best
  frame.
- ``image_mean_abs`` and ``image_tile_max``: the mean absolute
  difference of the written image from the reference's stack, over the
  image and at its worst 32×32 tile.  The reference stacks with the
  program's alignment-point grid and shifts, which it follows.
- ``ap_field_rms_px``: those alignment-point shifts against the local
  field the generator drew (RMS over the solved points on the disc), as
  the bring-up proof measured them.

``control`` puts the reference with bfloat16 data in the program's place
(alignment points on a plain grid over the disc, their shifts 0), for
the limits' upper readings."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from benchmark.gen.planet import full_field
from benchmark.reference import planetary as pl
from benchmark.reference.check_deepsky import TILE, tile_max
from benchmark.reference.fitsread import read_image
from benchmark.reference.serread import open_video


def _params(traffic) -> pl.MppParams:
    a = traffic["check_args"]
    return pl.MppParams(ap_size=a["ap_size"],
                        global_best_pct=a["global_best_pct"],
                        stack_best_pct=a["stack_best_pct"])


def box_field(coarse, ap_xy, S: int, h: int, w: int) -> np.ndarray:
    """(n, A, 2): each frame's local field averaged over each AP box."""
    oy, ox = pl.origins(ap_xy, S, h, w)
    out = np.zeros((coarse.shape[0], len(ap_xy), 2))
    for b0 in range(0, coarse.shape[0], 100):
        f = full_field(coarse[b0:b0 + 100], h, w)
        for a in range(len(ap_xy)):
            out[b0:b0 + 100, a] = f[:, :, oy[a]:oy[a] + S,
                                    ox[a]:ox[a] + S].mean(
                dim=(2, 3)).double().cpu().numpy()
        del f
    return out


def ap_field_rms(cfg, truth, q, gshifts, ap_xy, ap_shifts, S: int,
                 best_pct: float) -> float:
    """RMS of the AP shifts against what the drawn fields make them:
    lx = −(ε_i + L_i − the mean over the reference frames of (ε_j +
    L_j)), ε the global shift's error, L the box's mean local field;
    over the (frame, AP) pairs on the disc whose solve succeeded."""
    h, w = int(cfg["height"]), int(cfg["width"])
    best = int(np.argmax(q))
    want = -(truth["drift"] - truth["drift"][best])
    disp = (gshifts - want)[:, None, :] + box_field(truth["coarse"], ap_xy,
                                                    S, h, w)
    n = len(q)
    ref = np.argsort(-q)[:max(int(round(n * best_pct / 100.0)), 1)]
    expect = -(disp - disp[ref].mean(0)[None])
    r = np.hypot(ap_xy[:, 0] - w / 2.0, ap_xy[:, 1] - h / 2.0)
    on_disc = r < float(cfg["disc_radius_px"]) * 0.93 - S / 2
    solved = (ap_shifts != 0).any(-1) & on_disc[None]
    if not solved.any():
        return float("inf")
    d = (ap_shifts - expect)[solved]
    return float(np.sqrt((d ** 2).sum(-1).mean()))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _numbers(cfg, traffic, truth, video, dev, q, g, apq, image, ap_xy,
             ap_shifts, with_field: bool) -> Dict[str, float]:
    p = _params(traffic)
    rq, rg = pl.analyse(video, dev, p)
    rref = pl.reference_image(video, rq, g, dev, p)
    rapq = pl.patch_quality(video, g, ap_xy, dev, p)
    rimg = pl.stack(video, g, ap_xy, ap_shifts, apq, rref, dev, p)
    diff = np.abs(np.asarray(image, np.float64) - rimg)
    out = {"quality_rel": max(_rel(q, rq), _rel(apq, rapq)),
           "global_shift_max_px": float(np.abs(g - rg).max()),
           "image_mean_abs": float(diff.mean()),
           "image_tile_max": tile_max(diff, TILE)}
    if with_field:
        out["ap_field_rms_px"] = ap_field_rms(
            cfg, truth, q, g, ap_xy, ap_shifts, p.ap_size,
            p.global_best_pct)
    return out


def judge(cfg, traffic, truth, workdir, outputs, dev) -> Dict[str, float]:
    """The numbers of what ``mpp`` wrote: ``outputs['image']`` and the
    sidecar ``outputs['sidecar']``."""
    video = open_video(os.path.join(workdir, traffic["sequence"] + ".ser"))
    z = np.load(outputs["sidecar"])
    image = read_image(outputs["image"])
    return _numbers(cfg, traffic, truth, video, dev, z["quality"],
                    z["global_shifts"], z["ap_quality"], image,
                    np.asarray(z["ap_xy"], float), z["ap_shifts"], True)


def plain_grid(cfg, S: int) -> np.ndarray:
    """Alignment points every S/2 px whose boxes lie on the disc."""
    h, w = int(cfg["height"]), int(cfg["width"])
    r = float(cfg["disc_radius_px"]) * 0.93 - S / 2
    pts = [(x, y) for y in range(S // 2, h - S // 2 + 1, S // 2)
           for x in range(S // 2, w - S // 2 + 1, S // 2)
           if np.hypot(x - w / 2.0, y - h / 2.0) < r]
    return np.array(pts, float)


def control(cfg, traffic, truth, workdir, dev,
            dtype=torch.bfloat16) -> Dict[str, float]:
    """The numbers of the reference with ``dtype`` data put in the
    program's place."""
    p = _params(traffic)
    video = open_video(os.path.join(workdir, traffic["sequence"] + ".ser"))
    q, g = pl.analyse(video, dev, p, dtype)
    ap_xy = plain_grid(cfg, p.ap_size)
    ap_shifts = np.zeros((len(q), len(ap_xy), 2))
    ref = pl.reference_image(video, q, g, dev, p, dtype)
    apq = pl.patch_quality(video, g, ap_xy, dev, p, dtype)
    image = pl.stack(video, g, ap_xy, ap_shifts, apq, ref, dev, p, dtype)
    return _numbers(cfg, traffic, truth, video, dev, q, g, apq, image,
                    ap_xy, ap_shifts, False)
