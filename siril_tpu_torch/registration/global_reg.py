"""Global star-alignment registration — counterpart of
``siril_tpu/registration/global_reg.py`` (``RegArgs``:46,
``_frame_metrics``:64, ``register_sequence``:76, ``_pick_best_reference``
:181, ``ApplyRegArgs``:214, ``compute_framing``:224, ``apply_reg_sequence``
:264, ``_register_batched``:334; reference ``src/registration/global.c``
and ``applyreg.c``).

Per frame: star detection on the device → triangle match + RANSAC H
against the reference frame (host numpy) → the frame metrics
(FWHM_stats, star_finder.c:770; weighted FWHM, global.c:1135-1137) →
with an output, the gather warp into a new ``r_`` sequence.  ``-2pass``
and ``-noout`` keep only the transforms, detected a chunk of frames at a
time through the fused path's decode and ``stats_cand_fit``.
``-drizzle`` keeps the transforms the same way and drizzles each frame
(``cli/commands._drizzle_out_sequence``).  ``seqapplyreg`` (and
``register -disto=``) warps with a master's SIP distortion in the same
sampling pass when ``ApplyRegArgs.disto_file`` names one
(``ops/interp.warp_homography_sip``, JAX ``global_reg.py:277-310``).
The transforms of ``-3stars`` come from ``registration/threestars.py``,
those of a plate-solved mosaic from ``registration/astrometric.py``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from siril_tpu_torch.core.sequence import Sequence, raw_chunk_reader
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.interp import (
    INTERP_LANCZOS4,
    warp_homography,
    warp_homography_sip,
)
from siril_tpu_torch.ops.stacking import StageClock
from siril_tpu_torch.registration.matching import (
    HOMOGRAPHY_TRANSFORMATION,
    match_stars,
)
from siril_tpu_torch.registration.psf import PSFStar
from siril_tpu_torch.registration.starfinder import (
    StarFinderParams,
    detect_stars,
    save_star_list_csv,
)

_log = logging.getLogger(__name__)

# framing policies (registration.h:55-60)
FRAMING_CURRENT = 0
FRAMING_MAX = 1
FRAMING_MIN = 2
FRAMING_COG = 3

FRAMING_NAMES = {"current": FRAMING_CURRENT, "max": FRAMING_MAX,
                 "min": FRAMING_MIN, "cog": FRAMING_COG}


@dataclass
class RegArgs:
    reglayer: int = 0
    ttype: int = HOMOGRAPHY_TRANSFORMATION
    two_pass: bool = False
    output: bool = True                 # warp & write the r_ sequence
    prefix: str = "r_"
    interpolation: int = INTERP_LANCZOS4
    clamp: bool = True
    framing: int = FRAMING_CURRENT
    min_pairs: int = 10
    max_stars: int = 2000
    starfinder: StarFinderParams = field(default_factory=StarFinderParams)
    follow_star: bool = False
    scale: float = 1.0                  # output upscale (register -scale=)
    extref: str = ""                    # external reference image path
    save_starlists: bool = False        # write per-frame .lst star lists


def _frame_metrics(stars: List[PSFStar]):
    """FWHM_stats: mean fwhm / background over non-saturated stars."""
    good = [s for s in stars if not s.has_saturated] or stars
    if not good:
        return 0.0, 0.0, 0.0
    fx = float(np.mean([s.fwhmx for s in good]))
    fy = float(np.mean([s.fwhmy for s in good]))
    b = float(np.mean([s.B for s in good]))
    return fx, (fy / fx if fx > 0 else 0.0), b


def _record(reg, idx: int, stars, nb_ref: int) -> None:
    fwhm, rnd, bg = _frame_metrics(stars)
    reg.fwhm[idx] = fwhm
    reg.roundness[idx] = rnd
    reg.background_lvl[idx] = bg
    reg.number_of_stars[idx] = len(stars)
    reg.weighted_fwhm[idx] = (2.0 * fwhm * (nb_ref - len(stars)) / nb_ref
                              + fwhm) if nb_ref else fwhm


_METRICS = ("fwhm", "weighted_fwhm", "roundness", "background_lvl",
            "number_of_stars")


def _copy_metrics(src, dst, sel, number: int, cols=_METRICS) -> None:
    """Metrics of the selected input frames onto the output sequence's
    frames, with identity transforms."""
    for k, idx in enumerate(sel[:number]):
        for col in cols:
            getattr(dst, col)[k] = getattr(src, col)[idx]
        dst.valid[k] = True


def register_sequence(seq: Sequence, args: Optional[RegArgs] = None,
                      device: DeviceLike = None):
    """``register`` (global star alignment) on ``device``."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence

    dev = resolve_device(device)
    args = args or RegArgs()
    clock = StageClock(dev)
    ref_idx = seq.get_reference()
    if args.extref:
        from siril_tpu_torch.io.conversion import load_any

        ref_img = load_any(args.extref)
    else:
        ref_img = seq.read_frame(ref_idx)
    if seq.nb_layers < 0:
        seq.nb_layers = ref_img.nchans
    layer = min(args.reglayer, ref_img.nchans - 1)

    def detect(img):
        with clock("detect"):
            return detect_stars(torch.from_numpy(img.host()[layer]).to(dev),
                                args.starfinder, max_stars=args.max_stars)

    ref_stars = detect(ref_img)
    if len(ref_stars) < args.min_pairs:
        raise RuntimeError(
            f"not enough stars on reference frame ({len(ref_stars)})")
    _log.info("Reference frame %d: %d stars", ref_idx, len(ref_stars))
    nb_ref = len(ref_stars)
    reg = seq.reg(layer)
    if args.two_pass or not args.output:
        return _register_batched(seq, args, layer, ref_idx, ref_stars, dev,
                                 clock)

    def warp(img, H, out_shape):
        with clock("warp"):
            x = torch.from_numpy(img.host()).to(dev)
            return warp_homography(x, H, out_shape, args.interpolation,
                                   args.clamp).cpu().numpy()

    def image(ctx, idx, img):
        stars = detect(img)
        _record(reg, idx, stars, nb_ref)
        if args.save_starlists:
            save_star_list_csv(stars, os.path.join(
                seq.directory, f"{seq.name}{idx + 1:05d}.lst"))
        if idx == ref_idx and not args.extref:
            reg.H[idx] = np.eye(3)
            reg.valid[idx] = True
            if args.scale != 1.0:
                S = np.diag([args.scale, args.scale, 1.0])
                return img.copy(data=warp(img, S, (int(seq.ry * args.scale),
                                                   int(seq.rx * args.scale))))
            return img
        with clock("match"):
            m = match_stars(ref_stars, stars, ttype=args.ttype,
                            min_pairs=min(args.min_pairs, 4))
        if m is None or m.inliers < min(args.min_pairs, 4):
            _log.error("frame %d: matching failed (%d pairs)", idx,
                       0 if m is None else m.inliers)
            seq.incl[idx] = False
            return None
        reg.H[idx] = m.H
        reg.valid[idx] = True
        H = m.H
        out_shape = (seq.ry, seq.rx)
        if args.scale != 1.0:
            H = np.diag([args.scale, args.scale, 1.0]) @ H
            out_shape = (int(seq.ry * args.scale), int(seq.rx * args.scale))
        out = img.copy(data=warp(img, H, out_shape))
        out.log_history("Registration with global star alignment")
        return out

    res = run_sequence(SeqArgs(seq=seq, description="Global star "
                               "registration", prefix=args.prefix,
                               image=image, stage_s=clock.seconds))
    seq.save()
    if res.new_seq is not None:
        _copy_metrics(reg, res.new_seq.reg(layer), list(
            seq.selected_indices()), res.new_seq.number)
        res.new_seq.reference_image = 0
        res.new_seq.save()
    return res


def _pick_best_reference(seq: Sequence, layer: int) -> None:
    """2-pass best reference (global.c:1085): among frames with at least
    half the most stars, the least 2·fwhm·(max−n)/max + fwhm."""
    reg = seq.reg(layer)
    valid = reg.valid & seq.incl
    if not valid.any():
        return
    maxstars = int(reg.number_of_stars[valid].max())
    scores = np.full(seq.number, np.inf)
    for i in np.nonzero(valid)[0]:
        n = reg.number_of_stars[i]
        if maxstars and n >= maxstars / 2:
            scores[i] = 2.0 * reg.fwhm[i] * (maxstars - n) / maxstars \
                + reg.fwhm[i]
    best = int(np.argmin(scores))
    if np.isfinite(scores[best]):
        if best != seq.get_reference():
            # rebase: H_i ← H_best⁻¹ · H_i (all map frame → old ref)
            Hn_inv = np.linalg.inv(reg.H[best].copy())
            for i in np.nonzero(reg.valid)[0]:
                reg.H[i] = Hn_inv @ reg.H[i]
        seq.reference_image = best
        _log.info("2-pass registration: best reference is frame %d", best)


@dataclass
class ApplyRegArgs:
    reglayer: int = 0
    prefix: str = "r_"
    interpolation: int = INTERP_LANCZOS4
    clamp: bool = True
    framing: int = FRAMING_CURRENT
    scale: float = 1.0
    disto_file: str = ""                # master with a SIP solution


def _disto_master(path: str):
    """(A, B, frame, invert) of a ``-disto=`` master: its inverse
    polynomials AP/BP when it has them, else the forward A/B, inverted
    in the warp (registration/distorsion.c)."""
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.ops.wcs import sip_frame

    w = load_any(path).wcs
    if w is None or w.sip_a is None:
        raise RuntimeError(f"-disto master has no SIP solution: {path}")
    frame = sip_frame(w.crpix, w.height)
    _log.info("Applying SIP distortion (order %d) from the master",
              w.sip_a.shape[0] - 1)
    if w.sip_ap is not None and w.sip_bp is not None:
        return w.sip_ap, w.sip_bp, frame, False
    return w.sip_a, w.sip_b, frame, True


def compute_framing(seq: Sequence, layer: int, framing: int,
                    scale: float = 1.0):
    """Output geometry and the translation+scale onto it (applyreg.c
    framing max/min/cog: the frame corners through each H)."""
    reg = seq.reg(layer)
    W, H_ = seq.rx, seq.ry
    corners = np.array([[0, 0], [W, 0], [0, H_], [W, H_]], float)
    boxes = []
    for i in seq.selected_indices():
        if not reg.valid[i]:
            continue
        q = np.c_[corners, np.ones(4)] @ reg.H[i].T
        q = q[:, :2] / q[:, 2:3]
        boxes.append((q[:, 0].min(), q[:, 1].min(), q[:, 0].max(),
                      q[:, 1].max()))
    boxes = np.array(boxes) if boxes else np.array([[0, 0, W, H_]])
    if framing == FRAMING_MAX:
        x0, y0 = boxes[:, 0].min(), boxes[:, 1].min()
        x1, y1 = boxes[:, 2].max(), boxes[:, 3].max()
    elif framing == FRAMING_MIN:
        x0, y0 = boxes[:, 0].max(), boxes[:, 1].max()
        x1, y1 = boxes[:, 2].min(), boxes[:, 3].min()
        if x1 <= x0 or y1 <= y0:
            x0, y0, x1, y1 = 0, 0, W, H_
    elif framing == FRAMING_COG:
        x0 = boxes[:, [0, 2]].mean() - W / 2
        y0 = boxes[:, [1, 3]].mean() - H_ / 2
        x1, y1 = x0 + W, y0 + H_
    else:
        x0, y0, x1, y1 = 0, 0, W, H_
    out_w = max(int(round((x1 - x0) * scale)), 1)
    out_h = max(int(round((y1 - y0) * scale)), 1)
    T = np.array([[scale, 0, -x0 * scale],
                  [0, scale, -y0 * scale],
                  [0, 0, 1.0]])
    return out_w, out_h, T


def apply_reg_sequence(seq: Sequence, args: Optional[ApplyRegArgs] = None,
                       device: DeviceLike = None):
    """``seqapplyreg``: warp every selected frame by its stored H."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence

    dev = resolve_device(device)
    args = args or ApplyRegArgs()
    clock = StageClock(dev)
    layer = args.reglayer
    if not seq.has_reg(layer):
        raise RuntimeError("sequence has no registration data")
    reg = seq.reg(layer)
    out_w, out_h, T = compute_framing(seq, layer, args.framing, args.scale)
    _log.info("Applying registration: output %dx%d", out_w, out_h)
    sip = _disto_master(args.disto_file) if args.disto_file else None

    def image(ctx, idx, img):
        if not reg.valid[idx]:
            return None
        with clock("warp"):
            x = torch.from_numpy(img.host()).to(dev)
            Hm = T @ reg.H[idx]
            if sip is None:
                w = warp_homography(x, Hm, (out_h, out_w),
                                    args.interpolation, args.clamp)
            else:
                w = warp_homography_sip(x, Hm, sip[0], sip[1], sip[2],
                                        (out_h, out_w), args.interpolation,
                                        args.clamp, invert=sip[3])
            out = img.copy(data=w.cpu().numpy())
        out.log_history("Applied existing registration")
        return out

    res = run_sequence(SeqArgs(seq=seq, description="Apply registration",
                               prefix=args.prefix, image=image,
                               stage_s=clock.seconds))
    if res.new_seq is not None:
        _copy_metrics(reg, res.new_seq.reg(layer),
                      [i for i in seq.selected_indices() if reg.valid[i]],
                      res.new_seq.number,
                      tuple(c for c in _METRICS if c != "background_lvl"))
        res.new_seq.save()
    return res


def _register_batched(seq: Sequence, args: RegArgs, layer: int,
                      ref_idx: int, ref_stars, dev: torch.device, clock):
    """Transform-only registration (pass 1 of ``-2pass``, ``-noout``):
    frames read a chunk at a time, decoded on the device, and their stars
    detected for the whole chunk (``stats_cand_fit`` +
    ``detect_stars_batch``); matching on the host."""
    from siril_tpu_torch.core.engine import SeqResult
    from siril_tpu_torch.ops.stacking import decode_i16
    from siril_tpu_torch.registration.starfinder import (
        detect_stars_batch,
        detection_radius,
        stats_cand_fit,
    )

    indices = seq.selected_indices()
    reg = seq.reg(layer)
    nb_ref = len(ref_stars)
    chunk = 16
    first = seq.read_frame(int(indices[0]))
    L, H, W = first.nchans, first.height, first.width
    p = args.starfinder
    R = detection_radius(H, W, p)
    res = SeqResult()
    read_chunk, close = raw_chunk_reader(seq, indices, L, H, W)
    try:
        for start in range(0, len(indices), chunk):
            idxs = [int(i) for i in indices[start:start + chunk]]
            with clock("read"):
                raw = read_chunk(start, len(idxs))
            with clock("detect"):
                x = torch.from_numpy(raw).to(dev)
                x = decode_i16(x) if x.dtype == torch.int16 else x
                pre = tuple(a.cpu().numpy() for a in stats_cand_fit(
                    x[:, layer], R, int(args.max_stars), float(p.sigma),
                    int(p.profile)))
                stars_all = detect_stars_batch([x[:, layer]], p,
                                               int(args.max_stars), pre)
            for idx, stars in zip(idxs, stars_all):
                if args.save_starlists:
                    save_star_list_csv(stars, os.path.join(
                        seq.directory, f"{seq.name}{idx + 1:05d}.lst"))
                _record(reg, idx, stars, nb_ref)
                if idx == ref_idx and not args.extref:
                    reg.H[idx] = np.eye(3)
                    reg.valid[idx] = True
                    res.processed += 1
                    continue
                with clock("match"):
                    m = match_stars(ref_stars, stars, ttype=args.ttype,
                                    min_pairs=min(args.min_pairs, 4))
                if m is None or m.inliers < min(args.min_pairs, 4):
                    _log.error("frame %d: matching failed (%d pairs)", idx,
                               0 if m is None else m.inliers)
                    seq.incl[idx] = False
                    continue
                reg.H[idx] = m.H
                reg.valid[idx] = True
                res.processed += 1
    finally:
        close(wait=False)
    if args.two_pass:
        _pick_best_reference(seq, layer)
    seq.save()
    _log.info("Registration (transform-only): %d frames", res.processed)
    res.stage_s = clock.seconds
    return res
