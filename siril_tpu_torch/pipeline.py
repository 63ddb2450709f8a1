"""Fused device-resident preprocessing + stacking — counterpart of
``siril_tpu/pipeline.py`` (``FusedArgs``:60, ``fused_preprocess_stack``:74,
the warp dispatch :270-345, ``_block_stream_fn``:428,
``_device_norm_coeffs``:631).

The whole sequence stays on the device across stages:

  raw u16 upload → device decode → calibration (bias, dark, flat,
  cosmetic correction) → star detection (stats, candidates, batched PSF
  fit) → [host: triangle match + RANSAC] → per-frame IKSS
  estimators → warp → normalize + reject + mean streamed over
  pixel-row blocks (kernel K1a) → one fetch of the result

The warp takes the cheapest rung of the ladder whose gate holds every
frame: translation, then for lanczos4 the FFT rotation three-shear, the
affine chirp-Z and the perspective split (``ops/interp.py``), else the
gather warp; the rung taken is logged.

Frames live as a list of (n_i, L, H, W) chunks; each row block gathers the
same rows of every chunk into one (N, rows·W) stack of about 256 MiB.
Each stage ends with a device synchronize and its seconds are kept in
``StackResult.stage_s``.

Calibration runs on each decoded chunk before detection, as
``siril_tpu/pipeline.py:100-107`` (``_calib_operands``:549,
``_chunk_program_builder``:563-592) with k = 1 for the dark, or the
per-frame dark optimization of the staged ``calibrate`` when asked for
(the JAX fused path ignores it).  Every rejection mode runs; GESDT gets
its outlier budget and λ table as in ``siril_tpu/pipeline.py:366-376``.
Frame weights are not supported on the fused path, as in the JAX package
(its fused block kernel is built without weights,
``siril_tpu/pipeline.py:441-442``).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from siril_tpu_torch.core.sequence import Sequence, raw_chunk_reader
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops.calibration import (
    CalibArgs,
    calibrate_tensor,
    dark_optimization_k,
    prepare_calibration,
)
from siril_tpu_torch.ops import interp
from siril_tpu_torch.ops.normalization import (
    NO_NORM,
    NormCoeffs,
    factors_from_estimators,
)
from siril_tpu_torch.ops.stacking import (
    NO_WEIGHT,
    StackArgs,
    StageClock,
    StackResult,
    decode_i16,
    finalize_metadata,
    make_block_kernel,
    norm_to_0_1_range,
)
from siril_tpu_torch.ops.statistics import norm_estimators
from siril_tpu_torch.registration.matching import (
    SHIFT_TRANSFORMATION,
    match_stars,
)
from siril_tpu_torch.registration.starfinder import (
    StarFinderParams,
    detect_stars_batch,
    detection_radius,
    stats_cand_fit,
)
from siril_tpu_torch.utils.devmem import fused_budget_bytes

_log = logging.getLogger(__name__)

#: bytes of one streamed rejection block (rows = this // (N·W·4))
BLOCK_BYTES = 256 << 20


@dataclass
class FusedArgs:
    calib: Optional[CalibArgs] = None
    register: bool = True
    ttype: int = SHIFT_TRANSFORMATION
    starfinder: StarFinderParams = field(default_factory=StarFinderParams)
    max_stars: int = 500
    min_pairs: int = 4
    interpolation: int = interp.INTERP_LANCZOS4
    clamp: bool = True
    stack: StackArgs = field(default_factory=lambda: StackArgs(
        method="rej", rejection=rj.WINSORIZED))
    frame_chunk: int = 16                # decode/detect batch size


def check_supported(args: FusedArgs) -> None:
    """Raise NotImplementedError for what the port does not cover yet."""
    if args.calib is not None and args.calib.debayer:
        raise NotImplementedError(
            "fusedstack -debayer: the fused path never debayers, as the JAX "
            "package's fusedstack reads no -debayer (siril_tpu/cli/"
            "commands2.py:836-890); run calibrate -debayer, register and "
            "stack instead")
    sa = args.stack
    if sa.method == "rej":
        rj.check_rtype(sa.rejection)
    if sa.weighting != NO_WEIGHT:
        raise NotImplementedError(
            "the fused path stacks without frame weights, as the JAX "
            "package does; use the staged stack command for weights")


def fused_preprocess_stack(seq: Sequence, args: Optional[FusedArgs] = None,
                           device: DeviceLike = None) -> StackResult:
    """Register and stack ``seq`` on ``device`` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    args = args or FusedArgs()
    check_supported(args)
    t0 = time.perf_counter()
    clock = StageClock(dev, "fused.")
    indices = seq.selected_indices()
    n = len(indices)
    if n == 0:
        raise ValueError("no frames selected")
    r0 = seq.open_reader(int(indices[0]))
    L, H, W = r0.nchans, r0.height, r0.width
    # the stack, a chunk in and out of the warp and the stream block, and
    # the warp ladder's transients (one frame's chirp-Z planes)
    need = n * L * H * W * 4 + 3 * args.frame_chunk * L * H * W * 4
    if args.register and args.ttype != SHIFT_TRANSFORMATION:
        need += interp.ladder_transient_bytes(L, H, W)
    if need > fused_budget_bytes(dev):
        raise MemoryError(
            f"fused pipeline needs ~{need >> 30} GiB of device memory; use "
            "the staged calibrate/register/stack commands for this sequence")

    sa = args.stack
    p = args.starfinder
    layer = min(sa.reglayer, L - 1)
    want_detect = args.register and n > 1
    R = detection_radius(H, W, p) if want_detect else 0

    # ---- 1. read + upload + decode + calibrate, detection per chunk -----
    cal = None
    if args.calib is not None:
        with clock("masters"):
            cal = prepare_calibration(args.calib,
                                      seq.read_frame(int(indices[0])), dev)
    frames: List[torch.Tensor] = []
    detect_parts = []
    read_chunk, close_reader = raw_chunk_reader(seq, indices, L, H, W)
    try:
        for start in range(0, n, args.frame_chunk):
            count = len(indices[start:start + args.frame_chunk])
            with clock("read"):
                raw = read_chunk(start, count)
            with clock("upload"):
                x = torch.from_numpy(raw).to(dev)
                x = decode_i16(x) if x.dtype == torch.int16 else x
            if cal is not None:
                with clock("calibrate"):
                    _calibrate_chunk(x, cal, args.calib, seq,
                                     indices[start:start + count])
            frames.append(x)
            if want_detect:
                with clock("detect"):
                    detect_parts.append(stats_cand_fit(
                        x[:, layer], R, int(args.max_stars),
                        float(p.sigma), int(p.profile)))
    finally:
        close_reader(wait=False)

    # ---- 2. registration -------------------------------------------------
    do_norm = sa.normalize != NO_NORM
    coeffs = None
    if want_detect:
        ref_abs = seq.get_reference()
        ref_pos = int(np.nonzero(indices == ref_abs)[0][0]) \
            if ref_abs in list(indices) else 0
        with clock("detect"):
            pre = (torch.cat([d[0] for d in detect_parts], 1).cpu().numpy(),
                   *(torch.cat([d[k] for d in detect_parts]).cpu().numpy()
                     for k in (1, 2, 3)))
            stars_all = detect_stars_batch([c[:, layer] for c in frames], p,
                                           int(args.max_stars), pre)
        ref_stars = stars_all[ref_pos]
        if len(ref_stars) < args.min_pairs:
            raise RuntimeError("not enough stars on the reference frame")

        def _match(k):
            if k == ref_pos:
                return None
            return match_stars(ref_stars, stars_all[k], ttype=args.ttype,
                               min_pairs=args.min_pairs)

        with clock("match"), cf.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4)) as pool:
            matches = list(pool.map(_match, range(n)))
        reg = seq.reg(layer)
        Hs = np.tile(np.eye(3), (n, 1, 1))
        good = np.ones(n, bool)
        for k in range(n):
            idx = int(indices[k])
            if k != ref_pos:
                if matches[k] is None:
                    _log.error("fused: frame %d failed to match; excluded",
                               idx + 1)
                    seq.incl[idx] = False
                    good[k] = False
                    continue
                Hs[k] = matches[k].H
            reg.H[idx] = Hs[k]
            reg.valid[idx] = True
        if not good.all():
            kept, base = [], 0
            for c in frames:
                m = good[base:base + c.shape[0]]
                base += c.shape[0]
                if m.all():
                    kept.append(c)
                elif m.any():
                    kept.append(c[torch.as_tensor(np.nonzero(m)[0],
                                                  device=dev)])
            frames = kept
            Hs = Hs[good]
            indices = indices[good]
            n = len(indices)
        # estimators on the pre-warp frames, as the reference pipeline
        # does (the clamp smooths the background of warped frames)
        if do_norm:
            with clock("normalize"):
                coeffs = _device_norm_coeffs(frames, n, L, sa, seq, indices)
        with clock("warp"):
            _warp_frames(frames, Hs, (H, W), args)

    if coeffs is None:
        with clock("normalize"):
            coeffs = _device_norm_coeffs(frames, n, L, sa, seq, indices) \
                if do_norm else NormCoeffs(np.zeros((L, n)), np.ones((L, n)),
                                           np.ones((L, n)))

    # ---- 3. normalize + reject + mean, streamed over row blocks ---------
    rows = max(1, min(H, BLOCK_BYTES // max(n * W * 4, 1)))
    rtype = sa.rejection if sa.method == "rej" else rj.NO_REJEC
    # GESDT needs its outlier budget and λ table (as the staged path)
    max_outliers, critical = 0, None
    if rtype == rj.GESDT:
        max_outliers = rj.gesdt_max_outliers(n, sa.siglow)
        critical = rj.gesdt_critical_values(n, sa.sighigh, max_outliers)
    kernel = make_block_kernel(rtype, sa.normalize if do_norm else NO_NORM,
                               float(sa.siglow), float(sa.sighigh), n,
                               max_outliers, critical)
    from siril_tpu_torch.kernels import reject_stack as k1

    capped0 = k1.capped_pixels()
    means = []
    tot_l = torch.zeros((), dtype=torch.int64, device=dev)
    tot_h = torch.zeros((), dtype=torch.int64, device=dev)
    with clock("stack"):
        for c in range(L):
            f32 = dict(dtype=torch.float32, device=dev)
            sc = torch.as_tensor(coeffs.scale[c], **f32)
            off = torch.as_tensor(coeffs.offset[c], **f32)
            mu = torch.as_tensor(coeffs.mul[c], **f32)
            for y0 in range(0, H, rows):
                y1 = min(H, y0 + rows)
                block = torch.cat([ch[:, c, y0:y1].reshape(ch.shape[0], -1)
                                   for ch in frames])
                mean, rl, rh = kernel(block, sc, off, mu)
                means.append(mean)
                tot_l += rl
                tot_h += rh
    with clock("fetch"):
        result = torch.cat(means).reshape(L, H, W).cpu().numpy()
        tot = (int(tot_l), int(tot_h))
    del frames
    result = norm_to_0_1_range(result) if sa.output_norm \
        else np.clip(result, 0.0, 1.0)
    img = finalize_metadata(seq, indices, result)
    img.log_history("Fused register+stack (device-resident)")
    _log.info("fused pipeline: %d frames → stack in %.2fs, rejected %d/%d "
              "px", n, time.perf_counter() - t0, *tot)
    capped = k1.capped_pixels() - capped0
    return StackResult(image=img, total_rejected=tot,
                       elapsed_s=time.perf_counter() - t0,
                       stage_s=clock.seconds, capped=capped)


def pick_rung(Hs, size, interpolation: int):
    """The ladder's rung for frame→reference homographies ``Hs`` and its
    parameters: ("translation", shifts), and for lanczos4 ("rotation",
    rot), ("affine", aff) or ("perspective", persp), the first whose gate
    holds every frame; else ("gather", None).  The FFT rungs interpolate
    with exact sinc, so other interpolations take the gather warp
    (siril_tpu/pipeline.py:288-296)."""
    shifts = interp.translations_from_Hs(Hs)
    if shifts is not None:
        return "translation", shifts
    if interpolation == interp.INTERP_LANCZOS4:
        for name, gate in (("rotation", interp.rotations_from_Hs),
                           ("affine", interp.affines_from_Hs),
                           ("perspective", interp.perspective_split_from_Hs)):
            params = gate(Hs, size)
            if params is not None:
                return name, params
    return "gather", None


def _warp_frames(frames: List[torch.Tensor], Hs, size,
                 args: FusedArgs) -> None:
    """Replace each (n_i, L, H, W) chunk of ``frames`` by its frames warped
    by their homographies, on the rung ``pick_rung`` chooses for the whole
    batch (one chunk's input and output live at a time)."""
    rung, params = pick_rung(Hs, size, args.interpolation)
    _log.info("fused: warp rung %s for %d frames", rung, len(Hs))
    base = 0
    for ci, c in enumerate(frames):
        sl = slice(base, base + c.shape[0])
        base += c.shape[0]
        if rung == "translation":
            w = interp.warp_translation_batch(c, params[sl],
                                              args.interpolation, args.clamp)
        elif rung == "rotation":
            w = interp.warp_rotation_batch(
                c, tuple(a[sl] for a in params), clamp=args.clamp)
        elif rung == "affine":
            w = interp.warp_affine_batch(
                c, tuple(a[sl] for a in params), clamp=args.clamp)
        elif rung == "perspective":
            M, b, flip, K, D = params
            w = interp.warp_perspective_batch(
                c, (M[sl], b[sl], flip[sl], K[sl], D), clamp=args.clamp)
        else:
            w = interp.warp_homography_batch(c, Hs[sl], size,
                                             args.interpolation, args.clamp)
        frames[ci] = w


def _calibrate_chunk(x: torch.Tensor, cal: dict, ca: CalibArgs,
                     seq: Sequence, idxs) -> None:
    """Calibrate the decoded (n, L, H, W) chunk in place, a frame at a
    time (k = 1, or each frame's dark optimization)."""
    optim = ca.dark is not None and ca.use_dark_optim
    for j in range(x.shape[0]):
        k = 1.0
        if optim:
            k = dark_optimization_k(
                x[j], cal["dark"], ca.use_exposure,
                seq.read_frame_metadata(int(idxs[j])).exposure,
                ca.dark.keywords.exposure)
        x[j] = calibrate_tensor(x[j], cal, k)


def _device_norm_coeffs(frames, n: int, L: int, sa: StackArgs,
                        seq: Sequence, indices) -> NormCoeffs:
    """Per-frame estimators on the resident frames → offset/scale/mul
    (compute_factors_from_estimators semantics, normalization.c:146)."""
    px = int(np.prod(frames[0].shape[2:]))
    sub = max(1, (512 << 20) // max(px * 4, 1))
    cols = []
    for c in range(L):
        parts = []
        for ch in frames:
            flat = ch[:, c].reshape(ch.shape[0], -1)
            for s0 in range(0, flat.shape[0], sub):
                e = norm_estimators(flat[s0:s0 + sub], lite=sa.lite_norm)
                parts.append(torch.stack([e["location"], e["scale"]]))
        cols.append(torch.cat(parts, dim=1))
    host = torch.stack(cols).cpu().numpy().astype(np.float64)  # [L, 2, N]
    ref_abs = seq.get_reference()
    hit = np.nonzero(indices == ref_abs)[0]
    ref_pos = int(hit[0]) if hit.size else 0
    # the fused path equalizes each layer on itself, as the JAX one does
    offset, scale, mul = factors_from_estimators(
        host[:, 0], host[:, 1], sa.normalize, ref_pos)
    return NormCoeffs(offset, mul, scale)
