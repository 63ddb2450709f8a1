"""Stacking — counterpart of ``siril_tpu/ops/stacking.py``: the staged
``stack_sequence`` (:332) with its row-block planner ``plan_blocks``
(:91), shift-only registration in block assembly (``_frame_shifts``:286,
``_read_block``:304), frame weights (``compute_weights``:219), the
device-resident path (``_resident_stack``:623, ``_resident_fill_stats``:
777) and the streamed row-block loop (:407-489); and the pieces the fused
path shares: ``StackArgs``/``StackResult`` (:56/:78), ``_norm_apply``
(:105), ``make_block_kernel`` (:120), ``median_stack``
(``ops/rejection.py:646``), ``norm_to_0_1_range`` (:508) and
``_finalize_metadata`` (:576).

Every rejection mode and the weighted mean run in kernel K1
(``kernels/reject_stack.py``) on the card, or its plain version on the
CPU.  Also: the sum/min/max stacks with ``maximize`` framing
(``_stack_accumulate``:519, ``_shift_into``:563), on the device, the sum
in float64; seam feathering (``compute_feather_masks``:191), whose masks
multiply into K1e's per-pixel weights on the streamed path (:452-461);
and the overlap normalization of mosaics on the streamed path
(``ops/normalization.compute_overlap_normalization``).
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
from siril_tpu_torch.core.processing import check_cancelled
from siril_tpu_torch.core.sequence import SEQ_FITSEQ, SEQ_REGULAR
from siril_tpu_torch.device import DeviceLike, resolve_device, synchronize
from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops.normalization import (
    ADDITIVE,
    ADDITIVE_SCALING,
    NO_NORM,
    NormCoeffs,
    cache_estimators,
    compute_normalization,
    compute_overlap_normalization,
    has_estimators,
)
from siril_tpu_torch.utils.devmem import resident_budget_bytes

# weighting types (stacking.h:48-52)
NO_WEIGHT = 0
NBSTARS_WEIGHT = 1
WFWHM_WEIGHT = 2
NOISE_WEIGHT = 3
NBSTACK_WEIGHT = 4

#: method marker of the median stack (no rejection kernel)
MEDIAN = -1

_INV_U16 = float(np.float32(1.0 / 65535.0))


@dataclass
class StackArgs:
    method: str = "rej"                 # sum | min | max | med | mean | rej
    rejection: int = rj.WINSORIZED
    siglow: float = 3.0
    sighigh: float = 3.0
    normalize: int = NO_NORM
    lite_norm: bool = False
    force_norm: bool = False
    equalize_rgb: bool = False
    weighting: int = NO_WEIGHT
    create_rejmaps: bool = False
    merge_rejmaps: bool = False
    output_norm: bool = False
    use_32bit: bool = True
    reglayer: int = 0
    block_mb: int = 2048                # device budget per block (MB)
    feather_dist: int = 0
    overlap_norm: bool = False
    maximize: bool = False


@dataclass
class StackResult:
    image: SirilImage
    rejmap_low: Optional[SirilImage] = None
    rejmap_high: Optional[SirilImage] = None
    total_rejected: Tuple[int, int] = (0, 0)
    elapsed_s: float = 0.0
    #: seconds per stage, each ended by a device synchronize
    stage_s: Dict[str, float] = field(default_factory=dict)
    #: loops stopped at their mode's bound (``kernels/reject_stack.
    #: capped_pixels``): the reference would have run them on
    capped: int = 0


class StageClock:
    """Seconds per named stage, each stage ended by a device sync; each
    stage is also a ``utils.trace.stage`` named ``prefix + name`` (the
    JAX package's ``stack.*`` and ``fused.*`` stages,
    siril_tpu/ops/stacking.py:682, siril_tpu/pipeline.py:101)."""

    def __init__(self, device: torch.device, prefix: str = "stack."):
        self.device = device
        self.prefix = prefix
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        from siril_tpu_torch.utils.trace import stage

        t = time.perf_counter()
        with stage(self.prefix + name):
            yield
            synchronize(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + \
            time.perf_counter() - t


def decode_i16(raw: torch.Tensor) -> torch.Tensor:
    """Raw FITS i16 (BZERO 32768) → [0, 1] float32
    (image_format_fits.c:449)."""
    return (raw.float() + 32768.0) * _INV_U16


def norm_apply(stack: torch.Tensor, scale: torch.Tensor,
               offset: torch.Tensor, mul: torch.Tensor,
               mode: int) -> torch.Tensor:
    """Per-frame normalization of an (N, P) stack.  Additive modes compute
    ``x·scale − offset`` as one fused multiply-add (as XLA does) and keep
    zeros at zero; multiplicative modes compute ``x·scale·mul``."""
    if mode == NO_NORM:
        return stack
    if mode in (ADDITIVE, ADDITIVE_SCALING):
        out = rj.fma(stack, scale[:, None], -offset[:, None])
        return torch.where(stack != 0.0, out, 0.0)
    return stack * scale[:, None] * mul[:, None]


def normalize_block(stack: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, mul: torch.Tensor,
                    mode: int) -> torch.Tensor:
    """Decode (int16 input) and normalize an (N, P) block as kernel K1
    does.  With int16 input and a normalization, the decode's 1/65535
    folds into the per-frame scale — ``(raw + 32768)·(scale/65535)`` — the
    association XLA compiles the reference's decode-then-normalize into."""
    if stack.dtype == torch.int16 and mode != NO_NORM:
        x = stack.float() + 32768.0
        scale = scale * _INV_U16
    elif stack.dtype == torch.int16:
        x = decode_i16(stack)
    else:
        x = stack.float()
    return norm_apply(x, scale, offset, mul, mode)


def reject_stack_plain(stack: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor, mul: torch.Tensor, *,
                       rtype: int, mode: int, siglow: float, sighigh: float,
                       weights: Optional[torch.Tensor] = None,
                       critical=None, n_full: int = 0,
                       max_outliers: int = 0, work: Optional[dict] = None,
                       capped: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel K1: decode (int16 input), per-frame
    normalization (``normalize_block``), rejection and (weighted) mean of
    an (N, P) stack."""
    return rj.rejection_mean(normalize_block(stack, scale, offset, mul,
                                             mode),
                             rtype, siglow, sighigh, weights=weights,
                             critical=critical, n_full=n_full,
                             max_outliers=max_outliers, work=work,
                             capped=capped)


def make_block_kernel(rtype: int, mode: int, siglow: float,
                      sighigh: float, n_full: int = 0,
                      max_outliers: int = 0, critical=None,
                      with_weights: bool = False, want_maps: bool = False):
    """The fused normalize+reject+mean step of one stack configuration.
    Returns ``run(block, scale, offset, mul, weights=None) → (mean,
    rej_low, rej_high)``: per-pixel counts with ``want_maps``, else the
    two totals reduced on the device.  ``weights`` ((N, P) or (N, 1)) is
    used only ``with_weights``."""
    from siril_tpu_torch.kernels.reject_stack import reject_mean

    rj.check_rtype(rtype)

    def run(block, scale, offset, mul, weights=None):
        mean, rl, rh = reject_mean(
            block, scale, offset, mul, rtype=rtype, mode=mode,
            siglow=siglow, sighigh=sighigh,
            weights=weights if with_weights else None, critical=critical,
            n_full=n_full, max_outliers=max_outliers)
        if want_maps:
            return mean, rl, rh
        return mean, rl.sum(dtype=torch.int64), rh.sum(dtype=torch.int64)

    return run


def median_stack(stack: torch.Tensor) -> torch.Tensor:
    """Median stacking (stack_median, median_and_mean.c:1712-1716): the
    per-pixel median over ALL frame values, zeros included, the middle
    pair averaged for an even count — ``jnp.median``.  (``torch.median``
    returns the lower of the pair.)"""
    n = stack.shape[0]
    s = torch.sort(stack, dim=0).values
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(stack).any(0), float("nan"), med)


def norm_to_0_1_range(a: np.ndarray) -> np.ndarray:
    """(median_and_mean.c:557-580): rescale nonzero values to [0,1]."""
    nz = a[a != 0.0]
    if nz.size == 0:
        return a
    mini, maxi = float(nz.min()), float(nz.max())
    if maxi <= mini:
        return a
    return np.where(a == 0.0, 0.0,
                    (a - mini) / (maxi - mini)).astype(np.float32)


def finalize_metadata(seq, indices: np.ndarray,
                      result: np.ndarray) -> SirilImage:
    """Metadata accumulation (stacking.c compute_date_time_keywords):
    livetime = Σ exposure, stackcnt = N, date_obs = earliest."""
    img = SirilImage(data=result, orig_bitdepth=FLOAT_IMG)
    kws = [seq.read_frame_metadata(int(idx)) for idx in indices]
    if kws:
        img.keywords = kws[0].copy()
    img.keywords.livetime = float(sum(kw.exposure or 0.0 for kw in kws))
    img.keywords.stackcnt = len(indices)
    dates = [kw.date_obs for kw in kws if kw.date_obs]
    if dates:
        img.keywords.date_obs = min(dates)
    img.log_history(f"Stacking with {len(indices)} images")
    return img


# ---------------------------------------------------------------------------
# planner and shift-only registration in block assembly
# ---------------------------------------------------------------------------


def plan_blocks(height: int, width: int, n_frames: int,
                budget_mb: int) -> int:
    """Rows per block such that N·rows·W·4 B (plus sort scratch, ≈3×)
    fits the budget (stack_get_max_number_of_rows equivalent)."""
    bytes_per_row = n_frames * width * 4 * 4
    rows = max(int(budget_mb * 1024 * 1024 / max(bytes_per_row, 1)), 8)
    return min(rows, height)


def frame_shifts(seq, indices: np.ndarray, layer: int):
    """Integer (dx, dy) per frame from translation-only H, or None."""
    if layer not in seq.regparam or not seq.regparam[layer].valid.any():
        return None
    H = seq.regparam[layer].H[indices]
    if np.allclose(H, np.eye(3)[None], atol=1e-12):
        return None
    if not np.allclose(H[:, :2, :2], np.eye(2)[None], atol=1e-9):
        return None
    dx = np.rint(H[:, 0, 2]).astype(int)
    dy = np.rint(H[:, 1, 2]).astype(int)
    if not (dx.any() or dy.any()):
        return None
    return dx, dy


def read_block(seq, chan: int, frame_idx: int, y0: int, y1: int,
               shift: Optional[Tuple[int, int]], width: int) -> np.ndarray:
    """Registered rows [y0, y1): reg(x, y) = frame(x − dx, y − dy); outside
    the frame is zero (median_and_mean.c:1626-1633 black fill)."""
    if shift is None:
        return seq.read_region(chan, frame_idx, y0, y1)
    dx, dy = shift
    out = np.zeros((y1 - y0, width), np.float32)
    sy0, sy1 = y0 - dy, y1 - dy
    cy0, cy1 = max(sy0, 0), min(sy1, seq.ry)
    if cy1 <= cy0:
        return out
    rows = seq.read_region(chan, frame_idx, cy0, cy1)
    x0, x1 = max(dx, 0), min(width + dx, width)
    if x1 <= x0:
        return out
    out[cy0 - sy0: cy1 - sy0, x0:x1] = rows[:, x0 - dx: x1 - dx]
    return out


def compute_feather_masks(seq, indices: np.ndarray, feather_dist: int,
                          reglayer: int) -> np.ndarray:
    """(N, H, W) float16 seam-feathering masks in selection order
    (blending.c): the smoothstep r³(6r² − 15r + 10) of r = the distance to
    the nearest uncovered pixel over ``feather_dist``, each frame's
    coverage (any layer > 0) moved by its integer shift.  The distance
    transform runs on the coverage's bounding box and the uncovered ring
    around it, which holds every pixel's nearest uncovered pixel (a
    warped tile of a mosaic canvas covers a fraction of it), and so does
    the smoothstep: outside the box r = 0 and the mask 0."""
    shifts = frame_shifts(seq, indices, reglayer)
    masks = None
    for k, idx in enumerate(indices):
        cov = np.any(seq.read_frame(int(idx)).host() > 0.0, axis=0)
        if shifts is not None:
            cov = shift_into(cov.astype(np.float32)[None],
                             int(shifts[0][k]), int(shifts[1][k]))[0] > 0.5
        if masks is None:
            masks = np.zeros((len(indices),) + cov.shape, np.float16)
        rows, cols = np.nonzero(cov.any(axis=1))[0], \
            np.nonzero(cov.any(axis=0))[0]
        if len(rows):
            box = np.s_[max(rows[0] - 1, 0):rows[-1] + 2,
                        max(cols[0] - 1, 0):cols[-1] + 2]
            r = _feather_ramp(cov[box], feather_dist)
            masks[k][box] = (r * r * r * (6.0 * r * r - 15.0 * r + 10.0)
                             ).astype(np.float16)
    return masks


def _feather_ramp(cov: np.ndarray, feather_dist: int) -> np.ndarray:
    """The distance to the nearest uncovered pixel over ``feather_dist``,
    clipped to [0, 1]."""
    from scipy.ndimage import distance_transform_edt

    return np.clip(distance_transform_edt(cov) / float(feather_dist), 0.0,
                   1.0)


def shift_into(img, dx: int, dy: int, out_h: Optional[int] = None,
               out_w: Optional[int] = None):
    """(C, h, w) ``img`` (numpy or torch) placed at (dx, dy) on a zero
    canvas of (out_h, out_w), cropped to it."""
    c, h, w = img.shape
    oh = h if out_h is None else out_h
    ow = w if out_w is None else out_w
    if isinstance(img, torch.Tensor):
        out = torch.zeros((c, oh, ow), dtype=img.dtype, device=img.device)
    else:
        out = np.zeros((c, oh, ow), img.dtype)
    sy0, sy1 = max(dy, 0), min(h + dy, oh)
    sx0, sx1 = max(dx, 0), min(w + dx, ow)
    if sy1 > sy0 and sx1 > sx0:
        out[:, sy0:sy1, sx0:sx1] = img[:, sy0 - dy:sy1 - dy,
                                       sx0 - dx:sx1 - dx]
    return out


# ---------------------------------------------------------------------------
# weights (median_and_mean.c:1111-1230)
# ---------------------------------------------------------------------------


def compute_weights(seq, indices: np.ndarray, args: StackArgs,
                    coeffs: NormCoeffs,
                    frame_layer: Callable[[int, int], torch.Tensor]
                    ) -> Optional[np.ndarray]:
    """(L, N) per-frame weights, normalized to mean 1 per layer.
    ``frame_layer(k, layer)`` gives the (H, W) layer of the k-th selected
    frame as a tensor, where the noise weighting computes its missing
    statistics."""
    from siril_tpu_torch.ops.statistics import compute_stats_basic

    n = len(indices)
    L = seq.nb_layers
    w = np.ones((L, n))
    if args.weighting == NO_WEIGHT:
        return None
    if args.weighting == NOISE_WEIGHT:
        for layer in range(L):
            for k, idx in enumerate(indices):
                st = seq.get_frame_stats(layer, int(idx))
                bg = st.bgnoise if st and st.bgnoise else None
                if bg is None:
                    s = compute_stats_basic(frame_layer(k, layer))
                    seq.set_frame_stats(layer, int(idx), s)
                    bg = s.bgnoise
                sc = coeffs.scale[layer, k]
                w[layer, k] = 1.0 / max(sc * sc * bg * bg, 1e-30)
            w[layer] /= w[layer].mean()
    elif args.weighting == WFWHM_WEIGHT:
        wf = seq.reg(args.reglayer).weighted_fwhm[indices]
        pos = wf[wf > 0]
        if pos.size == 0:
            return None
        fmin, fmax = pos.min(), wf.max()
        invdenom = 1.0 / (1.0 / (fmin * fmin) - 1.0 / (fmax * fmax))
        invmax2 = 1.0 / (fmax * fmax)
        base = np.where(wf > 0, (1.0 / np.maximum(wf, 1e-9) ** 2 - invmax2)
                        * invdenom, 0.0)
        base /= max(base.mean(), 1e-30)
        w[:] = base[None, :]
    elif args.weighting == NBSTARS_WEIGHT:
        ns = seq.reg(args.reglayer).number_of_stars[indices].astype(float)
        smin, smax = ns.min(), ns.max()
        base = np.ones(n) if smax == smin else \
            ((ns - smin) / (smax - smin)) ** 2
        base /= max(base.mean(), 1e-30)
        w[:] = base[None, :]
    elif args.weighting == NBSTACK_WEIGHT:
        cnt = np.ones(n)
        for k, idx in enumerate(indices):
            try:
                kw = seq.read_frame_metadata(int(idx))
            except (OSError, ValueError):
                kw = None
            if kw is not None and kw.stackcnt:
                cnt[k] = kw.stackcnt
        cnt /= cnt.mean()
        w[:] = cnt[None, :]
    return w


# ---------------------------------------------------------------------------
# main entry (main_stack equivalent)
# ---------------------------------------------------------------------------


def _check_stack_args(args: StackArgs) -> None:
    if args.method not in ("rej", "mean", "med", "sum", "min", "max"):
        raise ValueError(f"unknown stacking method {args.method!r}")


def _kernel_config(args: StackArgs, n: int):
    """(rtype, normalization mode, GESDT budget, λ table) of a stack."""
    rtype = args.rejection if args.method == "rej" else rj.NO_REJEC
    if args.method == "med":
        rtype = MEDIAN
    critical = np.zeros(1, np.float32)
    max_outliers = 0
    if rtype == rj.GESDT:
        max_outliers = rj.gesdt_max_outliers(n, args.siglow)
        critical = rj.gesdt_critical_values(n, args.sighigh, max_outliers)
    mode = args.normalize if args.method in ("rej", "mean") else NO_NORM
    return rtype, mode, max_outliers, critical


def stack_sequence(seq, args: StackArgs, indices: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> StackResult:
    """Stack the selected frames of ``seq`` (or ``indices``) on ``device``
    (CUDA unless "cpu"): sum/min/max frame by frame; else the
    device-resident path when the raw frames fit and need no shifts,
    rejection maps, feathering or overlap normalization, else row blocks
    streamed from the files."""
    from siril_tpu_torch.kernels import reject_stack as k1

    dev = resolve_device(device)
    _check_stack_args(args)
    capped0 = k1.capped_pixels()
    t0 = time.perf_counter()
    if indices is None:
        indices = seq.selected_indices()
    indices = np.asarray(indices)
    n = len(indices)
    if n == 0:
        raise ValueError("no frames selected for stacking")
    if seq.nb_layers < 0 or seq.ry == 0:
        img0 = seq.read_frame(int(indices[0]))
        seq.nb_layers, seq.ry, seq.rx = img0.data.shape
    L, H, W = seq.nb_layers, seq.ry, seq.rx
    clock = StageClock(dev)

    if args.method in ("sum", "min", "max"):
        res = _stack_accumulate(seq, args, indices, dev, clock)
    else:
        res = _resident_stack(seq, args, indices, dev, clock)
    if res is None:
        res = _streamed_stack(seq, args, indices, dev, clock, L, H, W)
    res.capped = k1.capped_pixels() - capped0
    res.elapsed_s = time.perf_counter() - t0
    res.stage_s = clock.seconds
    return res


def _finish(seq, args, indices, result, tot, rmaps=None) -> StackResult:
    if args.output_norm:
        result = norm_to_0_1_range(result)
    elif args.use_32bit:
        result = np.clip(result, 0.0, 1.0)
    out = StackResult(image=finalize_metadata(seq, indices, result),
                      total_rejected=tot)
    if rmaps is not None:
        lo, hi = rmaps
        out.rejmap_low = SirilImage(data=lo.astype(np.float32) / 65535.0)
        if hi is not None:
            out.rejmap_high = SirilImage(data=hi.astype(np.float32) / 65535.0)
    return out


def _streamed_stack(seq, args, indices, dev, clock, L, H, W) -> StackResult:
    """Row blocks of all frames read from the files (8 threads, the next
    block read while the device computes the current one), each stacked
    by one kernel call; results fetched once at the end."""
    n = len(indices)
    do_norm = args.method in ("rej", "mean") and args.normalize != NO_NORM
    with clock("estimators"):
        if do_norm and args.overlap_norm:
            coeffs = compute_overlap_normalization(
                seq, indices, args.normalize, lite=args.lite_norm,
                reglayer=args.reglayer)
        else:
            coeffs = compute_normalization(
                seq, indices, args.normalize if do_norm else NO_NORM,
                lite=args.lite_norm, force=args.force_norm,
                equalize_rgb=args.equalize_rgb, reglayer=args.reglayer,
                device=dev)

    def frame_layer(k, layer):
        return torch.from_numpy(
            seq.read_frame(int(indices[k])).host()[layer]).to(dev)

    weights = None
    if args.method in ("rej", "mean") and args.weighting != NO_WEIGHT:
        with clock("noise"):
            weights = compute_weights(seq, indices, args, coeffs,
                                      frame_layer)
    # seam feathering: per-pixel masks multiplied into the weights
    feather = None
    if args.method in ("rej", "mean") and args.feather_dist > 0:
        with clock("feather"):
            feather = torch.from_numpy(compute_feather_masks(
                seq, indices, int(args.feather_dist), args.reglayer)).to(dev)
    rtype, mode, max_outliers, critical = _kernel_config(args, n)
    maps = args.create_rejmaps and rtype != MEDIAN
    kernel = None if rtype == MEDIAN else make_block_kernel(
        rtype, mode, float(args.siglow), float(args.sighigh), n,
        max_outliers, critical, weights is not None or feather is not None,
        want_maps=maps)

    rows_per_block = plan_blocks(H, W, n, args.block_mb)
    blocks = [(c, y, min(y + rows_per_block, H))
              for c in range(L) for y in range(0, H, rows_per_block)]
    shifts = frame_shifts(seq, indices, args.reglayer)
    f32 = dict(dtype=torch.float32, device=dev)
    pool = cf.ThreadPoolExecutor(max_workers=8)

    def assemble(block):
        c, y0, y1 = block
        buf = np.empty((n, (y1 - y0) * W), np.float32)

        def one(k):
            sh = (shifts[0][k], shifts[1][k]) if shifts is not None else None
            buf[k] = read_block(seq, c, int(indices[k]), y0, y1, sh,
                                W).reshape(-1)
        list(pool.map(one, range(n)))
        return buf

    means, rls, rhs = [], [], []
    try:
        nxt = pool.submit(assemble, blocks[0])
        for bi, (c, y0, y1) in enumerate(blocks):
            check_cancelled("stacking")    # processing.h:260 between blocks
            with clock("read"):
                buf = nxt.result()
            if bi + 1 < len(blocks):
                nxt = pool.submit(assemble, blocks[bi + 1])
            with clock("upload"):
                block = torch.from_numpy(buf).to(dev)
            with clock("kernel"):
                if kernel is None:
                    mean = median_stack(block)
                    rl = rh = torch.zeros((), dtype=torch.int64, device=dev)
                else:
                    w = None if weights is None else torch.as_tensor(
                        weights[c][:, None], **f32)
                    if feather is not None:
                        fm = feather[:, y0:y1].reshape(n, -1).float()
                        w = fm if w is None else w * fm
                    mean, rl, rh = kernel(
                        block, torch.as_tensor(coeffs.scale[c], **f32),
                        torch.as_tensor(coeffs.offset[c], **f32),
                        torch.as_tensor(coeffs.mul[c], **f32), w)
            means.append(mean)
            rls.append(rl)
            rhs.append(rh)
    finally:
        pool.shutdown(wait=True)
        seq.close_readers()

    with clock("fetch"):
        result = torch.cat([m.reshape(-1) for m in means]).cpu().numpy()
        result = result.reshape(L, H, W).astype(np.float32)
        if maps:
            rla = torch.cat(rls).cpu().numpy().reshape(L, H, W)
            rha = torch.cat(rhs).cpu().numpy().reshape(L, H, W)
            tot = (int(rla.sum()), int(rha.sum()))
        else:
            tot = (int(torch.stack(rls).sum()), int(torch.stack(rhs).sum()))
    rmaps = None
    if maps:
        if args.merge_rejmaps:
            rmaps = ((rla + rha).astype(np.uint16), None)
        else:
            rmaps = (rla.astype(np.uint16), rha.astype(np.uint16))
    return _finish(seq, args, indices, result, tot, rmaps)


# ---------------------------------------------------------------------------
# device-resident stacking (single-upload path)
# ---------------------------------------------------------------------------


def _resident_stack(seq, args, indices, dev, clock):
    """Single-upload stack: the raw u16 (or f32) frames go to the device
    once, estimators, noise, rejection and mean run there, and one fetch
    returns the result.  Returns None when the streamed path must run
    (shifted frames, rejection maps, feathering, overlap normalization,
    or a stack over the budget)."""
    if args.create_rejmaps or args.feather_dist or args.overlap_norm:
        return None
    n = len(indices)
    L, H, W = seq.nb_layers, seq.ry, seq.rx
    if frame_shifts(seq, indices, args.reglayer) is not None:
        return None
    # files and FITS cubes, not SER (siril_tpu/ops/stacking.py:639-641)
    if seq.seq_type not in (SEQ_REGULAR, SEQ_FITSEQ):
        return None
    try:
        readers = [seq.open_reader(int(i)) for i in indices]
    except (ValueError, OSError):
        return None
    is_u16 = all(r.is_u16() for r in readers)
    is_f32 = all(r.is_f32() for r in readers)
    if not (is_u16 or is_f32):
        return None
    if any((r.nchans, r.height, r.width) != (L, H, W) for r in readers):
        return None
    if n * L * H * W * (2 if is_u16 else 4) > resident_budget_bytes(dev):
        return None

    raw = np.empty((n, L, H * W), np.int16 if is_u16 else np.float32)

    def one(k):
        raw[k] = readers[k].raw_topdown("<i2" if is_u16 else "<f4").reshape(
            L, H * W)

    with clock("read"), cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(n)))
    with clock("upload"):
        stack = torch.from_numpy(raw).to(dev)
    del raw

    def layer_f32(frames):
        return decode_i16(frames) if frames.dtype == torch.int16 \
            else frames

    do_norm = args.normalize != NO_NORM
    with clock("estimators"):
        if do_norm:
            _resident_fill_stats(seq, indices, stack, layer_f32,
                                 args.lite_norm, force=args.force_norm)
        coeffs = compute_normalization(
            seq, indices, args.normalize if do_norm else NO_NORM,
            lite=args.lite_norm, force=False,
            equalize_rgb=args.equalize_rgb, reglayer=args.reglayer,
            device=dev)
    weights = None
    if args.weighting != NO_WEIGHT and args.method in ("rej", "mean"):
        with clock("noise"):
            weights = compute_weights(
                seq, indices, args, coeffs, lambda k, layer: layer_f32(
                    stack[k, layer]).reshape(H, W))

    rtype, mode, max_outliers, critical = _kernel_config(args, n)
    f32 = dict(dtype=torch.float32, device=dev)
    means = []
    tot_l = torch.zeros((), dtype=torch.int64, device=dev)
    tot_h = torch.zeros((), dtype=torch.int64, device=dev)
    with clock("kernel"):
        for c in range(L):
            x = stack[:, c].contiguous()
            if rtype == MEDIAN:
                means.append(median_stack(layer_f32(x)))
                continue
            kernel = make_block_kernel(
                rtype, mode, float(args.siglow), float(args.sighigh), n,
                max_outliers, critical, weights is not None)
            w = None if weights is None else torch.as_tensor(
                weights[c][:, None], **f32)
            mean, rl, rh = kernel(
                x, torch.as_tensor(coeffs.scale[c], **f32),
                torch.as_tensor(coeffs.offset[c], **f32),
                torch.as_tensor(coeffs.mul[c], **f32), w)
            means.append(mean)
            tot_l += rl
            tot_h += rh
    with clock("fetch"):
        result = torch.stack(means).cpu().numpy().reshape(L, H, W)
        tot = (int(tot_l), int(tot_h))
    del stack
    seq.close_readers()
    return _finish(seq, args, indices, result.astype(np.float32), tot)


def _resident_fill_stats(seq, indices, stack, layer_f32, lite: bool,
                         force: bool = False) -> None:
    """Compute the estimators missing from the stats store on the
    device-resident stack, a few frames at a time."""
    from siril_tpu_torch.ops.statistics import norm_estimators

    L = seq.nb_layers
    n = stack.shape[0]
    need = [layer for layer in range(L) if force or not all(
        has_estimators(seq.get_frame_stats(layer, int(idx)), lite)
        for idx in indices)]
    px = stack.shape[-1]
    sub = max(1, (512 << 20) // max(px * 4, 1))
    for layer in need:
        parts = []
        for s0 in range(0, n, sub):
            e = norm_estimators(layer_f32(stack[s0:s0 + sub, layer]),
                                lite=lite)
            parts.append(torch.stack([e["median"], e["mad"],
                                      e["location"], e["scale"]]))
        med, mad, loc, sca = torch.cat(parts, 1).cpu().numpy()
        for k, idx in enumerate(indices):
            cache_estimators(seq, layer, int(idx), med[k], mad[k], loc[k],
                             sca[k], lite)


# ---------------------------------------------------------------------------
# sum / min / max (sum.c, stackminmax.c)
# ---------------------------------------------------------------------------

#: frames the sum/min/max stack reads ahead
READ_AHEAD = 4


def _stack_accumulate(seq, args, indices, dev, clock) -> StackResult:
    """sum / min / max of the frames moved by their integer shifts, on the
    device; ``maximize`` spreads the canvas over the union of the shifted
    footprints (compute_max_framing, stacking.h:207).  The sum runs in
    float64 and is divided by its maximum; min and max keep float32 and
    put 0 where no frame reached."""
    L, H, W = seq.nb_layers, seq.ry, seq.rx
    shifts = frame_shifts(seq, indices, args.reglayer)
    ox = oy = 0
    if args.maximize and shifts is not None:
        dxs, dys = shifts
        x0, y0 = min(0, int(dxs.min())), min(0, int(dys.min()))
        W = max(W, W + int(dxs.max())) - x0
        H = max(H, H + int(dys.max())) - y0
        ox, oy = -x0, -y0
    if args.method == "sum":
        acc = torch.zeros((L, H, W), dtype=torch.float64, device=dev)
    else:
        fill = float("inf") if args.method == "min" else float("-inf")
        acc = torch.full((L, H, W), fill, dtype=torch.float32, device=dev)
    def read(k):
        return seq.read_frame(int(indices[k])).host()

    # READ_AHEAD frames read in parallel, at most that many held on the host
    n = len(indices)
    with cf.ThreadPoolExecutor(max_workers=READ_AHEAD) as pool:
        ahead = [pool.submit(read, k) for k in range(min(READ_AHEAD, n))]
        for k in range(n):
            with clock("read"):
                host = ahead.pop(0).result()
            if k + READ_AHEAD < n:
                ahead.append(pool.submit(read, k + READ_AHEAD))
            with clock("upload"):
                img = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
            with clock("accumulate"):
                if shifts is not None:
                    img = shift_into(img, int(shifts[0][k]) + ox,
                                     int(shifts[1][k]) + oy, H, W)
                elif (H, W) != tuple(img.shape[1:]):
                    img = shift_into(img, ox, oy, H, W)
                if args.method == "sum":
                    acc += img
                elif args.method == "min":
                    acc = torch.minimum(acc, img)
                else:
                    acc = torch.maximum(acc, img)
    with clock("fetch"):
        if args.method == "sum":
            m = acc.max()
            result = torch.where(m > 0, acc / m, acc).float()
        else:
            result = torch.where(torch.isfinite(acc), acc, 0.0)
        result = result.cpu().numpy()
    seq.close_readers()
    return StackResult(image=finalize_metadata(seq, indices, result))
