"""Calibration of light frames — counterpart of
``siril_tpu/ops/calibration.py`` (``CalibArgs``:34, ``evaluate_offset_level``
:51, ``_noise_of``:63, ``dark_optimization_k``:75,
``make_calibrate_kernel``:116 and its batch form :153,
``equalize_cfa_flat``:176, ``calibrate_image``:192, ``prepare_calibration``
:227, ``calibrate_sequence``:281; reference ``src/core/preprocess.c``).

Per frame: ``(raw − bias − k·dark) / (flat · 1/μ_flat)``, then cosmetic
correction from the master dark's deviant map, as torch code on the
frame's device.  ``x − k·dark`` is one fused multiply-add
(``ops/rejection.fma``), as XLA:CPU compiles the reference's program; the
flat's mean μ is numpy's float32 sum on the host, as in the reference.
With ``-debayer`` a CFA frame is demosaiced after its calibration
(``siril_tpu/ops/calibration.py:220-223``), on the calibrated tensor
where it lies (``ops/demosaic.py``, the default method RCD).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.cosmetic import (
    apply_cosmetic,
    detect_deviant_from_dark,
    deviant_plan,
)
from siril_tpu_torch.ops.demosaic import debayer_tensor
from siril_tpu_torch.ops.rejection import fma
from siril_tpu_torch.ops.stacking import StageClock

_log = logging.getLogger(__name__)


@dataclass
class CalibArgs:
    bias: Optional[SirilImage] = None
    bias_level: Optional[float] = None       # synthetic bias (float [0,1])
    dark: Optional[SirilImage] = None
    flat: Optional[SirilImage] = None
    use_dark_optim: bool = False
    use_exposure: bool = False               # k = exposure ratio, no search
    use_cosmetic: bool = True                # CC from dark hot/cold map
    sig_cold: float = -1.0                   # < 0 disables
    sig_hot: float = 3.0
    is_cfa: bool = False
    equalize_cfa: bool = True                # grey_flat for CFA flats
    debayer: bool = False
    flat_norm: Optional[float] = None        # computed if None
    prefix: str = "pp_"


def evaluate_offset_level(expr: str, img: SirilImage) -> float:
    """Synthetic bias expression (evaluateoffsetlevel, preprocess.c:600):
    "500" (ADU), "=2048" or "=64*$OFFSET".  Returns a float in [0, 1]."""
    e = expr.strip().lstrip("=").replace(" ", "")
    offset_kw = float(img.keywords.offset or 0)
    e = e.replace("$OFFSET", str(offset_kw)).replace("$offset",
                                                     str(offset_kw))
    if not re.fullmatch(r"[0-9.+\-*/()]+", e):
        raise ValueError(f"invalid offset expression: {expr}")
    val = float(eval(e, {"__builtins__": {}}, {}))  # noqa: S307 — sanitized
    return val / 65535.0


def _noise_of(diff: torch.Tensor) -> float:
    """Σ over channels of the sample σ (evaluateNoiseOfCalibratedImage)."""
    flat = diff.reshape(diff.shape[0], -1)
    n = flat.shape[1]
    mean = flat.mean(dim=1, keepdim=True)
    var = ((flat - mean) ** 2).sum(dim=1) / (n - 1)
    return float(torch.sqrt(var).sum())


def dark_optimization_k(raw: torch.Tensor, dark: torch.Tensor,
                        use_exposure: bool, raw_exp: float = 0.0,
                        dark_exp: float = 0.0) -> float:
    """Dark scaling k (darkOptimization, preprocess.c:161): the exposure
    ratio, or a golden-section search on [0, 2] for the k that minimises
    the noise of raw − k·dark (tolerance 1e-3)."""
    if use_exposure:
        if dark_exp <= 0 or raw_exp <= 0:
            raise ValueError("exposure-based dark scaling needs EXPTIME")
        k0 = raw_exp / dark_exp
        if k0 > 1.0:
            _log.warning("master dark is shorter than lights")
        return k0
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = 0.0, 2.0

    def f(k):
        return _noise_of(raw - float(np.float32(k)) * dark)

    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = f(c), f(d)
    if fc == fd:
        return 1.0
    while abs(c - d) > 1e-3:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = f(d)
    return (b + a) * 0.5


def make_calibrate_kernel(has_bias: bool, has_dark: bool, has_flat: bool,
                          has_cc: bool, is_cfa: bool):
    """(raw − bias − k·dark) / fnorm, then the cosmetic replacements, on
    one (C, H, W) frame or an (n, C, H, W) batch (the reference's
    ``make_calibrate_batch_kernel`` maps the frame program over the
    batch; here the operations broadcast).  ``fnorm`` is flat · 1/μ and
    ``plan`` the cosmetic gather plan (``deviant_plan``)."""

    def kernel(raw, bias, dark, k, fnorm, plan):
        x = raw
        if has_bias:
            x = x - bias
        if has_dark:
            x = fma(dark, -k, x)
        if has_flat:
            zero = fnorm == 0.0
            x = torch.where(zero, 0.0, x / torch.where(zero, 1.0, fnorm))
        if has_cc:
            x = apply_cosmetic(x, plan)
        return x

    return kernel


def equalize_cfa_flat(flat: np.ndarray) -> np.ndarray:
    """grey_flat: scale the 4 CFA sub-channels of a flat to equal means
    (compensate_grey_flat)."""
    out = flat.copy()
    lay = out[0]
    means = np.array([[lay[dy::2, dx::2].mean() for dx in (0, 1)]
                      for dy in (0, 1)])
    target = means.mean()
    for dy in (0, 1):
        for dx in (0, 1):
            m = means[dy, dx]
            if m > 0:
                lay[dy::2, dx::2] *= target / m
    return out


def prepare_calibration(args: CalibArgs, sample: SirilImage,
                        device: DeviceLike = None) -> dict:
    """prepro_prepare_hook (preprocess.c:304): masters on the device, the
    flat's mean, the deviant map and the calibration function."""
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    st: dict = {"device": dev}
    st["bias"] = None
    if args.bias is not None:
        st["bias"] = up(args.bias.host())
    elif args.bias_level is not None:
        st["bias"] = up(np.full((1, 1, 1), np.float32(args.bias_level)))
    st["dark"] = up(args.dark.host()) if args.dark is not None else None
    st["fnorm"] = None
    if args.flat is not None:
        flat = args.flat.host()
        if args.is_cfa and args.equalize_cfa:
            flat = equalize_cfa_flat(flat)
        mu = args.flat_norm if args.flat_norm else float(flat.mean())
        if mu == 0:
            _log.error("flat mean is zero; not normalizing")
            mu = 1.0
        st["fnorm"] = up(flat) * torch.tensor(np.float32(1.0 / mu),
                                              device=dev)
    H, W = sample.height, sample.width
    cold = np.zeros((H, W), bool)
    hot = np.zeros((H, W), bool)
    has_cc = False
    if args.use_cosmetic and args.dark is not None and \
            (args.sig_cold >= 0 or args.sig_hot >= 0):
        cold, hot = detect_deviant_from_dark(
            args.dark.host()[0], args.sig_cold, args.sig_hot)
        ncold, nhot = int(cold.sum()), int(hot.sum())
        _log.info("Cosmetic correction: %d cold, %d hot pixels", ncold, nhot)
        has_cc = ncold + nhot > 0
    st["cold"], st["hot"] = cold, hot
    st["plan"] = deviant_plan(cold, hot, args.is_cfa, dev) if has_cc \
        else None
    st["has_cc"] = has_cc
    st["kernel"] = make_calibrate_kernel(
        st["bias"] is not None, st["dark"] is not None,
        st["fnorm"] is not None, has_cc, args.is_cfa)
    return st


def calibrate_tensor(x: torch.Tensor, st: dict, k: float = 1.0
                     ) -> torch.Tensor:
    """Calibrate a (C, H, W) frame or (n, C, H, W) batch on the device."""
    return st["kernel"](x, st["bias"], st["dark"], float(np.float32(k)),
                        st["fnorm"], st["plan"])


def calibrate_image(raw: SirilImage, args: CalibArgs,
                    _state: Optional[dict] = None,
                    device: DeviceLike = None, clock=None) -> SirilImage:
    """calibrate_single_image (preprocess.c:518) — one frame, debayered
    after its calibration with ``args.debayer`` when it is a CFA frame;
    ``clock`` (a ``StageClock``) times upload, calibrate, debayer and
    fetch."""
    st = _state if _state is not None else \
        prepare_calibration(args, raw, device)
    clock = clock or StageClock(st["device"], "calib.")
    with clock("upload"):
        x = torch.from_numpy(raw.host()).to(st["device"])
    with clock("calibrate"):
        k = 1.0
        if args.dark is not None and args.use_dark_optim:
            k = dark_optimization_k(x, st["dark"], args.use_exposure,
                                    raw.keywords.exposure,
                                    args.dark.keywords.exposure)
        x = calibrate_tensor(x, st, k)
    debayer = args.debayer and raw.is_cfa()
    if debayer:
        with clock("debayer"):
            x = debayer_tensor(x, raw)
    with clock("fetch"):
        res = raw.copy(data=x.cpu().numpy())
    if args.bias is not None or args.bias_level is not None:
        res.log_history("Calibrated with a master bias")
    if args.dark is not None:
        res.log_history("Calibrated with a master dark" + (
            f" (optimized k={k:.3f})" if args.use_dark_optim else ""))
    if args.flat is not None:
        res.log_history("Calibrated with a master flat")
    if debayer:
        res.keywords.bayer_pattern = ""
        res.log_history("Debayer applied")
    return res


def calibrate_sequence(seq: Sequence, args: CalibArgs,
                       device: DeviceLike = None):
    """``calibrate`` over a sequence → a new ``pp_`` sequence."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence

    dev = resolve_device(device)
    state: dict = {}
    clock = StageClock(dev, "calib.")

    def prepare(ctx):
        with clock("masters"):
            sample = seq.read_frame(int(seq.selected_indices()[0]))
            state.update(prepare_calibration(args, sample, dev))

    def image(ctx, idx, img):
        if args.dark is not None and args.use_dark_optim and \
                args.use_exposure and img.keywords.exposure <= 0:
            _log.error("Calibration: frame %d has no EXPTIME to scale the "
                       "dark by", idx)
            return None
        return calibrate_image(img, args, _state=state, clock=clock)

    return run_sequence(SeqArgs(seq=seq, description="Calibration",
                                prefix=args.prefix, prepare=prepare,
                                image=image, stage_s=clock.seconds))
