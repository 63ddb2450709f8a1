"""Sequence export — counterpart of ``siril_tpu/io/sequence_export.py``
(``ExportArgs``:43, ``_shift_only``:55, ``export_sequence``:63; the
reference's ``src/io/sequence_export.c``): the selected frames of a
sequence written as FITS files, a FITS cube, SER, TIFF, AVI, MP4 or
WebM, with registration shifts, normalization, a crop and (video only)
a resample applied.

Reference semantics kept:
- registration must be shift-only; shifts are rounded to whole pixels
  relative to the reference frame (``sequence_export.c:436-444``);
- normalization takes the stack's additive-with-scaling coefficients and
  leaves pixels at 0 (``sequence_export.c:470-480``);
- video dimensions are rounded to even (x264).

Each frame goes to the device once: the shift, the normalization, the
crop and the resample (``ops.interp.resize``, lanczos4 with the clamp, as
``ops.geometry.resample``) run there, and the [0, 1] frame comes back to
be written by the port's own writers (``io/fits_io``, ``io/ser``,
``io/image_formats.write_tiff``, ``io/avi``; MP4 and WebM through OpenCV,
which raises where it is not installed).  The JAX package writes TIFF
through PIL; the port's codec writes the same 16-bit samples.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.processing import check_cancelled
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.device import DeviceLike, resolve_device

_log = logging.getLogger(__name__)

EXPORT_FITS = "fits"
EXPORT_FITSEQ = "fitseq"
EXPORT_SER = "ser"
EXPORT_TIFF = "tiff"
EXPORT_AVI = "avi"
EXPORT_MP4 = "mp4"
EXPORT_MP4_H265 = "mp4-h265"
EXPORT_WEBM_VP9 = "webm"

_VIDEO = (EXPORT_AVI, EXPORT_MP4, EXPORT_MP4_H265, EXPORT_WEBM_VP9)


@dataclass
class ExportArgs:
    """exportseq_args (sequence_export.c:46-60)."""

    output: str = EXPORT_FITS
    basename: str = "export_"
    normalize: bool = False
    crop: Optional[Tuple[int, int, int, int]] = None   # x, y, w, h
    resample: Optional[Tuple[int, int]] = None         # dest w, h (video)
    fps: int = 25
    quality: int = 3                                   # 1..5
    bitdepth: int = 16


def _shift_only(H: np.ndarray) -> bool:
    """test_regdata_is_valid_and_shift: the linear part the identity and
    no projective terms."""
    return bool(np.allclose(H[:, :2, :2], np.eye(2), atol=1e-3) and
                np.allclose(H[:, 2, :2], 0.0, atol=1e-7))


def _shifted(x: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """out[y, x] = in[y − sy, x − sx], zero outside."""
    out = torch.zeros_like(x)
    h, w = x.shape[-2:]
    ys0, ys1 = max(0, sy), min(h, h + sy)
    xs0, xs1 = max(0, sx), min(w, w + sx)
    if ys1 > ys0 and xs1 > xs0:
        out[:, ys0:ys1, xs0:xs1] = x[:, ys0 - sy:ys1 - sy,
                                     xs0 - sx:xs1 - sx]
    return out


def export_sequence(seq: Sequence, args: ExportArgs, directory: str = ".",
                    device: DeviceLike = None) -> int:
    """Run the export on ``device`` (CUDA unless "cpu"); returns the
    number of frames written."""
    from siril_tpu_torch.ops.interp import INTERP_LANCZOS4, resize

    dev = resolve_device(device)
    idx = seq.selected_indices()
    if len(idx) == 0:
        raise ValueError("no frames selected for export")
    os.makedirs(directory, exist_ok=True)

    reglayer = next(iter(seq.regparam), -1)
    shifts = None
    if reglayer != -1 and seq.regparam[reglayer].valid.any():
        reg = seq.regparam[reglayer]
        if not _shift_only(reg.H[idx]):
            raise ValueError(
                "Export has detected registration data with more than "
                "simple shifts, this is not supported")
        ref = seq.reference_image if seq.reference_image >= 0 \
            else int(idx[0])
        dref = reg.H[ref, :2, 2]
        shifts = np.rint(reg.H[idx, :2, 2] - dref[None]).astype(int)

    coeffs = None
    if args.normalize:
        from siril_tpu_torch.ops.normalization import (
            ADDITIVE_SCALING,
            compute_normalization,
        )

        coeffs = compute_normalization(seq, idx, ADDITIVE_SCALING,
                                       device=dev)

    first = seq.read_frame(int(idx[0]))
    H, W = first.height, first.width
    crop = args.crop
    if crop:
        cx, cy, cw, ch = crop
        if not (0 <= cx < W and 0 <= cy < H):
            raise ValueError(f"crop origin ({cx},{cy}) outside {W}x{H} "
                             f"image")
        cw, ch = min(cw, W - cx), min(ch, H - cy)
        if cw <= 0 or ch <= 0:
            raise ValueError("crop rectangle is empty")
        crop = (cx, cy, cw, ch)
    out_w = crop[2] if crop else W
    out_h = crop[3] if crop else H
    if args.output in _VIDEO and args.resample:
        out_w, out_h = args.resample

    writer = _open_writer(args, directory, out_w, out_h, first.nchans)
    n = 0
    try:
        for k, i in enumerate(idx):
            check_cancelled("export")
            img = first if k == 0 else seq.read_frame(int(i))
            x = torch.from_numpy(img.host()).to(dev)
            if shifts is not None and (shifts[k, 0] or shifts[k, 1]):
                x = _shifted(x, int(shifts[k, 0]), int(shifts[k, 1]))
            if coeffs is not None:
                sc = torch.as_tensor(
                    coeffs.scale[:, k].astype(np.float32),
                    device=dev)[:, None, None]
                off = torch.as_tensor(
                    coeffs.offset[:, k].astype(np.float32),
                    device=dev)[:, None, None]
                x = torch.where(x > 0, x * sc - off, x)
            if crop:
                cx, cy, cw, ch = crop
                x = x[:, cy:cy + ch, cx:cx + cw]
            if args.output in _VIDEO and args.resample and \
                    tuple(x.shape[-2:]) != (out_h, out_w):
                x = resize(x.contiguous(), out_w, out_h, INTERP_LANCZOS4,
                           True)
            out = SirilImage(data=np.ascontiguousarray(
                torch.clamp(x, 0.0, 1.0).cpu().numpy()))
            out.keywords = img.keywords
            _write_frame(writer, args, out, n, directory)
            n += 1
    finally:
        if writer is not None:
            writer.close()
    _log.info("Exported %d frames to %s", n, args.output)
    return n


def _open_writer(args: ExportArgs, directory: str, w: int, h: int,
                 nchans: int):
    base = os.path.join(directory, args.basename.rstrip("_"))
    if args.output == EXPORT_FITSEQ:
        from siril_tpu_torch.io.fits_io import FitseqWriter

        return FitseqWriter(base + ".fit",
                            bitdepth=-32 if args.bitdepth == 32 else 16)
    if args.output == EXPORT_SER:
        from siril_tpu_torch.io.ser import SER_MONO, SER_RGB, SerWriter

        return SerWriter(base + ".ser", w, h,
                         SER_RGB if nchans == 3 else SER_MONO, 16)
    if args.output == EXPORT_AVI:
        from siril_tpu_torch.io.avi import AviWriter

        return AviWriter(base + ".avi", w, h, float(args.fps), nchans == 3)
    if args.output in (EXPORT_MP4, EXPORT_MP4_H265, EXPORT_WEBM_VP9):
        from siril_tpu_torch.io.mp4_output import Mp4Writer

        ext = ".webm" if args.output == EXPORT_WEBM_VP9 else ".mp4"
        return Mp4Writer(base + ext, w, h, fps=args.fps, nb_layers=nchans,
                         quality=args.quality, fmt=args.output)
    if args.output not in (EXPORT_FITS, EXPORT_TIFF):
        raise ValueError(f"unknown export format {args.output!r}")
    return None


def _write_frame(writer, args: ExportArgs, img: SirilImage, k: int,
                 directory: str) -> None:
    if args.output == EXPORT_FITS:
        from siril_tpu_torch.io.fits_io import write_fits

        path = os.path.join(directory, f"{args.basename}{k + 1:05d}.fit")
        write_fits(img, path, bitdepth=-32 if args.bitdepth == 32 else 16)
    elif args.output == EXPORT_TIFF:
        from siril_tpu_torch.io.image_formats import write_tiff

        path = os.path.join(directory, f"{args.basename}{k + 1:05d}.tif")
        write_tiff(path, np.clip(img.data * 65535.0 + 0.5, 0,
                                 65535).astype(np.uint16))
    elif args.output == EXPORT_FITSEQ:
        writer.append(img)
    elif args.output == EXPORT_SER:
        writer.write_frame(img)
    else:
        writer.add_frame(img)
