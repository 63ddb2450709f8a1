"""The image-format commands — counterpart of ``siril_tpu/cli/commands.py``
(``_save_pil``:140, ``savejpg``:165, ``savepng``:170, ``savetif``:175,
``savetif8``:180, ``savetif32``:185, ``savebmp``:195, ``savepnm``:200)
and ``siril_tpu/cli/commands2.py`` (``convertraw``:173, ``savejxl``:181).

TIFF, PNG, BMP and PNM are written by the port's own codec
(``io/image_formats.py``), with the JAX package's file names, extensions
and log lines: ``savetif`` and ``savepng`` 16 bits (``to_u16``),
``savetif8``, ``savebmp`` and ``savepnm`` 8 bits (``to_u8``), ``savetif32``
the float32 samples; ``savetif -deflate`` deflates the strips.  Where the
JAX package raises — a colour image in ``savetif``, ``savepng`` or
``savetif32``, which PIL cannot hold — these write what Siril writes
(ROADMAP §3).  ``savejpg`` and ``savejxl`` go through PIL, and raise a
``CommandError`` naming PIL where it is not installed.  ``convertraw``
runs ``convert``, as the JAX package does.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np

from siril_tpu_torch.cli.commands import COMMANDS, _f, command, parse_flags
from siril_tpu_torch.cli.context import CommandError, Session

_log = logging.getLogger(__name__)


def _path(ctx: Session, name: str, ext: str) -> str:
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += "." + ext
    return p


def _save(ctx: Session, args: List[str], ext: str, bits: int) -> None:
    """``_save_pil``: the image at ``bits`` (8 or 16) as ``ext``."""
    from siril_tpu_torch.io import image_formats as imf

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    p = _path(ctx, pos[0], ext)
    arr = img.to_u16() if bits == 16 else img.to_u8()
    if ext == "tif":
        imf.write_tiff(p, arr, deflate="deflate" in flags)
    elif ext == "png":
        imf.write_png(p, arr)
    elif ext == "bmp":
        imf.write_bmp(p, arr)
    else:
        imf.write_pnm(p, arr)
    _log.info("Saving image: '%s'", os.path.basename(p))


def _pil_image(arr: np.ndarray, what: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise CommandError(f"{what} needs PIL (Pillow), which is not "
                           "installed") from exc
    return Image.fromarray(np.moveaxis(arr, 0, 2).squeeze())


@command("savejpg", "savejpg filename [quality]", min_args=1)
def cmd_savejpg(ctx: Session, args: List[str]) -> None:
    pos, flags = parse_flags(args)
    img = ctx.require_image()
    p = _path(ctx, pos[0], "jpg")
    pim = _pil_image(img.to_u8(), "savejpg")
    pim.save(p, quality=int(_f(flags.get("quality"), 90) or 90))
    _log.info("Saving image: '%s'", os.path.basename(p))


@command("savepng", "savepng filename", min_args=1)
def cmd_savepng(ctx: Session, args: List[str]) -> None:
    _save(ctx, args, "png", 16)


@command("savetif", "savetif filename [-deflate]", min_args=1)
def cmd_savetif(ctx: Session, args: List[str]) -> None:
    _save(ctx, args, "tif", 16)


@command("savetif8", "savetif8 filename [-deflate]", min_args=1)
def cmd_savetif8(ctx: Session, args: List[str]) -> None:
    _save(ctx, args, "tif", 8)


@command("savetif32", "savetif32 filename", min_args=1)
def cmd_savetif32(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.image_formats import write_tiff

    write_tiff(_path(ctx, args[0], "tif"), ctx.require_image().host())


@command("savebmp", "savebmp filename", min_args=1)
def cmd_savebmp(ctx: Session, args: List[str]) -> None:
    _save(ctx, args, "bmp", 8)


@command("savepnm", "savepnm filename", min_args=1)
def cmd_savepnm(ctx: Session, args: List[str]) -> None:
    _save(ctx, args, "ppm", 8)


@command("savejxl", "savejxl filename [-quality=] [-effort=]", min_args=1)
def cmd_savejxl(ctx: Session, args: List[str]) -> None:
    pos, flags = parse_flags(args)
    img = ctx.require_image()
    pim = _pil_image(img.to_u8(), "savejxl")
    p = ctx.path(pos[0])
    if not p.lower().endswith(".jxl"):
        p += ".jxl"
    try:
        pim.save(p, quality=int(_f(flags.get("quality"), 90) or 90))
    except (KeyError, OSError, ValueError):
        raise CommandError("JPEG-XL encoder not available in this build")
    _log.info("Saving JXL: '%s'", os.path.basename(p))


@command("convertraw", "convertraw basename [-debayer] [-fitseq] [-ser] "
         "[-start=] [-out=]", min_args=1)
def cmd_convertraw(ctx: Session, args: List[str]) -> None:
    # the same engine as ``convert``, as in the JAX package
    COMMANDS["convert"].fn(ctx, args)
