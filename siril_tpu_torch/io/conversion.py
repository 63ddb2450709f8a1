"""Format conversion — counterpart of ``siril_tpu/io/conversion.py``
(``load_any``:26, ``convert_to_sequence``:106, ``_read_item``:213;
reference ``src/io/conversion.c``).

FITS inputs only: ``convert`` rewrites them as ``name_00001.fit`` …
(with ``-debayer``, a CFA frame demosaiced on ``device`` first: three
layers, or half size with super-pixel), ``link`` symlinks them
(FITS_symlink.c), and either writes the ``.seq``.  Other inputs raise
``NotImplementedError`` naming their ROADMAP item: SER and films, and
the SER / FITS-cube outputs (§1.3 SER / FITS-cube / film sequences),
camera raw and PIL images (§1.5 image formats for convert).
"""

from __future__ import annotations

import logging
import os
from typing import Sequence as Seq

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.device import DeviceLike

_log = logging.getLogger(__name__)

FITS_EXT = (".fit", ".fits", ".fts")


def load_any(path: str) -> SirilImage:
    """Read a single FITS image file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in FITS_EXT:
        from siril_tpu_torch.io.fits_io import read_fits

        return read_fits(path)
    if ext in (".ser", ".avi", ".mp4", ".mov", ".mkv", ".webm"):
        raise NotImplementedError(
            f"{path}: SER and film inputs are not ported yet (ROADMAP "
            "§1.3, SER / FITS-cube / film sequences)")
    raise NotImplementedError(
        f"{path}: only FITS inputs are ported; camera raw, TIFF/PNG/JPEG "
        "and the other formats are not yet (ROADMAP §1.5, image formats "
        "for convert)")


def convert_to_sequence(inputs: Seq[str], dest_name: str,
                        directory: str = ".", output: str = "fits",
                        symlink: bool = False, start: int = 1,
                        debayer: bool = False,
                        device: DeviceLike = None) -> Sequence:
    """``convert`` / ``link``: FITS files → ``dest_name%05d.fit`` and its
    ``.seq`` (conversion.c convert worker); ``debayer`` demosaics CFA
    frames on ``device`` (CUDA unless "cpu") before writing them.  A
    symlinked FITS file is linked as it is."""
    if output != "fits":
        raise NotImplementedError(
            f"convert to {output}: SER and FITS-cube outputs are not ported "
            "yet (ROADMAP §1.3, SER / FITS-cube / film sequences)")
    inputs = sorted(inputs)
    if not inputs:
        raise ValueError("no input files")
    os.makedirs(directory, exist_ok=True)
    # conversion.c:1396: append '_' unless the name already ends with
    # '_', '-' or a digit → light → light_00001
    if dest_name and dest_name[-1] not in "_-0123456789":
        dest_name = dest_name + "_"
    files = []
    for k, src in enumerate(inputs):
        out = os.path.join(directory, f"{dest_name}{start + k:05d}.fit")
        if symlink and os.path.splitext(src)[1].lower() in FITS_EXT:
            if os.path.lexists(out):
                os.unlink(out)
            os.symlink(os.path.abspath(src), out)
        else:
            from siril_tpu_torch.io.fits_io import write_fits

            img = load_any(src)
            if debayer and img.is_cfa():
                from siril_tpu_torch.ops.demosaic import debayer_image

                img = debayer_image(img, device=device)
            write_fits(img, out)
        files.append(out)
    _log.info("Converted %d files to sequence %s", len(files), dest_name)
    seq = Sequence.from_files(files, name=dest_name, directory=directory)
    seq.beg = start
    seq.save()                 # the reference writes the .seq on conversion
    return seq
