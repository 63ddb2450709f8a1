"""Format conversion — counterpart of ``siril_tpu/io/conversion.py``
(``load_any``:26, ``convert_to_sequence``:106; reference
``src/io/conversion.c``).

FITS inputs only: ``convert`` rewrites them as ``name_00001.fit`` …,
``link`` symlinks them (FITS_symlink.c), and either writes the ``.seq``.
Other inputs raise ``NotImplementedError`` naming their ROADMAP item:
camera raw and PIL images (§1.5 OSC and the image formats), SER and films
(§1.5 SER / FITS-cube / film sequences), and the SER / FITS-cube outputs.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence as Seq

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence

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
            "§1.5, SER / FITS-cube / film sequences)")
    raise NotImplementedError(
        f"{path}: only FITS inputs are ported; camera raw, TIFF/PNG/JPEG "
        "and the other formats are not yet (ROADMAP §1.5, OSC and the "
        "image formats of io/)")


def convert_to_sequence(inputs: Seq[str], dest_name: str,
                        directory: str = ".", output: str = "fits",
                        symlink: bool = False, start: int = 1,
                        debayer: bool = False) -> Sequence:
    """``convert`` / ``link``: FITS files → ``dest_name%05d.fit`` and its
    ``.seq`` (conversion.c convert worker)."""
    if output != "fits":
        raise NotImplementedError(
            f"convert to {output}: SER and FITS-cube outputs are not ported "
            "yet (ROADMAP §1.5, SER / FITS-cube / film sequences)")
    if debayer:
        raise NotImplementedError(
            "convert -debayer: demosaicing is not ported yet (ROADMAP §1.5, "
            "OSC)")
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

            write_fits(load_any(src), out)
        files.append(out)
    _log.info("Converted %d files to sequence %s", len(files), dest_name)
    seq = Sequence.from_files(files, name=dest_name, directory=directory)
    seq.beg = start
    seq.save()                 # the reference writes the .seq on conversion
    return seq
