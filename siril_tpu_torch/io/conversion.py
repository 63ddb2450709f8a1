"""Format conversion — counterpart of ``siril_tpu/io/conversion.py``
(``load_any``:26, ``convert_to_sequence``:106, ``_read_item``:213;
reference ``src/io/conversion.c``).

Inputs: FITS files (``.fit.fz`` included), SER videos and films (an
uncompressed AVI through ``io/avi.py``; any other film, a compressed AVI
included, through OpenCV, which raises where it is not installed, as in
the JAX package), whose frames are expanded; camera raw (DNG, CR2, NEF,
ARW, RAF, RW2, PEF, ORF; CR3 and HEIF raise as in the JAX package) through
``io/dng.py`` and ``io/rawfile.py``, XISF, IRIS ``.pic``, and TIFF, PNG,
BMP and PNM through the port's own codec (``io/image_formats.py``).
JPEG, WebP, AVIF, and the TIFF / PNG variants the codec does not read
(LZW or PackBits TIFF, tiles, interlaced PNG) go through PIL, which
raises a ``ValueError`` naming PIL where it is not installed.
``convert`` rewrites them as ``name_00001.fit`` … and the ``.seq``
(with ``-debayer``, a CFA frame
demosaiced on ``device`` first: three layers, or half size with
super-pixel), or as one ``name_.ser`` video (``-ser``) or one FITS cube
``name_.fit`` (``-fitseq``); ``link`` symlinks FITS files
(FITS_symlink.c).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence as Seq, Tuple

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.device import DeviceLike

_log = logging.getLogger(__name__)

FITS_EXT = (".fit", ".fits", ".fts")
#: the threads of ``convert``'s FITS output: a camera-raw light is read
#: and decoded on the host, and its frame written, in about a second
CONVERT_THREADS = 4
#: the formats the JAX package reads through PIL
#: (``siril_tpu/io/conversion.py:22``)
PIL_EXT = (".tif", ".tiff", ".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm",
           ".pnm", ".webp", ".avif")
#: camera raw, by extension: (module, reader)
RAW_READERS = {".dng": ("dng", "read_dng"), ".cr2": ("rawfile", "read_cr2"),
               ".nef": ("rawfile", "read_nef"),
               ".arw": ("rawfile", "read_arw"),
               ".raf": ("rawfile", "read_raf"),
               ".rw2": ("rawfile", "read_rw2"),
               ".cr3": ("rawfile", "read_cr3"),
               ".pef": ("rawfile", "read_pef"),
               ".orf": ("rawfile", "read_orf"),
               ".heic": ("rawfile", "read_heif"),
               ".heif": ("rawfile", "read_heif")}
#: every extension ``load_any`` reads
IMAGE_EXT = FITS_EXT + PIL_EXT + tuple(RAW_READERS) + (".ser", ".xisf",
                                                       ".pic")


def read_pil(path: str) -> SirilImage:
    """A file through PIL, scaled as the JAX package scales it
    (``siril_tpu/io/conversion.py:75-91``): uint8 over 255, uint16 over
    65535, anything else as float32, an alpha layer dropped.  Raises a
    ``ValueError`` naming PIL where it is not installed."""
    import numpy as np

    from siril_tpu_torch.core.image import ensure_chw

    try:
        from PIL import Image
    except ImportError as exc:
        raise ValueError(f"{path}: this format needs PIL (Pillow), which "
                         "is not installed") from exc
    arr = np.asarray(Image.open(path))
    if arr.dtype == np.uint8:
        data = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        data = arr.astype(np.float32) / 65535.0
    else:
        data = arr.astype(np.float32)
    if data.ndim == 3 and data.shape[2] == 4:
        data = data[:, :, :3]
    img = SirilImage(data=ensure_chw(data))
    img.keywords.filename = os.path.basename(path)
    return img


def load_any(path: str) -> SirilImage:
    """Read a single image file: FITS (compressed too), camera raw, a
    SER video's first frame, XISF, IRIS ``.pic``, TIFF / PNG / BMP / PNM
    (the port's codec, PIL for the variants it does not read), and JPEG,
    WebP and AVIF through PIL.  A film is not an image: the JAX package
    refuses it too (``siril_tpu/io/conversion.py:103``); ``convert``
    expands it."""
    import importlib

    ext = os.path.splitext(path)[1].lower()
    if ext in FITS_EXT or path.lower().endswith((".fit.fz", ".fits.fz")):
        from siril_tpu_torch.io.fits_io import read_fits

        return read_fits(path)
    if ext in RAW_READERS:
        mod, fn = RAW_READERS[ext]
        return getattr(importlib.import_module(f"siril_tpu_torch.io.{mod}"),
                       fn)(path)
    if ext in PIL_EXT:
        from siril_tpu_torch.io import image_formats as imf

        if ext in imf.CODEC_EXT:
            try:
                return imf.read_image(path)
            except imf.Unsupported:
                pass
        return read_pil(path)
    if ext == ".ser":
        from siril_tpu_torch.io.ser import SerFile

        return SerFile(path).read_frame(0)
    if ext == ".xisf":
        from siril_tpu_torch.io.xisf import read_xisf

        return read_xisf(path)
    if ext == ".pic":
        from siril_tpu_torch.io.internal_formats import read_pic

        return read_pic(path)
    raise ValueError(f"unsupported input format: {path}")


def _read_item(item: Tuple[str, Optional[int]], debayer: bool,
               device: DeviceLike, films: Optional[dict] = None
               ) -> SirilImage:
    """A file, or frame ``sub`` of a SER video or of a film (its open
    reader in ``films``), demosaiced on ``device`` with ``debayer`` when
    it is a CFA frame."""
    src, sub = item
    if sub is not None and films and src in films:
        img = films[src].read_frame(sub)
    elif sub is not None:
        from siril_tpu_torch.io.ser import SerFile

        img = SerFile(src).read_frame(sub)
    else:
        img = load_any(src)
    if debayer and img.is_cfa():
        from siril_tpu_torch.ops.demosaic import debayer_image

        img = debayer_image(img, device=device)
    return img


def convert_to_sequence(inputs: Seq[str], dest_name: str,
                        directory: str = ".", output: str = "fits",
                        symlink: bool = False, start: int = 1,
                        debayer: bool = False,
                        device: DeviceLike = None) -> Sequence:
    """``convert`` / ``link`` (conversion.c convert worker): the inputs,
    each film's frames and each SER video's expanded (a SER video's
    unless the output is a SER video, which takes each input's first
    frame, as the JAX package does), →
    ``dest_name%05d.fit`` files and their ``.seq`` (``output`` "fits"),
    one ``dest_name.ser`` ("ser", 16-bit) or one FITS cube
    ``dest_name.fit`` and its ``.seq`` ("fitseq", at the first frame's bit
    depth).
    ``debayer`` demosaics CFA frames on ``device`` (CUDA unless "cpu").
    A symlinked FITS file is linked as it is."""
    if output not in ("fits", "ser", "fitseq"):
        raise ValueError(f"unknown conversion output {output!r}")
    inputs = sorted(inputs)
    if not inputs:
        raise ValueError("no input files")
    os.makedirs(directory, exist_ok=True)
    # conversion.c:1396: append '_' unless the name already ends with
    # '_', '-' or a digit → light → light_00001
    if dest_name and dest_name[-1] not in "_-0123456789":
        dest_name = dest_name + "_"
    from siril_tpu_torch.io.films import is_film, open_film

    expanded: List[Tuple[str, Optional[int]]] = []
    films = {}
    for p in inputs:
        if p.lower().endswith(".ser") and output != "ser":
            from siril_tpu_torch.io.ser import SerFile

            expanded.extend((p, i) for i in range(SerFile(p).frame_count))
        elif is_film(p):
            films[p] = open_film(p)
            expanded.extend((p, i) for i in range(films[p].nframes))
        else:
            expanded.append((p, None))

    if output == "ser":
        from siril_tpu_torch.io.ser import SER_MONO, SER_RGB, SerWriter

        first = _read_item(expanded[0], debayer, device, films)
        out_path = os.path.join(directory, dest_name + ".ser")
        w = SerWriter(out_path, first.width, first.height,
                      SER_RGB if first.nchans == 3 else SER_MONO, 16)
        for item in expanded:
            w.write_frame(_read_item(item, debayer, device, films))
        w.close()
        _log.info("Converted %d frames to %s", len(expanded), out_path)
        return Sequence.from_ser(out_path)
    if output == "fitseq":
        from siril_tpu_torch.io.fits_io import FitseqWriter

        out_path = os.path.join(directory, dest_name + ".fit")
        first = _read_item(expanded[0], debayer, device, films)
        w = FitseqWriter(out_path, bitdepth=first.orig_bitdepth)
        for item in expanded:
            w.append(_read_item(item, debayer, device, films))
        w.close()
        _log.info("Converted %d frames to the FITS cube %s", len(expanded),
                  out_path)
        # the .seq (TF) names the cube, as the reference writes it, so that
        # the sequence opens by name (the JAX package writes none)
        seq = Sequence.from_fitseq(out_path)
        seq.save()
        return seq

    def one(k: int) -> str:
        item = expanded[k]
        out = os.path.join(directory, f"{dest_name}{start + k:05d}.fit")
        src, sub = item
        if symlink and sub is None and \
                os.path.splitext(src)[1].lower() in FITS_EXT:
            if os.path.lexists(out):
                os.unlink(out)
            os.symlink(os.path.abspath(src), out)
        else:
            from siril_tpu_torch.io.fits_io import write_fits

            write_fits(_read_item(item, debayer, device, films), out)
        return out

    # files, read and written on CONVERT_THREADS threads (a film's frames
    # in order, on one: its reader is sequential)
    if films:
        files = [one(k) for k in range(len(expanded))]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(CONVERT_THREADS) as pool:
            files = list(pool.map(one, range(len(expanded))))
    _log.info("Converted %d files to sequence %s", len(files), dest_name)
    seq = Sequence.from_files(files, name=dest_name, directory=directory)
    seq.beg = start
    seq.save()                 # the reference writes the .seq on conversion
    return seq
