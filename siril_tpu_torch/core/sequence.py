"""Sequence model — counterpart of ``siril_tpu/core/sequence.py``
(RegData:46, from_files:110, from_ser:131, from_fitseq:150, scan:193,
from_film:173, read_frame:233, read_frame_metadata:252, open_reader:282,
read_region:300,
close_readers:307, selection and reference :316-332, reg:337, the
per-frame stats store :345-364, seqfile_path:369, save:372) and of the raw
chunk reader ``siril_tpu/pipeline.py:501``.

Four kinds of sequence: REGULAR (one FITS file per frame, compressed
``.fit.fz`` files included), SER (one ``.ser`` video), FITSEQ (a FITS
cube, one HDU per frame) and AVI (a film: an uncompressed AVI through
``io/avi.py``, any other through OpenCV, ``io/films.py``), with what a
``.seq`` sidecar keeps (``io/seqfile.py``): file numbers, the selection,
the reference, the frame sizes of a variable-size sequence, per-layer
registration data and per-frame statistics.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np

from siril_tpu_torch.core.image import Keywords, SirilImage
from siril_tpu_torch.utils import trace

# sequence types (siril.h:351-357)
SEQ_REGULAR = 0
SEQ_SER = 1
SEQ_FITSEQ = 2
SEQ_AVI = 3

# statistic columns of the (N, 14) per-layer stats store (io/seqfile.c:825)
STAT_COLS = ("total", "ngoodpix", "mean", "median", "sigma", "avgdev", "mad",
             "sqrtbwmv", "location", "scale", "min", "max", "normvalue",
             "bgnoise")
REG_COLS = ("fwhm", "weighted_fwhm", "roundness", "quality",
            "background_lvl", "number_of_stars")


@dataclass
class RegData:
    """Columnar registration data for one layer (regdata, siril.h:433)."""

    n: int
    fwhm: np.ndarray = None
    weighted_fwhm: np.ndarray = None     # (N,) for -weight_from_wfwhm
    roundness: np.ndarray = None
    quality: np.ndarray = None
    background_lvl: np.ndarray = None
    number_of_stars: np.ndarray = None   # (N,) for -weight_from_nbstars
    H: np.ndarray = None                 # (N, 3, 3) float64 homographies
    valid: np.ndarray = None             # bool: regdata exists for frame

    def __post_init__(self):
        n = self.n
        if self.fwhm is None:
            self.fwhm = np.zeros(n)
            self.weighted_fwhm = np.zeros(n)
            self.roundness = np.zeros(n)
            self.quality = np.full(n, -1.0)
            self.background_lvl = np.zeros(n)
            self.number_of_stars = np.zeros(n, dtype=np.int32)
            self.H = np.tile(np.eye(3), (n, 1, 1))
            self.valid = np.zeros(n, dtype=bool)


class Sequence:
    """A sequence of frames with registration state."""

    def __init__(self, name: str, directory: str = ".",
                 seq_type: int = SEQ_REGULAR):
        self.name = name                 # base name without .seq
        self.directory = directory
        self.seq_type = seq_type
        #: the frames are tile-compressed ``.fit.fz`` files
        self.fz = False
        self.beg = 0
        self.fixed_len = 5               # zero-padding of file numbers
        self.number = 0
        self.nb_layers = -1
        self.rx = 0
        self.ry = 0
        #: frames of different sizes: (N, 2) (rx, ry) of each frame
        self.is_variable = False
        self.imgsize: Optional[np.ndarray] = None
        self.filenum = np.zeros(0, dtype=np.int64)
        #: layer → (N, 14) float64 statistics, NaN where absent
        self.stats: Dict[int, np.ndarray] = {}
        self.reference_image = -1
        self.incl = np.zeros(0, dtype=bool)
        self.regparam: Dict[int, RegData] = {}
        self._readers: Dict[int, object] = {}
        self._reader_lock = threading.Lock()
        self._file_list: List[str] = []
        self._ser = None                 # SerFile of a SER sequence
        self._fitseq_path: Optional[str] = None
        self._film = None                # AviReader / FilmReader of a film
        #: D/O/E cards of a read .seq, written back unchanged
        self._opaque_cards: List[str] = []

    @staticmethod
    def from_files(files: Seq[str], name: str = "sequence",
                   directory: Optional[str] = None) -> "Sequence":
        files = sorted(os.fspath(f) for f in files)
        if not files:
            raise ValueError("empty file list")
        seq = Sequence(name, directory or os.path.dirname(files[0]) or ".")
        seq._file_list = [os.path.abspath(f) for f in files]
        seq.number = len(files)
        nums = []
        for i, f in enumerate(files):
            m = re.search(r"(\d+)(?=\.[^.]+(\.fz)?$)", os.path.basename(f))
            nums.append(int(m.group(1)) if m else i)
        seq.filenum = np.asarray(nums, dtype=np.int64)
        seq.incl = np.ones(len(files), dtype=bool)
        seq._probe_geometry()
        return seq

    @staticmethod
    def from_ser(path: str) -> "Sequence":
        """The frames of a ``.ser`` video."""
        from siril_tpu_torch.io.ser import SerFile

        ser = SerFile(path)
        seq = Sequence(os.path.splitext(os.path.basename(path))[0],
                       os.path.dirname(path) or ".", SEQ_SER)
        seq._ser = ser
        seq.number = ser.frame_count
        seq.rx, seq.ry = ser.width, ser.height
        seq.nb_layers = ser.nchans
        seq.filenum = np.arange(seq.number, dtype=np.int64)
        seq.incl = np.ones(seq.number, dtype=bool)
        return seq

    @staticmethod
    def from_fitseq(path: str) -> "Sequence":
        """The image HDUs of a FITS cube (io/fits_sequence.c)."""
        from siril_tpu_torch.io.fits_io import image_hdus

        hdus = image_hdus(path)
        if not hdus:
            raise ValueError(f"{path}: no image HDUs")
        seq = Sequence(os.path.splitext(os.path.basename(path))[0],
                       os.path.dirname(path) or ".", SEQ_FITSEQ)
        seq._fitseq_path = os.path.abspath(path)
        seq.number = len(hdus)
        seq.nb_layers, seq.ry, seq.rx = hdus[0].shape_chw
        seq.filenum = np.arange(seq.number, dtype=np.int64)
        seq.incl = np.ones(seq.number, dtype=bool)
        return seq

    @staticmethod
    def from_film(path: str) -> "Sequence":
        """The frames of a film (SEQ_AVI, io/films.c film_struct):
        ``io/films.open_film`` reads an uncompressed AVI itself and any
        other film through OpenCV."""
        from siril_tpu_torch.io.films import open_film

        film = open_film(path)
        seq = Sequence(os.path.splitext(os.path.basename(path))[0],
                       os.path.dirname(path) or ".", SEQ_AVI)
        seq._film = film
        seq.number = film.nframes
        seq.rx, seq.ry = film.w, film.h
        seq.nb_layers = film.nchans
        seq.filenum = np.arange(seq.number, dtype=np.int64)
        seq.incl = np.ones(seq.number, dtype=bool)
        return seq

    def _probe_geometry(self) -> None:
        from siril_tpu_torch.io.fits_io import image_hdus, zimage_hdus

        first = next((f for f in self._file_list if f), None)
        if first is None:
            return
        hdus = image_hdus(first)
        if hdus:
            self.nb_layers, self.ry, self.rx = hdus[0].shape_chw
            return
        z = zimage_hdus(first)
        if z:
            g = z[0].header.get
            self.nb_layers, self.ry, self.rx = (int(g("ZNAXIS3", 1)),
                                                int(g("ZNAXIS2")),
                                                int(g("ZNAXIS1")))

    @staticmethod
    def scan(basename: str, directory: str = ".") -> "Sequence":
        """Discover ``basename%05d.fit`` files, or ``.fit.fz`` ones
        (check_seq, io/sequence.c:169)."""
        files = []
        for ext in ("fit", "fits", "fts", "fit.fz", "fits.fz"):
            files.extend(glob.glob(os.path.join(directory,
                                                f"{basename}*.{ext}")))
        pat = re.compile(re.escape(basename)
                         + r"(\d+)\.(fit|fits|fts)(\.fz)?$")
        matched = [f for f in files if pat.search(os.path.basename(f))]
        if not matched:
            raise FileNotFoundError(
                f"no files matching {basename}NNNNN.fit in {directory}")
        seq = Sequence.from_files(matched, name=basename,
                                  directory=directory)
        m0 = pat.search(os.path.basename(seq._file_list[0]))
        seq.fixed_len = len(m0.group(1))
        seq.beg = int(seq.filenum.min())
        # the .seq's fz flag, so that the sidecar finds the files again
        # (the JAX package leaves it 0 after a scan)
        seq.fz = all(f.endswith(".fz") for f in seq._file_list)
        return seq

    def frame_path(self, index: int) -> Optional[str]:
        """The file of frame ``index`` of a sequence of files, else None."""
        if self.seq_type == SEQ_REGULAR:
            return self._file_list[index]
        return None

    def read_frame(self, index: int) -> SirilImage:
        from siril_tpu_torch.io.fits_io import read_fits

        if self.seq_type == SEQ_SER:
            img = self._ser.read_frame(index)
        elif self.seq_type == SEQ_FITSEQ:
            img = read_fits(self._fitseq_path, hdu_index=index)
        elif self.seq_type == SEQ_AVI:
            img = self._film.read_frame(index)
        else:
            img = read_fits(self._file_list[index])
        trace.count("io.frames_read")
        if self.nb_layers < 0:
            self.nb_layers = img.nchans
            self.rx, self.ry = img.width, img.height
        return img

    def read_frame_metadata(self, index: int) -> Keywords:
        """Keywords only, no pixel read (io/sequence.c:1052)."""
        from siril_tpu_torch.io.fits_io import (
            header_to_keywords,
            image_hdus,
            zimage_hdus,
        )

        if self.seq_type == SEQ_SER:
            from siril_tpu_torch.io.ser import ticks_to_iso

            h = self._ser.header
            kw = Keywords(instrume=h.instrument, telescop=h.telescope)
            if h.timestamps and index < len(h.timestamps):
                kw.date_obs = ticks_to_iso(h.timestamps[index])
            return kw
        if self.seq_type == SEQ_AVI:
            return Keywords()
        if self.seq_type == SEQ_FITSEQ:
            hdus = image_hdus(self._fitseq_path)
            return header_to_keywords(hdus[index].header) \
                if index < len(hdus) else Keywords()
        path = self._file_list[index]
        hdus = image_hdus(path) or zimage_hdus(path)
        return header_to_keywords(hdus[0].header) if hdus else Keywords()

    def open_reader(self, index: int):
        """The cached random-access reader of frame ``index`` (files and
        FITS cubes)."""
        if self.seq_type in (SEQ_SER, SEQ_AVI):
            raise ValueError("open_reader: a SER or film sequence has no "
                             "FITS reader")
        with self._reader_lock:
            r = self._readers.get(index)
            if r is None:
                from siril_tpu_torch.io.fits_io import FitsReader

                r = FitsReader(self._fitseq_path, hdu_index=index) \
                    if self.seq_type == SEQ_FITSEQ \
                    else FitsReader(self._file_list[index])
                self._readers[index] = r
            return r

    def read_region(self, chan: int, index: int, y0: int,
                    y1: int) -> np.ndarray:
        """Rows [y0, y1) of channel ``chan`` of frame ``index``, top-down
        [0, 1] float32 (seq_opened_read_region, io/sequence.c:1282)."""
        if self.seq_type == SEQ_SER:
            return self._ser.read_region(chan, index, y0, y1)
        if self.seq_type == SEQ_AVI:
            return self.read_frame(index).host()[chan, y0:y1]
        return self.open_reader(index).read_region(chan, y0, y1)

    def close_readers(self) -> None:
        with self._reader_lock:
            self._readers.clear()

    @property
    def selnum(self) -> int:
        return int(self.incl.sum())

    def selected_indices(self) -> np.ndarray:
        return np.nonzero(self.incl)[0]

    def get_reference(self) -> int:
        """Reference frame, or the first included one (sequence.c)."""
        if 0 <= self.reference_image < self.number and \
                self.incl[self.reference_image]:
            return self.reference_image
        sel = self.selected_indices()
        return int(sel[0]) if len(sel) else 0

    def reg(self, layer: int) -> RegData:
        if layer not in self.regparam:
            self.regparam[layer] = RegData(self.number)
        return self.regparam[layer]

    def has_reg(self, layer: int) -> bool:
        return layer in self.regparam and \
            bool(self.regparam[layer].valid.any())

    def layer_stats(self, layer: int) -> np.ndarray:
        if layer not in self.stats:
            self.stats[layer] = np.full((self.number, len(STAT_COLS)),
                                        np.nan)
        return self.stats[layer]

    def set_frame_stats(self, layer: int, index: int, st) -> None:
        """Keep an ImStats for (layer, frame) in the columnar store."""
        self.layer_stats(layer)[index] = [getattr(st, c) for c in STAT_COLS]

    def get_frame_stats(self, layer: int, index: int):
        """The stored ImStats of (layer, frame), or None."""
        if layer not in self.stats:
            return None
        row = self.stats[layer][index]
        if np.isnan(row[2:]).all():
            return None
        from siril_tpu_torch.ops.statistics import ImStats

        return ImStats(**{c: float(row[i])
                          for i, c in enumerate(STAT_COLS)})

    def seqfile_path(self) -> str:
        return os.path.join(self.directory, self.name + ".seq")

    def save(self) -> None:
        """Write the ``.seq`` sidecar (writeseqfile, io/seqfile.c:720)."""
        from siril_tpu_torch.io.seqfile import write_seqfile

        write_seqfile(self)


def raw_chunk_reader(seq: Sequence, indices: np.ndarray, L: int, H: int,
                     W: int, workers: int = 8):
    """Chunk reader producing native int16 ([n, L, H, W], the u16 FITS
    layout the device decodes; files and FITS cubes) or float32 frames,
    rows top-down (``siril_tpu/pipeline.py:501``).  Returns
    ``(read_chunk, close)``."""
    u16 = seq.seq_type in (SEQ_REGULAR, SEQ_FITSEQ) and \
        seq.open_reader(int(indices[0])).is_u16()
    pool = cf.ThreadPoolExecutor(max_workers=workers)

    def read_chunk(start: int, count: int) -> np.ndarray:
        out = np.empty((count, L, H, W), np.int16 if u16 else np.float32)

        def one(j):
            idx = int(indices[start + j])
            out[j] = seq.open_reader(idx).raw_topdown("<i2") if u16 \
                else seq.read_frame(idx).host()

        list(pool.map(one, range(count)))
        if u16:                     # read_frame counts the others
            trace.count("io.frames_read", count)
        return out

    return read_chunk, pool.shutdown
