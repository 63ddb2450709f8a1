"""Sequence model — counterpart of ``siril_tpu/core/sequence.py``
(RegData:46, from_files:110, scan:193, read_frame:233, read_region:300,
close_readers:307, selection and reference :316-332, reg:337, the
per-frame stats store :345-364, seqfile_path:369, save:372) and of the raw
chunk reader ``siril_tpu/pipeline.py:501``.

A trimmed copy: REGULAR sequences (one FITS file per frame), with what a
``.seq`` sidecar keeps (``io/seqfile.py``): file numbers, the selection,
the reference, the frame sizes of a variable-size sequence, per-layer
registration data and per-frame statistics.  SER, FITS cubes and films
are off the ported paths (ROADMAP §1.3).
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

# sequence type of a file-per-frame sequence (siril.h:351-357)
SEQ_REGULAR = 0

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
    """A REGULAR sequence of FITS frames with registration state."""

    def __init__(self, name: str, directory: str = "."):
        self.name = name                 # base name without .seq
        self.directory = directory
        self.seq_type = SEQ_REGULAR
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
            m = re.search(r"(\d+)(?=\.[^.]+$)", os.path.basename(f))
            nums.append(int(m.group(1)) if m else i)
        seq.filenum = np.asarray(nums, dtype=np.int64)
        seq.incl = np.ones(len(files), dtype=bool)
        seq._probe_geometry()
        return seq

    def _probe_geometry(self) -> None:
        from siril_tpu_torch.io.fits_io import image_hdus

        first = next((f for f in self._file_list if f), None)
        hdus = image_hdus(first) if first else []
        if hdus:
            self.nb_layers, self.ry, self.rx = hdus[0].shape_chw

    @staticmethod
    def scan(basename: str, directory: str = ".") -> "Sequence":
        """Discover ``basename%05d.fit`` files (check_seq,
        io/sequence.c:169)."""
        files = []
        for ext in ("fit", "fits", "fts"):
            files.extend(glob.glob(os.path.join(directory,
                                                f"{basename}*.{ext}")))
        pat = re.compile(re.escape(basename) + r"(\d+)\.(fit|fits|fts)$")
        matched = [f for f in files if pat.search(os.path.basename(f))]
        if not matched:
            raise FileNotFoundError(
                f"no files matching {basename}NNNNN.fit in {directory}")
        seq = Sequence.from_files(matched, name=basename,
                                  directory=directory)
        m0 = pat.search(os.path.basename(seq._file_list[0]))
        seq.fixed_len = len(m0.group(1))
        seq.beg = int(seq.filenum.min())
        return seq

    def read_frame(self, index: int) -> SirilImage:
        from siril_tpu_torch.io.fits_io import read_fits

        img = read_fits(self._file_list[index])
        if self.nb_layers < 0:
            self.nb_layers = img.nchans
            self.rx, self.ry = img.width, img.height
        return img

    def read_frame_metadata(self, index: int) -> Keywords:
        """Keywords only, no pixel read (io/sequence.c:1052)."""
        from siril_tpu_torch.io.fits_io import header_to_keywords, image_hdus

        hdus = image_hdus(self._file_list[index])
        return header_to_keywords(hdus[0].header) if hdus else Keywords()

    def open_reader(self, index: int):
        with self._reader_lock:
            r = self._readers.get(index)
            if r is None:
                from siril_tpu_torch.io.fits_io import FitsReader

                r = FitsReader(self._file_list[index])
                self._readers[index] = r
            return r

    def read_region(self, chan: int, index: int, y0: int,
                    y1: int) -> np.ndarray:
        """Rows [y0, y1) of channel ``chan`` of frame ``index``, top-down
        [0, 1] float32 (seq_opened_read_region, io/sequence.c:1282)."""
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
    layout the device decodes) or float32 frames, rows top-down
    (``siril_tpu/pipeline.py:501``).  Returns ``(read_chunk, close)``."""
    u16 = seq.open_reader(int(indices[0])).is_u16()
    pool = cf.ThreadPoolExecutor(max_workers=workers)

    def read_chunk(start: int, count: int) -> np.ndarray:
        out = np.empty((count, L, H, W), np.int16 if u16 else np.float32)

        def one(j):
            idx = int(indices[start + j])
            out[j] = seq.open_reader(idx).raw_i16_topdown() if u16 \
                else seq.read_frame(idx).host()

        list(pool.map(one, range(count)))
        return out

    return read_chunk, pool.shutdown
