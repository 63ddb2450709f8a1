"""Films — counterpart of ``siril_tpu/io/films.py`` (``FILM_EXTENSIONS``
and ``is_film``:30, ``FilmReader``:46), the reference's
``src/io/films.c``.  Uncompressed AVI is read by ``io/avi.py``; every
other film (and a compressed AVI) decodes through OpenCV's ffmpeg
backend, which ``FilmReader`` imports when it opens a film and which
raises, as in the JAX package, where OpenCV is not installed.
``open_film`` picks the reader.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from siril_tpu_torch.core.image import BYTE_IMG, SirilImage

#: src/io/films.c:40-47 supported_film[]
FILM_EXTENSIONS = (".avi", ".mpg", ".mpeg", ".mov", ".mp4", ".webm")


def is_film(path: str) -> bool:
    """check_for_film_extensions (films.c:59)."""
    return os.path.splitext(path)[1].lower() in FILM_EXTENSIONS


def _cv2():
    try:
        import cv2

        return cv2
    except ImportError:
        raise RuntimeError(
            "film import requires OpenCV with ffmpeg support "
            "(reference builds with HAVE_FFMPEG)")


class FilmReader:
    """Sequential and seekable film reader through OpenCV (film_struct,
    films.h:21-33): frames as float32 [C, H, W], colour films RGB, a film
    whose sampled frames are grey kept mono."""

    def __init__(self, path: str):
        cv2 = _cv2()
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise ValueError(f"cannot open film {path}")
        self.w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.nframes = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._lock = threading.Lock()
        ok, f0 = self._cap.read()
        if not ok:
            raise ValueError(f"cannot decode first frame of {path}")
        self._pos = 1
        gray = self._is_gray(f0)
        if self.nframes <= 0:
            n = self._pos
            while self._cap.grab():
                n += 1
            self.nframes = n
        if gray and self.nframes > 1:
            # sample across the film: a colour film fading in from black
            # starts with grey frames
            for k in (self.nframes // 4, self.nframes // 2,
                      (3 * self.nframes) // 4):
                self._seek(max(k, 1))
                ok, f = self._cap.read()
                if ok and not self._is_gray(f):
                    gray = False
                    break
        self.nchans = 1 if gray else 3
        self._seek(0)

    @staticmethod
    def _is_gray(bgr: np.ndarray) -> bool:
        if bgr.ndim == 2:
            return True
        return bool(np.array_equal(bgr[..., 0], bgr[..., 1]) and
                    np.array_equal(bgr[..., 1], bgr[..., 2]))

    def _seek(self, index: int) -> None:
        self._cap.set(_cv2().CAP_PROP_POS_FRAMES, index)
        self._pos = index

    def read_frame(self, index: int) -> SirilImage:
        """film_read_frame (films.c:215), sequential when it can be."""
        with self._lock:
            if index != self._pos:
                self._seek(index)
            ok, frame = self._cap.read()
            self._pos = index + 1
        if not ok:
            raise ValueError(f"cannot decode frame {index} of {self.path}")
        if frame.ndim == 2:
            data = frame.astype(np.float32)[None] / 255.0
        elif self.nchans == 1:
            data = frame[..., 0].astype(np.float32)[None] / 255.0
        else:
            data = frame[..., ::-1].transpose(2, 0, 1).astype(
                np.float32) / 255.0
        img = SirilImage(data=np.ascontiguousarray(data),
                         orig_bitdepth=BYTE_IMG)
        img.keywords.filename = os.path.basename(self.path)
        return img

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


def open_film(path: str):
    """The reader of a film: ``AviReader`` for an uncompressed AVI, else
    ``FilmReader`` (a compressed AVI falls through to it, as in
    ``siril_tpu/io/conversion.py:122-136``)."""
    if path.lower().endswith(".avi"):
        from siril_tpu_torch.io.avi import AviReader

        try:
            return AviReader(path)
        except ValueError:
            pass
    return FilmReader(path)
