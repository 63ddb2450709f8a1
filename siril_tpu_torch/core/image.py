"""Image container — counterpart of ``siril_tpu/core/image.py``.

A trimmed copy: the fields and keywords the ported commands read and
write (``_finalize_metadata``, calibration, the FITS boundary) and the
plate solution (``wcs``: an ``ops.wcs.WCS`` or None, shared by copies as
in the JAX package, ``core/image.py:119, 186-198``).  Pixel data is a
planar (C, H, W) float32 numpy array in Siril's [0, 1] convention.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

INV_USHRT_MAX_SINGLE = 1.0 / 65535.0

# Siril bitpix naming (cfitsio values)
BYTE_IMG = 8
SHORT_IMG = 16
USHORT_IMG = 20
LONG_IMG = 32
FLOAT_IMG = -32
DOUBLE_IMG = -64


@dataclass
class Keywords:
    """FITS keyword metadata (``fkeywords``, siril.h:566-616).  Unmapped
    header cards are preserved verbatim in ``extra``."""

    bscale: float = 1.0
    bzero: float = 0.0
    program: str = ""
    filename: str = ""
    pixel_size_x: float = 0.0
    row_order: str = ""
    date: Optional[str] = None
    date_obs: Optional[str] = None
    filter: str = ""
    image_type: str = ""
    object: str = ""
    instrume: str = ""
    telescop: str = ""
    observer: str = ""
    bayer_pattern: str = ""
    bayer_xoffset: int = 0
    bayer_yoffset: int = 0
    focal_length: float = 0.0
    exposure: float = 0.0
    livetime: float = 0.0
    stackcnt: int = 0
    gain: int = 0
    offset: int = 0
    ccd_temp: float = -999.0
    extra: dict = field(default_factory=dict)

    def copy(self) -> "Keywords":
        k = dataclasses.replace(self)
        k.extra = dict(self.extra)
        return k


@dataclass
class SirilImage:
    """Planar float32 host image + metadata (``struct ffit``)."""

    data: Any
    keywords: Keywords = field(default_factory=Keywords)
    orig_bitdepth: int = FLOAT_IMG
    history: list = field(default_factory=list)
    wcs: Optional[Any] = None

    @property
    def nchans(self) -> int:
        return int(self.data.shape[0])

    @property
    def height(self) -> int:
        return int(self.data.shape[1])

    @property
    def width(self) -> int:
        return int(self.data.shape[2])

    def host(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float32)

    def is_cfa(self) -> bool:
        """One layer with a Bayer or X-Trans pattern (BAYERPAT)."""
        return self.nchans == 1 and bool(self.keywords.bayer_pattern)

    def copy(self, data: Any = None) -> "SirilImage":
        """A copy with ``data`` (default: a copy of this data); keywords
        and history copied, bit depth and WCS kept (``SirilImage.copy``)."""
        d = data if data is not None else np.array(self.data)
        return SirilImage(data=d, keywords=self.keywords.copy(),
                          orig_bitdepth=self.orig_bitdepth,
                          history=list(self.history), wcs=self.wcs)

    def log_history(self, msg: str) -> None:
        self.history.append(msg)
