"""Image container — counterpart of ``siril_tpu/core/image.py``.

A trimmed copy: the fields and keywords the ported commands read and
write (``_finalize_metadata``, calibration, the FITS boundary) and the
plate solution (``wcs``: an ``ops.wcs.WCS`` or None, shared by copies as
in the JAX package, ``core/image.py:119, 186-198``), and the mask that
the image ops blend their result through (``mask``, ``mask_active``,
``apply_mask_blend``: ``core/image.py:117-118, 207-216``), and the
embedded ICC profile (``icc_profile``, ``core/image.py:122``) and the
source FITS header (``fits_header``; the JAX package keeps its text,
``header_text``, ``core/image.py:115``).  Pixel data is
a planar (C, H, W) float32 numpy array in Siril's [0, 1] convention.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

USHRT_MAX_SINGLE = 65535.0
INV_USHRT_MAX_SINGLE = 1.0 / 65535.0
UCHAR_MAX_SINGLE = 255.0

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
    binning_x: int = 1
    binning_y: int = 1
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
    mask: Optional[Any] = None          # (H, W) float32 in [0, 1], or None
    mask_active: bool = False
    #: the raw bytes of an embedded ICC profile (ffit.icc_profile), kept
    #: by copies and written as the FITS ``ICCProfile`` extension
    icc_profile: Optional[bytes] = None
    #: the source file's parsed FITS header (an ``io.fits_io.Header``),
    #: formatted only by ``dumpheader``; shared by copies
    fits_header: Optional[Any] = None

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

    def to_u16(self) -> np.ndarray:
        """(C, H, W) uint16 by Siril's float → ushort rule: the value
        clipped to [0, 1], times 65535, rounded half to even
        (``core/image.py:169-172``)."""
        return self._quantize(USHRT_MAX_SINGLE, np.uint16)

    def to_u8(self) -> np.ndarray:
        """(C, H, W) uint8, as ``to_u16`` with 255 (``core/image.py:174``)."""
        return self._quantize(UCHAR_MAX_SINGLE, np.uint8)

    def _quantize(self, top: float, dtype) -> np.ndarray:
        """rint(clip(x, 0, 1) · top) in float32, in place on one copy."""
        a = np.clip(self.host(), 0.0, 1.0)
        a *= np.float32(top)
        np.rint(a, out=a)
        return a.astype(dtype)

    def copy(self, data: Any = None) -> "SirilImage":
        """A copy with ``data`` (default: a copy of this data); keywords
        and history copied, bit depth and WCS kept (``SirilImage.copy``)."""
        d = data if data is not None else np.array(self.data)
        return SirilImage(data=d, keywords=self.keywords.copy(),
                          orig_bitdepth=self.orig_bitdepth,
                          history=list(self.history), wcs=self.wcs,
                          mask=None if self.mask is None
                          else np.array(self.mask),
                          mask_active=self.mask_active,
                          icc_profile=self.icc_profile,
                          fits_header=self.fits_header)

    def log_history(self, msg: str) -> None:
        self.history.append(msg)

    def apply_mask_blend(self, new_data):
        """``mask·new + (1 − mask)·old`` while a mask is active, else
        ``new_data`` (src/core/masks.c's blend): on the device of a
        tensor result, in numpy for an array."""
        if not self.mask_active or self.mask is None:
            return new_data
        if isinstance(new_data, np.ndarray):
            m = np.asarray(self.mask, np.float32)[None]
            return m * new_data + (1.0 - m) * self.host()
        import torch

        dev = new_data.device
        m = torch.from_numpy(np.asarray(self.mask, np.float32)).to(dev)[None]
        old = torch.from_numpy(self.host()).to(dev)
        return m * new_data + (1.0 - m) * old


def ensure_chw(arr: np.ndarray) -> np.ndarray:
    """An (H, W), (C, H, W) or interleaved (H, W, C) array as planar
    (C, H, W) float32 (``core/image.py:219``)."""
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 2:
        return a[None]
    if a.ndim == 3:
        if a.shape[0] in (1, 3):
            return a
        if a.shape[2] in (1, 3):
            return np.ascontiguousarray(np.moveaxis(a, 2, 0))
    raise ValueError(f"unsupported image shape {a.shape}")
