"""A plain FITS writer: one primary HDU, mono, 16-bit unsigned (BITPIX 16
with BZERO 32768) or float32 (BITPIX -32), rows top-down with
``ROWORDER = 'TOP-DOWN'`` as capture programs write them.  It owes
nothing to the program under test."""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np

BLOCK = 2880


def _card(key: str, value=None, comment: str = "") -> bytes:
    if key == "END":
        return b"END".ljust(80)
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, str):
        v = ("'" + value.replace("'", "''").ljust(8) + "'").ljust(20)
    elif isinstance(value, float):
        v = f"{value:.10G}"
    else:
        v = str(value)
    text = f"{key:<8}= {v:>20}"
    if comment:
        text += f" / {comment}"
    return text[:80].ljust(80).encode("ascii")


def header(bitpix: int, height: int, width: int,
           extra: Iterable[Tuple[str, object]] = ()) -> bytes:
    cards = [_card("SIMPLE", True), _card("BITPIX", bitpix),
             _card("NAXIS", 2), _card("NAXIS1", width),
             _card("NAXIS2", height)]
    if bitpix == 16:
        cards += [_card("BZERO", 32768), _card("BSCALE", 1)]
    cards += [_card("ROWORDER", "TOP-DOWN")]
    cards += [_card(k, v) for k, v in extra]
    cards.append(_card("END"))
    raw = b"".join(cards)
    return raw + b" " * (-len(raw) % BLOCK)


def _durable(f) -> None:
    """On disk before set-up ends: no write-back of the inputs runs
    under the measured window."""
    f.flush()
    os.fsync(f.fileno())


def write_be_words(path: str, height: int, width: int, data: bytes,
                   extra=()) -> None:
    """A 16-bit frame whose ``data`` are already the big-endian signed
    words (the unsigned value less 32768), ``height`` rows top-down."""
    assert len(data) == 2 * height * width
    with open(path, "wb") as f:
        f.write(header(16, height, width, extra))
        f.write(data)
        f.write(b"\0" * (-len(data) % BLOCK))
        _durable(f)


def write_float32(path: str, img: np.ndarray, extra=()) -> None:
    """An (H, W) float32 image, rows top-down."""
    h, w = img.shape
    data = np.ascontiguousarray(img, ">f4").tobytes()
    with open(path, "wb") as f:
        f.write(header(-32, h, w, extra))
        f.write(data)
        f.write(b"\0" * (-len(data) % BLOCK))
        _durable(f)
