"""A plain FITS reader for the reference: the primary HDU of a mono
image, BITPIX 16 (unsigned through BZERO 32768, as [0, 1] by 65535) or
-32, with rows returned top-down (``ROWORDER``, whose default is
bottom-up)."""

from __future__ import annotations

import numpy as np

BLOCK = 2880


def read_header(f) -> dict:
    cards = {}
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                return cards
            if card[8:10] != "= ":
                continue
            val = card[10:].split("/")[0].strip() if "'" not in card[10:] \
                else card[10:].split("'")[1].strip()
            cards[key] = val


def read_image(path: str) -> np.ndarray:
    """(H, W): float64 in [0, 1] for 16-bit data, float32 as stored for
    BITPIX -32."""
    with open(path, "rb") as f:
        h = read_header(f)
        bitpix = int(h["BITPIX"])
        w, hgt = int(h["NAXIS1"]), int(h["NAXIS2"])
        if int(h.get("NAXIS", 2)) > 2 and int(h.get("NAXIS3", 1)) != 1:
            raise ValueError("the reader takes mono images only")
        if bitpix == 16:
            raw = np.frombuffer(f.read(2 * w * hgt), ">i2")
            data = (raw.astype(np.float64) + float(h.get("BZERO", 0))) \
                / 65535.0
        elif bitpix == -32:
            data = np.frombuffer(f.read(4 * w * hgt), ">f4").astype(
                np.float32)
        else:
            raise ValueError(f"BITPIX {bitpix} not read")
    data = data.reshape(hgt, w)
    if h.get("ROWORDER", "BOTTOM-UP").upper() != "TOP-DOWN":
        data = data[::-1]
    return np.ascontiguousarray(data)
