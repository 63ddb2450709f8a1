"""Parity: the port's demosaics (``siril_tpu_torch/ops/demosaic.py``,
``ops/rcd.py``, ``ops/demosaic_ext.py``, ``ops/xtrans.py``) against
``siril_tpu.ops.demosaic.debayer`` on the same CFA frames, on the CPU.

The frames are a smooth coloured sky with stars and noise, mosaiced with
each pattern at its offsets, made from a numpy seed: 64 × 64 for Bayer,
72 × 72 for X-Trans.  Whole frames are compared, borders included, since
the three shift rules (VNG's and RCD's opposite wrap-arounds, the
extended methods' edge clamp) differ only there.

Tolerance, every method: max |Δ| ≤ 1e-6 on the whole frame.  Both
packages compute in float32 with the same operations in the same order;
XLA:CPU contracts some multiply-adds (RCD's blend ``vh·gH + (1 − vh)·gV``
among them) and sums its convolutions in its own order, so values differ
by a few ulps (measured: at most 1.2e-7).  No hard decision (VNG's
threshold, AHD's ballot, the H/V choices of DCB and HPHD) flipped on
these frames, so no pixel is exempt.
"""

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import demosaic as jd
from siril_tpu.ops import xtrans as jx
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.ops import demosaic as td
from siril_tpu_torch.ops import xtrans as tx

torch.set_num_threads(1)

ATOL = 1e-6

#: each pattern with odd offsets: (x, y)
OFFSETS = {"RGGB": (1, 0), "BGGR": (0, 1), "GBRG": (1, 1), "GRBG": (1, 0)}


def _scene(seed: int, h: int, w: int) -> np.ndarray:
    """(3, h, w) float32: a coloured sky gradient, 12 coloured stars and
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    sky = 0.1 + 0.05 * np.sin(xx / 7.0)[None] + \
        0.03 * np.cos(yy / 5.0)[None] * np.array([1.0, 0.8, 0.6])[:, None,
                                                                  None]
    img = np.broadcast_to(sky, (3, h, w)).copy()
    for _ in range(12):
        x, y = rng.uniform(4, w - 4), rng.uniform(4, h - 4)
        col = rng.uniform(0.3, 1.0, 3)
        img += 0.5 * col[:, None, None] * np.exp(
            -((xx - x) ** 2 + (yy - y) ** 2) / 3.0)
    img += rng.normal(0, 0.01, img.shape)
    return img.astype(np.float32)


def _mosaic(rgb: np.ndarray, pattern: str, xoff: int, yoff: int):
    p = np.array(list(jd.effective_pattern(pattern, xoff, yoff))
                 ).reshape(2, 2)
    cfa = np.zeros(rgb.shape[1:], np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            cfa[dy::2, dx::2] = rgb["RGB".index(p[dy, dx]), dy::2, dx::2]
    return np.clip(cfa, 0.0, 1.0)


@pytest.mark.parametrize("pattern", jd.BAYER_PATTERNS)
@pytest.mark.parametrize("method", [m for m in jd.METHOD_NAMES
                                    if m != "xtrans"])
def test_debayer_vs_jax(method, pattern):
    mid = td.METHOD_NAMES[method]
    assert mid == jd.METHOD_NAMES[method]
    xo, yo = OFFSETS[pattern]
    cfa = _mosaic(_scene(3, 64, 64), pattern, xo, yo)
    want = np.asarray(jd.debayer(cfa, pattern, mid, xo, yo))
    got = td.debayer(torch.from_numpy(cfa), pattern, mid, xo, yo).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("phase", [0, 1])
def test_xtrans_vs_jax(phase):
    """Two standard phases with offsets; a 36-character pattern takes the
    X-Trans method whatever method is asked for."""
    pat = jx.XTRANS_PATTERNS[phase]
    assert tx.XTRANS_PATTERNS == jx.XTRANS_PATTERNS
    xo, yo = (0, 0) if phase == 0 else (1, 3)
    np.testing.assert_array_equal(tx.compile_xtrans_pattern(pat, xo, yo),
                                  jx.compile_xtrans_pattern(pat, xo, yo))
    np.testing.assert_array_equal(
        tx.compile_xtrans_pattern(pat, xo, yo, True, 4),
        jx.compile_xtrans_pattern(pat, xo, yo, True, 4))
    cfa = np.clip(_scene(5 + phase, 72, 72)[1], 0.0, 1.0)
    want = np.asarray(jd.debayer(cfa, pat, jd.BAYER_VNG, xo, yo))
    got = td.debayer(torch.from_numpy(cfa), pat, td.BAYER_VNG, xo,
                     yo).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    img = SirilImage(data=cfa[None].copy())
    img.keywords.bayer_pattern = pat
    img.keywords.bayer_xoffset, img.keywords.bayer_yoffset = xo, yo
    out = tx.demosaic_xtrans_image(img, device="cpu")
    np.testing.assert_array_equal(out.data, got)
    assert out.keywords.bayer_pattern == ""
    assert out.history[-1] == "X-Trans debayer applied"


def test_effective_pattern_vs_jax():
    for pat in jd.BAYER_PATTERNS:
        for xo in range(4):
            for yo in range(4):
                got = td.effective_pattern(pat.lower(), xo, yo,
                                           top_down=False, height=7)
                assert got == jd.effective_pattern(pat, xo, yo)
    with pytest.raises(ValueError, match="Bayer pattern"):
        td.effective_pattern("RGBG")


def test_debayer_image_vs_jax():
    """The default method (RCD), the keywords and the history line; a
    16-bit image stays 16-bit; an image without a pattern is returned as
    it is."""
    cfa = _mosaic(_scene(7, 64, 64), "GRBG", 1, 1)
    jimg = JImage(data=cfa[None].copy(), orig_bitdepth=20)
    jimg.keywords.bayer_pattern = "GRBG"
    jimg.keywords.bayer_xoffset = jimg.keywords.bayer_yoffset = 1
    img = SirilImage(data=cfa[None].copy(), orig_bitdepth=20)
    img.keywords.bayer_pattern = "GRBG"
    img.keywords.bayer_xoffset = img.keywords.bayer_yoffset = 1
    assert img.is_cfa()
    want = jd.debayer_image(jimg)
    got = td.debayer_image(img, device="cpu")
    np.testing.assert_allclose(got.data, want.host(), rtol=0, atol=ATOL)
    assert got.nchans == 3 and got.orig_bitdepth == 20
    assert got.keywords.bayer_pattern == want.keywords.bayer_pattern == ""
    assert got.history[-1] == want.history[-1] == "Debayer applied"
    assert img.keywords.bayer_pattern == "GRBG"        # not changed
    mono = SirilImage(data=cfa[None].copy())
    assert td.debayer_image(mono, device="cpu") is mono


def test_super_pixel_half_size():
    """Super-pixel halves the frame (an odd row or column is dropped)."""
    cfa = np.clip(_scene(9, 65, 63)[0], 0.0, 1.0)
    want = np.asarray(jd.debayer(cfa, "BGGR", jd.BAYER_SUPER_PIXEL))
    got = td.debayer(torch.from_numpy(cfa), "BGGR",
                     td.BAYER_SUPER_PIXEL).numpy()
    assert got.shape == want.shape == (3, 32, 31)
    np.testing.assert_array_equal(got, want)
