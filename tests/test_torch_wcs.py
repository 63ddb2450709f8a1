"""The port's WCS (``siril_tpu_torch/ops/wcs.py``) and its FITS boundary
against the JAX package on the CPU, on the same inputs made from a seed
with numpy.

Tolerances, each with its reason:
- pix2world / world2pix equal to the JAX package's within 1e-12° and
  1e-9 px (the same float64 numpy expressions; the bound only allows for
  a different BLAS in ``np.linalg.inv``), and each round trip within
  1e-10° of where it started (TAN and its inverse, SIP by five
  fixed-point steps when there are no AP/BP terms);
- ``to_cards`` equal card for card, parse / format equal;
- a WCS written to FITS and read back by either package equal to the one
  written: ``_format_card`` prints floats with 15 significant digits, so
  the values within 1e-14 relative; plain and Rice-compressed files alike;
- a read WCS leaves no card in ``Keywords.extra`` (the JAX package keeps
  them there and writes them twice).
"""

import dataclasses

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io import fits_io as jfio
from siril_tpu.ops import wcs as jw
from siril_tpu_torch import convert
from siril_tpu_torch.core.image import USHORT_IMG, SirilImage
from siril_tpu_torch.io import fits_io as tfio
from siril_tpu_torch.ops import wcs as tw


def _make(mod, rot=15.0, sip=False, inverse=False, h=256, w=320):
    th = np.radians(rot)
    s = 1.7 / 3600.0
    cd = np.array([[-s * np.cos(th), s * np.sin(th)],
                   [s * np.sin(th), s * np.cos(th)]])
    out = mod.WCS(crpix=(w / 2 + 0.5, h / 2 + 0.5), crval=(83.8, -5.4),
                  cd=cd, height=h)
    if sip:
        A = np.zeros((4, 4))
        B = np.zeros((4, 4))
        A[2, 0], A[0, 2], A[1, 2] = 2e-6, -1.5e-6, 3e-9
        B[1, 1], B[2, 0], B[0, 3] = 1e-6, 2.5e-6, -2e-9
        out.sip_a, out.sip_b = A, B
        if inverse:
            out.sip_ap, out.sip_bp = -A, -B
    return out


CASES = [dict(), dict(rot=-37.0), dict(sip=True), dict(sip=True,
                                                       inverse=True)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_projection_vs_jax(case):
    rng = np.random.default_rng(70 + case)
    a, b = _make(jw, **CASES[case]), _make(tw, **CASES[case])
    x = rng.uniform(-20, 340, 200)
    y = rng.uniform(-20, 276, 200)
    ra_j, dec_j = a.pix2world(x, y)
    ra_t, dec_t = b.pix2world(x, y)
    np.testing.assert_allclose(ra_t, ra_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-12)
    xj, yj = a.world2pix(ra_j, dec_j)
    xt, yt = b.world2pix(ra_t, dec_t)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-9)
    ra2, dec2 = b.pix2world(xt, yt)
    if not CASES[case].get("inverse"):
        # AP/BP = −A/−B only approximate the inverse; the others invert
        np.testing.assert_allclose(ra2, ra_t, rtol=0, atol=1e-10)
        np.testing.assert_allclose(dec2, dec_t, rtol=0, atol=1e-10)
    assert b.pixel_scale_arcsec == a.pixel_scale_arcsec
    assert b.rotation_deg == a.rotation_deg
    sa, sb = a.shifted(12.5, -7.0), b.shifted(12.5, -7.0)
    assert sb.crpix == sa.crpix
    np.testing.assert_array_equal(sb.pix2world(x, y), sa.pix2world(x, y))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_cards_and_header_vs_jax(case):
    a, b = _make(jw, **CASES[case]), _make(tw, **CASES[case])
    assert b.to_cards() == a.to_cards()
    hdr_j = jfio.Header(list(a.to_cards()) + [("NAXIS2", 256, "")])
    hdr_t = tfio.Header(list(b.to_cards()) + [("NAXIS2", 256, "")])
    wj, wt = jw.WCS.from_header(hdr_j), tw.WCS.from_header(hdr_t)
    for f in dataclasses.fields(wt):
        vj, vt = getattr(wj, f.name), getattr(wt, f.name)
        if vj is None:
            assert vt is None
        else:
            np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    # a CDELT / CROTA2 header, and one that is not celestial
    old = [("CTYPE1", "RA---TAN", ""), ("CTYPE2", "DEC--TAN", ""),
           ("CRPIX1", 10.0, ""), ("CRPIX2", 12.0, ""),
           ("CRVAL1", 10.0, ""), ("CRVAL2", 20.0, ""),
           ("CDELT1", -2e-4, ""), ("CDELT2", 2e-4, ""),
           ("CROTA2", 12.0, "")]
    np.testing.assert_array_equal(
        tw.WCS.from_header(tfio.Header(old)).cd,
        jw.WCS.from_header(jfio.Header(old)).cd)
    assert tw.WCS.from_header(tfio.Header([("CTYPE1", "LINEAR", "")])) \
        is None


SEXAGESIMAL = ["12:34:56.7", "12h34m56s", "83.8", "00:00:00", "23:59:59.999"]
DECS = ["-05:23:28", "+41:16:07.5", "-0:30:00", "12d30'15\"", "-45.5"]
DEGREES = [0.0, 83.8221, 180.0, 359.9999999, 360.0, -15.0, 359.9, 10.68471]


def test_parse_format_vs_jax():
    for s in SEXAGESIMAL:
        assert tw.parse_ra(s) == jw.parse_ra(s)
    for s in DECS:
        assert tw.parse_dec(s) == jw.parse_dec(s)
    for d in DEGREES:
        assert tw.format_ra(d) == jw.format_ra(d)
        assert tw.format_dec(d - 180.0) == jw.format_dec(d - 180.0)
        assert tw.format_dec(d / 4.0) == jw.format_dec(d / 4.0)


def _same_wcs(got, want):
    assert got is not None
    assert got.height == want.height
    np.testing.assert_allclose(got.crpix, want.crpix, rtol=1e-14)
    np.testing.assert_allclose(got.crval, want.crval, rtol=1e-14)
    np.testing.assert_allclose(got.cd, want.cd, rtol=1e-14)
    for k in ("sip_a", "sip_b", "sip_ap", "sip_bp"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)


@pytest.mark.parametrize("compression", [None, "rice"])
@pytest.mark.parametrize("case", [0, 3])
def test_wcs_through_fits_vs_jax(tmp_path, compression, case):
    """A solved image written by either package and read by both: the
    same WCS; the port keeps the WCS cards out of ``Keywords.extra``."""
    rng = np.random.default_rng(80 + case)
    data = rng.random((1, 256, 320), dtype=np.float32)
    timg = SirilImage(data=data, orig_bitdepth=USHORT_IMG)
    timg.wcs = _make(tw, **CASES[case])
    timg.keywords.extra["OBJCTRA"] = "05 35 17"
    jimg = JImage(data=data, orig_bitdepth=USHORT_IMG)
    jimg.wcs = _make(jw, **CASES[case])
    jimg.keywords.extra["OBJCTRA"] = "05 35 17"
    pt, pj = str(tmp_path / "t.fit"), str(tmp_path / "j.fit")
    tfio.write_fits(timg, pt, compression=compression)
    jfio.write_fits(jimg, pj, compression=compression)
    if compression is None:
        assert open(pt, "rb").read() == open(pj, "rb").read()
    for p in (pt, pj):
        back_t = tfio.read_fits(p)
        back_j = jfio.read_fits(p)
        _same_wcs(back_t.wcs, timg.wcs)
        _same_wcs(back_j.wcs, jimg.wcs)
        np.testing.assert_array_equal(back_t.host(), back_j.host())
        extra = back_t.keywords.extra
        assert extra["OBJCTRA"] == "05 35 17"
        assert not any(k.startswith(tfio._WCS_KEYS_PREFIX) for k in extra)
    # read and written again by the port: each WCS card once
    tfio.write_fits(tfio.read_fits(pt), str(tmp_path / "again.fit"))
    hdr = tfio.image_hdus(str(tmp_path / "again.fit"))[0].header
    keys = [k for k, _, _ in hdr.cards]
    assert keys.count("CRPIX1") == keys.count("CTYPE1") == 1
    _same_wcs(tfio.read_fits(str(tmp_path / "again.fit")).wcs, timg.wcs)


def test_image_copy_and_convert_carry_wcs():
    """A copy shares the WCS, as the JAX package's does; ``convert``
    carries a JAX image's WCS into the port."""
    img = SirilImage(data=np.zeros((1, 4, 4), np.float32))
    img.wcs = _make(tw, sip=True)
    assert img.copy().wcs is img.wcs
    jimg = JImage(data=np.zeros((1, 4, 4), np.float32))
    jimg.wcs = _make(jw, sip=True)
    got = convert.siril_image(dataclasses.asdict(jimg))
    _same_wcs(got.wcs, jimg.wcs)
    assert convert.siril_image(dataclasses.asdict(img)).wcs.crval == \
        img.wcs.crval
