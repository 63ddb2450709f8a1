"""The port's astrometry (``siril_tpu_torch/astrometry/``) and its commands
against the JAX package on the CPU, on the same inputs made from a seed
with numpy.

Tolerances, each with its reason:
- HEALPix NESTED and HTM ids, cone searches, catalogue files: equal (the
  same numpy code on the same float64 inputs; a ``.cat`` or KStars file
  written by one package reads the same in the other, and both write the
  same bytes);
- the remote catalogues: the same URLs byte for byte, the same parsed
  catalogue, the fixture transport and the offline gate as
  ``tests/test_remote_catalogues.py:50-110`` (nothing is fetched: the live
  transport refuses while the session is offline);
- ``solve_image`` fed the JAX package's star list: the same matched
  count, CRVAL within 1e-9° and CD within 1e-9 relative (the same float64
  host code; only BLAS may differ); each package detecting its own
  stars: the same matched count, CRVAL within 1e-6° and CD within 1e-6
  relative (the LM fits' float32 star positions differ by ≤ 0.02 px,
  tests/test_torch_registration.py);
- the commands through both packages' sessions: the same solutions
  (as above), the same stars in the field, the same annotations,
  HEALPix pixels and trixels.
"""

import os

import numpy as np
import pytest

from siril_tpu.astrometry import catalog as jcat
from siril_tpu.astrometry import gaia_local as jgaia
from siril_tpu.astrometry import healpix as jhp
from siril_tpu.astrometry import kstars_local as jks
from siril_tpu.astrometry import remote as jrc
from siril_tpu.astrometry import solver as jsolver
from siril_tpu.cli.commands import COMMANDS as JCOMMANDS
from siril_tpu.cli.context import Session as JSession
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops.wcs import WCS as JWCS
from siril_tpu_torch import cli
from siril_tpu_torch.astrometry import catalog as tcat
from siril_tpu_torch.astrometry import gaia_local as tgaia
from siril_tpu_torch.astrometry import healpix as thp
from siril_tpu_torch.astrometry import kstars_local as tks
from siril_tpu_torch.astrometry import remote as trc
from siril_tpu_torch.astrometry import solver as tsolver
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.ops.wcs import WCS

cmd = cli.commands


def _sky(rng, n=3000):
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    ra[:60] = 180.0 + rng.normal(0, 0.3, 60)
    dec[:60] = 10.0 + rng.normal(0, 0.3, 60)
    return ra, dec, rng.uniform(5, 16, n)


def _same_catalog(a, b):
    assert len(a) == len(b)
    for k in ("ra", "dec", "mag", "bv", "pmra", "pmdec"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_healpix_htm_and_cone_search_vs_jax():
    rng = np.random.default_rng(90)
    ra, dec, mag = _sky(rng)
    ra = np.r_[ra, 0.0, 359.999999, 90.0, 45.0]
    dec = np.r_[dec, 90.0, -90.0, 0.0, 41.8103149]     # poles, cap edge
    mag = np.r_[mag, 5.0, 5.0, 5.0, 5.0]
    for nside in (1, 8, 256):
        np.testing.assert_array_equal(thp.ang2pix_nest(nside, ra, dec),
                                      jhp.ang2pix_nest(nside, ra, dec))
    for level in (0, 3, 5):
        np.testing.assert_array_equal(thp.radec_to_htm(ra, dec, level),
                                      jhp.radec_to_htm(ra, dec, level))
    np.testing.assert_array_equal(thp.nest_parent(np.arange(500), 8, 1),
                                  jhp.nest_parent(np.arange(500), 8, 1))
    a = tcat.Catalog(ra=ra, dec=dec, mag=mag)
    b = jcat.Catalog(ra=ra, dec=dec, mag=mag)
    for ra0, dec0, r, m in ((180.0, 10.0, 1.0, 13.0), (359.9, 5.0, 2.0, 99),
                            (30.0, 89.5, 3.0, 12.0)):
        _same_catalog(a.cone_search(ra0, dec0, r, m),
                      b.cone_search(ra0, dec0, r, m))
    _same_catalog(a.brightest(20), b.brightest(20))
    w = WCS(crpix=(64.5, 48.5), crval=(180.0, 10.0),
            cd=np.array([[-2e-3, 0], [0, 2e-3]]), height=96)
    jw = JWCS(crpix=w.crpix, crval=w.crval, cd=w.cd, height=96)
    np.testing.assert_array_equal(a.project(w), b.project(jw))
    np.testing.assert_array_equal(
        thp.image_footprint_pixels(w, 128, 96, 256),
        jhp.image_footprint_pixels(jw, 128, 96, 256))
    np.testing.assert_array_equal(
        thp.image_footprint_trixels(w, 128, 96, 5),
        jhp.image_footprint_trixels(jw, 128, 96, 5))


def test_catalogue_files_across_packages(tmp_path):
    """npz / CSV, the binary Gaia catalogue and the KStars catalogue,
    each written by one package and read by the other; the astrometric
    reader refuses the XP kinds of the Gaia format in both packages (their
    reader is ``GaiaXPLocalCatalogue``, tests/test_torch_photometric.py)."""
    rng = np.random.default_rng(91)
    ra, dec, mag = _sky(rng)
    bmag = mag + rng.uniform(-0.2, 1.2, len(mag))
    # .npz and CSV
    jcat.Catalog(ra=ra, dec=dec, mag=mag, bv=bmag - mag).save(
        str(tmp_path / "j.npz"))
    tcat.Catalog(ra=ra, dec=dec, mag=mag, bv=bmag - mag).save(
        str(tmp_path / "t.npz"))
    for p in ("j.npz", "t.npz"):
        _same_catalog(tcat.Catalog.load(str(tmp_path / p)),
                      jcat.Catalog.load(str(tmp_path / p)))
    with open(tmp_path / "c.csv", "w") as f:
        f.write("ra,dec,mag\n")
        for row in zip(ra[:50], dec[:50], mag[:50]):
            f.write("%.9f,%.9f,%.3f\n" % row)
    _same_catalog(tcat.Catalog.load(str(tmp_path / "c.csv")),
                  jcat.Catalog.load(str(tmp_path / "c.csv")))
    # the binary Gaia (HEALPix) catalogue
    pm = rng.normal(0, 20, len(ra))
    tgaia.write_gaia_astro(str(tmp_path / "t.cat"), ra, dec, mag, level=6,
                           pmra=pm)
    jgaia.write_gaia_astro(str(tmp_path / "j.cat"), ra, dec, mag, level=6,
                           pmra=pm)
    assert (tmp_path / "t.cat").read_bytes() == \
        (tmp_path / "j.cat").read_bytes()
    for p in ("t.cat", "j.cat"):
        a = tgaia.GaiaLocalCatalogue(str(tmp_path / p))
        b = jgaia.GaiaLocalCatalogue(str(tmp_path / p))
        assert (a.level, a.n_healpixels, a.title) == (b.level,
                                                      b.n_healpixels,
                                                      b.title)
        for q in ((180.0, 10.0, 1.0, 13.0), (10.0, -60.0, 5.0, 99.0)):
            got, want = a.cone_search(*q), b.cone_search(*q)
            _same_catalog(got, want)
        assert len(a.cone_search(180.0, 10.0, 1.0, 13.0)) >= 25
    jgaia.write_gaia_xpsamp(str(tmp_path / "xp.cat"), ra[:5], dec[:5],
                            mag[:5], np.ones((5, 343)) * 1e-17)
    for reader in (tgaia.GaiaLocalCatalogue, jgaia.GaiaLocalCatalogue):
        with pytest.raises(ValueError, match="unsupported catalogue type"):
            reader(str(tmp_path / "xp.cat"))
    # KStars (HTM)
    tks.write_kstars_catalogue(str(tmp_path / "t_tycho.dat"), ra, dec, mag,
                               bmag=bmag, level=3)
    jks.write_kstars_catalogue(str(tmp_path / "j_tycho.dat"), ra, dec, mag,
                               bmag=bmag, level=3)
    assert (tmp_path / "t_tycho.dat").read_bytes() == \
        (tmp_path / "j_tycho.dat").read_bytes()
    a = tks.KStarsCatalogue(str(tmp_path / "j_tycho.dat"))
    b = jks.KStarsCatalogue(str(tmp_path / "t_tycho.dat"))
    assert (a.level, a.ntrixels, a.nfields) == (b.level, b.ntrixels,
                                                b.nfields) == (3, 512, 6)
    _same_catalog(a.cone_search(180.0, 10.0, 1.5, 11.0),
                  b.cone_search(180.0, 10.0, 1.5, 11.0))


TAP_CSV = """ra,dec,pmra,pmdec,mag,bmag
120.001,-45.002,1.5,-2.5,10.1,10.8
120.050,-45.100,,,11.0,11.9
bad,row,,,,
120.200,-45.300,0.1,0.2,12.2,
"""

SESAME_TEXT = """\
C.D.S.  -  SESAME
Object M 31  ---  G  ---  OID=@1575544

Coordinates(ICRS,ep=J2000,eq=2000): 00 42 44.330 +41 16 07.50
"""


def test_remote_catalogues_vs_jax(tmp_path):
    """URLs, parsing, the fixture transport and the offline gate."""
    for args in (("tycho2", 120.5, -45.25, 30.0, 12.5),
                 ("simbad", 10.0, 20.0, 60.0), ("gaiadr3", 0.1, -0.2, 5.0),
                 ("vsx", 300.0, 45.0, 12.0, 14.0)):
        assert trc.conesearch_url(*args) == jrc.conesearch_url(*args)
    assert trc.object_search_url("HD 12345") == \
        jrc.object_search_url("HD 12345")
    assert trc.TAP_CATALOGUES.keys() == jrc.TAP_CATALOGUES.keys()
    _same_catalog(trc.parse_tap_csv(TAP_CSV, "tycho2"),
                  jrc.parse_tap_csv(TAP_CSV, "tycho2"))
    assert trc.parse_sesame(SESAME_TEXT) == jrc.parse_sesame(SESAME_TEXT)
    assert trc.parse_sesame("nothing") is None
    # fixtures recorded by one package serve the other
    jt = jrc.FixtureTransport(str(tmp_path / "fx"))
    tt = trc.FixtureTransport(str(tmp_path / "fx"))
    url = trc.conesearch_url("tycho2", 120.1, -45.1, 0.5 * 60.0, 0.0)
    with pytest.raises(trc.TransportError):
        tt.get(url)
    jt.record(url, TAP_CSV)
    assert tt.path(url) == jt.path(url) and tt.get(url) == TAP_CSV
    cone = trc.RemoteCatalogue("tycho2", transport=tt).cone_search(
        120.1, -45.1, 0.5)
    _same_catalog(cone, jrc.RemoteCatalogue("tycho2", transport=jt)
                  .cone_search(120.1, -45.1, 0.5))
    with pytest.raises(ValueError, match="unknown remote"):
        trc.RemoteCatalogue("nosuch")
    # the live transport refuses while offline; nothing is fetched
    with pytest.raises(trc.TransportError, match="offline"):
        trc.UrllibTransport().get("https://example.invalid/query")
    with pytest.raises(trc.TransportError, match="offline"):
        trc.RemoteCatalogue("nomad").transport.get(
            "https://example.invalid/query")
    assert isinstance(trc.default_transport(), trc.UrllibTransport)
    assert not trc.default_transport().online


def test_catsearch_and_conesearch_commands_with_fixtures(tmp_path,
                                                         monkeypatch):
    """catsearch (local annotations, then SIMBAD fixtures) and a remote
    conesearch through both packages' sessions; online / offline."""
    from siril_tpu.cli.parser import process_command_line

    fx = str(tmp_path / "fixtures")
    jrc.FixtureTransport(fx).record(jrc.object_search_url("HD 12345"),
                                    SESAME_TEXT)
    monkeypatch.setenv("SIRIL_TPU_CAT_FIXTURES", fx)
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "offline"])
    hit = cmd.cmd_catsearch(ts, ["HD", "12345"])
    want = jrc.parse_sesame(SESAME_TEXT)
    assert hit == want
    assert process_command_line(JSession(cwd=str(tmp_path)),
                                "catsearch HD 12345") == 0
    m42 = cmd.cmd_catsearch(ts, ["M42"])
    assert m42[:2] == (83.8221, -5.3911)
    with pytest.raises(cli.CommandError, match="not found"):
        cmd.cmd_catsearch(ts, ["no", "such", "thing"])
    cmd.cmd_online(ts, [])
    assert ts.online
    cmd.cmd_offline(ts, [])
    assert not ts.online
    # conesearch against the remote catalogue's recorded reply
    img = SirilImage(data=np.full((1, 64, 64), 0.2, np.float32))
    img.wcs = WCS(crpix=(32.0, 32.0), crval=(120.1, -45.1),
                  cd=np.eye(2) * (30.0 / 3600.0), height=64)
    ts.set_image(img, "x")
    ra_c, dec_c = img.wcs.pix2world(np.array([32.0]), np.array([32.0]))
    fov = img.wcs.pixel_scale_arcsec * 64 / 3600.0
    url = jrc.conesearch_url("tycho2", float(ra_c[0]), float(dec_c[0]),
                             fov / 1.5 * 60.0, 13.0)
    jrc.FixtureTransport(fx).record(url, TAP_CSV)
    n = cmd.cmd_conesearch(ts, ["13", "-catalog=tycho2", "-out=cone.csv"])
    js = JSession(cwd=str(tmp_path))
    jimg = JImage(data=img.data)
    jimg.wcs = JWCS(crpix=(32.0, 32.0), crval=(120.1, -45.1),
                    cd=np.eye(2) * (30.0 / 3600.0), height=64)
    js.set_image(jimg)
    JCOMMANDS["conesearch"].fn(js, ["13", "-catalog=tycho2",
                                    "-out=jcone.csv"])
    assert (tmp_path / "cone.csv").read_text() == \
        (tmp_path / "jcone.csv").read_text()
    assert n == len((tmp_path / "cone.csv").read_text().splitlines()) - 1


def _field(rng, h, w, n, scale_as=2.0, rot=12.0, ra0=150.0, dec0=40.0):
    """A star field rendered through a known TAN WCS and its catalogue
    (the catalogue reaches past the frame).  The star finder puts a
    pixel's centre at +0.5 and the solver fits its positions as they
    are, so a star at x renders centred on pixel x − 0.5."""
    th = np.radians(rot)
    s = scale_as / 3600.0
    true = JWCS(crpix=(w / 2 + 0.5, h / 2 + 0.5), crval=(ra0, dec0),
                cd=np.array([[-s * np.cos(th), s * np.sin(th)],
                             [s * np.sin(th), s * np.cos(th)]]), height=h)
    ox = rng.uniform(-0.3 * w, 1.3 * w, n)
    oy = rng.uniform(-0.3 * h, 1.3 * h, n)
    ra, dec = true.pix2world(ox, oy)
    mag = rng.uniform(7, 12, n)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.05 + rng.normal(0, 0.002, (h, w))
    for x0, y0, m in zip(ox, oy, mag):
        if -5 < x0 < w + 5 and -5 < y0 < h + 5:
            img += min(0.6 * 10 ** (-0.4 * (m - 7.0)), 0.8) * np.exp(
                -((xx + 0.5 - x0) ** 2 + (yy + 0.5 - y0) ** 2)
                / (2 * 1.5 ** 2))
    return true, np.asarray(ra), np.asarray(dec), mag, \
        np.clip(img, 0, 1).astype(np.float32)


def _solve_both(img, ra, dec, mag, args, inject):
    """Solve with both packages; ``inject`` feeds the port the JAX
    package's star list."""
    import jax.numpy as jnp

    from siril_tpu.registration import starfinder as jsf
    from siril_tpu_torch.registration import starfinder as tsf

    jres = jsolver.solve_image(JImage(data=img[None]),
                               jcat.Catalog(ra=ra, dec=dec, mag=mag),
                               jsolver.SolveArgs(**args))
    real = tsf.detect_stars
    if inject:
        jstars = jsf.detect_stars(jnp.asarray(img), jsf.StarFinderParams(),
                                  max_stars=400)
        tsf.detect_stars = lambda *a, **k: jstars
    try:
        stages = {}
        timg = SirilImage(data=img[None])
        tres = tsolver.solve_image(timg, tcat.Catalog(ra=ra, dec=dec,
                                                      mag=mag),
                                   tsolver.SolveArgs(**args), device="cpu",
                                   stages=stages)
    finally:
        tsf.detect_stars = real
    assert {"detect", "match"} <= set(stages)
    assert timg.wcs is tres.wcs
    return jres, tres


@pytest.mark.parametrize("inject", [True, False])
def test_solve_image_vs_jax(inject):
    """A 512² field solved from hints 0.2° off: the port's solution equal
    to the JAX package's (see the tolerances above)."""
    rng = np.random.default_rng(92)
    true, ra, dec, mag, img = _field(rng, 512, 512, 700)
    args = dict(ra=150.2, dec=39.85, pixel_scale=2.05, mag_limit=13.0)
    jres, tres = _solve_both(img, ra, dec, mag, args, inject)
    assert jres is not None and tres is not None
    assert tres.n_matched == jres.n_matched >= 20
    tol = 1e-9 if inject else 1e-6
    np.testing.assert_allclose(tres.wcs.crval, jres.wcs.crval, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tres.wcs.cd, jres.wcs.cd, rtol=0,
                               atol=tol * np.abs(jres.wcs.cd).max())
    assert tres.wcs.crpix == jres.wcs.crpix
    # and both found the truth
    c = tres.wcs.pix2world(np.array([255.5]), np.array([255.5]))
    t = true.pix2world(np.array([255.5]), np.array([255.5]))
    assert abs(c[0][0] - t[0][0]) * 3600 < 1.0
    assert abs(c[1][0] - t[1][0]) * 3600 < 1.0
    # a field that is not in the catalogue
    assert tsolver.solve_image(
        SirilImage(data=img[None]),
        tcat.Catalog(ra=ra + 40.0, dec=dec, mag=mag),
        tsolver.SolveArgs(**args), device="cpu") is None


def test_fit_wcs_and_scale_vs_jax():
    rng = np.random.default_rng(93)
    true, ra, dec, mag, _ = _field(rng, 8, 8, 60)
    w = JWCS(crpix=true.crpix, crval=true.crval, cd=true.cd, height=256)
    x = rng.uniform(10, 240, 40)
    y = rng.uniform(10, 240, 40)
    r, d = w.pix2world(x, y)
    pix, sky = np.stack([x, y], 1), np.stack([r, d], 1)
    for order in (0, 3):
        a, ra_ = tsolver.fit_wcs(pix, sky, (256, 256), order)
        b, rb = jsolver.fit_wcs(pix, sky, (256, 256), order)
        assert ra_ == pytest.approx(rb, rel=1e-9, abs=1e-12)
        np.testing.assert_allclose(a.cd, b.cd, rtol=1e-12)
        np.testing.assert_allclose(a.crval, b.crval, rtol=1e-13)
        if order:
            np.testing.assert_allclose(a.sip_a, b.sip_a, rtol=1e-9,
                                       atol=1e-15)
    assert tsolver.scale_from_optics(800, 3.76) == \
        jsolver.scale_from_optics(800, 3.76)


def _solved_session_pair(tmp_path):
    """One field written as FITS with the hint in its header; both
    packages' sessions with it loaded; the catalogue as a Gaia ``.cat``
    and a KStars file."""
    from siril_tpu_torch.io.fits_io import write_fits

    rng = np.random.default_rng(94)
    true, ra, dec, mag, img = _field(rng, 384, 384, 500, scale_as=1.0,
                                     rot=0.4, ra0=83.8, dec0=-5.4)
    tgaia.write_gaia_astro(str(tmp_path / "field.cat"), ra, dec, mag)
    tks.write_kstars_catalogue(str(tmp_path / "field_tycho.dat"), ra, dec,
                               mag)
    im = SirilImage(data=img[None])
    im.keywords.extra.update(OBJCTRA="05:35:40", OBJCTDEC="-05:27:00")
    im.keywords.focal_length = 800.0
    im.keywords.pixel_size_x = 1.0 * 800.0 / 206.265
    write_fits(im, str(tmp_path / "field.fit"), bitdepth=-32)
    js = JSession(cwd=str(tmp_path))
    JCOMMANDS["load"].fn(js, ["field.fit"])
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "load",
                  "field.fit"])
    return true, js, ts


@pytest.mark.parametrize("catalog", ["field.cat", "field_tycho.dat"])
def test_platesolve_and_field_commands_vs_jax(tmp_path, catalog):
    """platesolve (hint from the header) then conesearch, show, disto,
    healpix and trixel through both packages' sessions."""
    true, js, ts = _solved_session_pair(tmp_path)
    JCOMMANDS["platesolve"].fn(js, [f"-catalog={catalog}"])
    cmd.cmd_platesolve(ts, [f"-catalog={catalog}"])
    jw, tw = js.image.wcs, ts.image.wcs
    np.testing.assert_allclose(tw.crval, jw.crval, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.cd, jw.cd, rtol=0,
                               atol=1e-6 * np.abs(jw.cd).max())
    assert {"detect", "match"} <= set(ts.stages)
    c = tw.pix2world(np.array([191.5]), np.array([191.5]))
    t = true.pix2world(np.array([191.5]), np.array([191.5]))
    assert abs(c[0][0] - t[0][0]) * 3600 < 0.5
    # already solved: nothing happens without -force
    cmd.cmd_platesolve(ts, [f"-catalog={catalog}"])
    assert ts.image.wcs is tw
    cmd.cmd_platesolve(ts, [f"-catalog={catalog}", "-force"])
    assert ts.image.wcs is not tw
    # the field commands on the JAX package's solution, in both
    ts.image.wcs = WCS(crpix=jw.crpix, crval=jw.crval, cd=jw.cd,
                       height=jw.height)
    n = cmd.cmd_conesearch(ts, ["12", f"-catalog={catalog}", "-out=t.csv"])
    JCOMMANDS["conesearch"].fn(js, ["12", f"-catalog={catalog}",
                                    "-out=j.csv"])
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert n > 20
    np.testing.assert_array_equal(cmd.cmd_healpix(ts, []),
                                  JCOMMANDS["healpix"].fn(js, []))
    np.testing.assert_array_equal(cmd.cmd_trixel(ts, []),
                                  JCOMMANDS["trixel"].fn(js, []))
    from siril_tpu.astrometry.annotations import annotate_image

    anns = cmd.cmd_show(ts, [])
    want = annotate_image(js.image)
    assert [(a.name, a.x, a.y) for a in anns] == \
        [(a.name, a.x, a.y) for a in want]
    assert [a.name for a in anns] == ["M42"]
    (one,) = cmd.cmd_show(ts, ["M42"])
    assert (one.x, one.y) == (anns[0].x, anns[0].y)
    assert cmd.cmd_disto(ts, []) is None


def test_seqplatesolve_and_disto_vs_jax(tmp_path):
    """seqplatesolve writes each frame's WCS into its file (each solved
    centre seeding the next), as the JAX package's does; ``platesolve
    -order=3`` and ``disto`` on the SIP solution (evaluated in
    ``pix2world``'s frame)."""
    from siril_tpu.ops.wcs import _sip_eval
    from siril_tpu_torch.io.fits_io import read_fits, write_fits

    rng = np.random.default_rng(95)
    true, ra, dec, mag, img = _field(rng, 256, 384, 700, scale_as=1.5)
    tgaia.write_gaia_astro(str(tmp_path / "f.cat"), ra, dec, mag)
    for k, (x0, y0) in enumerate([(0, 0), (128, 0), (0, 96)]):
        for d in ("j", "t"):
            os.makedirs(tmp_path / d, exist_ok=True)
            write_fits(SirilImage(data=img[None, y0:y0 + 160,
                                           x0:x0 + 256].copy()),
                       str(tmp_path / d / f"s_{k + 1:05d}.fit"),
                       bitdepth=-32)
    os.replace(tmp_path / "f.cat", tmp_path / "j" / "f.cat")
    os.link(tmp_path / "j" / "f.cat", tmp_path / "t" / "f.cat")
    solve = ["s_", "150.01", "40.0", "-catalog=f.cat", "-focal=1000",
             f"-pixelsize={1.5 * 1000 / 206.265}"]
    JCOMMANDS["seqplatesolve"].fn(JSession(cwd=str(tmp_path / "j")), solve)
    ts = cli.run(["-d", str(tmp_path / "t"), "--device", "cpu",
                  "seqplatesolve", *solve])
    assert {"detect", "match", "write"} <= set(ts.stages)
    for k in range(3):
        a = read_fits(str(tmp_path / "t" / f"s_{k + 1:05d}.fit"))
        b = read_fits(str(tmp_path / "j" / f"s_{k + 1:05d}.fit"))
        assert a.wcs is not None and b.wcs is not None
        np.testing.assert_allclose(a.wcs.crval, b.wcs.crval, rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(a.host(), b.host())
    # disto: the amplitude of a SIP solution on the 9 × 9 grid
    ts = cli.run(["-d", str(tmp_path / "t"), "--device", "cpu", "load",
                  "s_00001.fit"])
    cmd.cmd_platesolve(ts, ["-catalog=f.cat", "-order=3", "-force",
                            *solve[3:]])
    w = ts.image.wcs
    assert w.sip_a is not None and w.sip_a.shape == (4, 4)
    mx, mean = cmd.cmd_disto(ts, [])
    gx, gy = np.meshgrid(np.linspace(0, 255, 9), np.linspace(0, 159, 9))
    u = gx + 1.0 - w.crpix[0]
    v = (159 - gy) + 1.0 - w.crpix[1]
    amp = np.hypot(_sip_eval(w.sip_a, u, v), _sip_eval(w.sip_b, u, v))
    assert (mx, mean) == (float(amp.max()), float(amp.mean()))
    assert cmd.cmd_disto(ts, ["clear"]) is None


def test_mosaic_route_vs_jax(tmp_path):
    """The astrometric mosaic route at 512² tiles through both packages'
    commands: ``seqplatesolve mosaic_`` (header hints ~8′ off; each
    solved centre seeds the next tile), ``seqapplyreg mosaic_
    -framing=max`` (no registration data: the homographies from the WCS
    solutions, each tile warped onto the canvas) and ``stack r_mosaic_
    rej 3 3 -norm=addscale -overlap_norm -feather=16`` on the warped
    canvas.  Each package's H within 1 px of the known corner offset at
    the tiles' corners (15-30 faint matched stars a tile at this size:
    measured ≤ 0.49 px) and the port's within 0.05 px of the JAX
    package's (measured ≤ 0.002: LM fits differ in float32); the canvases
    the same size; the stacks within 1e-3 on average of each other (noise
    0.01).  Denser fields at this size let the JAX package's solver (and
    so the port's) accept false matches: its checks are ≥ 6 pairs within
    4 px and the residual."""
    import chip_smoke as cs
    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.ops.wcs import format_dec, format_ra

    size, overlap = 512, 128
    step, full = size - overlap, 2 * size - overlap
    rng = np.random.default_rng(41)
    sx, sy, amp = cs._star_field(rng, full, int(250 * (full / size) ** 2))
    stars = cs._render(full, 0.0, sx, sy, amp)
    s = 1.0 / 3600
    canvas = WCS(crpix=(full / 2 + 0.5, full / 2 + 0.5), crval=(83.8, -5.4),
                 cd=np.array([[-s, 0.0], [0.0, s]]), height=full)
    ra, dec = canvas.pix2world(sx, sy)
    corners = [(0, 0), (step, 0), (0, step), (step, step)]
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
        tgaia.write_gaia_astro(str(tmp_path / d / "sky.cat"), ra, dec,
                               10.0 - 2.5 * np.log10(amp / 0.55))
    for k, ((x0, y0), (level, gain)) in enumerate(zip(corners,
                                                      cs.MOSAIC_LEVELS)):
        f = level + gain * stars[y0:y0 + size, x0:x0 + size] + \
            0.01 * rng.standard_normal((size, size), dtype=np.float32)
        w = canvas.shifted(-x0, step - y0)
        w.height = size
        c = w.pix2world(np.array([size / 2.0]), np.array([size / 2.0]))
        off = rng.uniform(-8, 8, 2) / 60.0
        cards = [f"OBJCTRA = '{format_ra(float(c[0][0]) + off[0])}'",
                 f"OBJCTDEC= '{format_dec(float(c[1][0]) + off[1])}'",
                 "FOCALLEN=                800.0",
                 f"XPIXSZ  = {800.0 / 206.265:>20}"]
        for d in ("j", "t"):
            cs.write_u16_fits(str(tmp_path / d / f"mosaic_{k + 1:05d}.fit"),
                              np.rint(np.clip(f, 0, 1) * 65535.0).astype(
                                  np.uint16), extra=cards)
    js = JSession(cwd=str(tmp_path / "j"))
    JCOMMANDS["seqplatesolve"].fn(js, ["mosaic_", "-catalog=sky.cat"])
    JCOMMANDS["seqapplyreg"].fn(js, ["mosaic_", "-framing=max"])
    JCOMMANDS["stack"].fn(js, ["r_mosaic_", "rej", "3", "3",
                               "-norm=addscale", "-overlap_norm",
                               "-feather=16", "-out=res"])
    td = str(tmp_path / "t")
    ts = cli.run(["-d", td, "--device", "cpu", "seqplatesolve", "mosaic_",
                  "-catalog=sky.cat"])
    assert ts.sequence.number == 4
    cli.run(["-d", td, "--device", "cpu", "seqapplyreg", "mosaic_",
             "-framing=max"])
    ts = cli.run(["-d", td, "--device", "cpu", "stack", "r_mosaic_", "rej",
                  "3", "3", "-norm=addscale", "-overlap_norm", "-feather=16",
                  "-out=res"])
    # the registration seqapplyreg derived, kept in the port's .seq; the
    # JAX package's from its frames' WCS, as its seqapplyreg derives it
    from siril_tpu.core.sequence import Sequence as JSeq
    from siril_tpu.registration.astrometric import register_astrometric

    jseq = JSeq.scan("mosaic_", str(tmp_path / "j"))
    assert register_astrometric(jseq) == 4
    tH = read_seqfile(os.path.join(td, "mosaic_.seq")).reg(0).H
    box = np.array([[0, 0, 1], [size, 0, 1], [0, size, 1], [size, size, 1]],
                   float)

    def at_corners(H):
        q = box @ H.T
        return q[:, :2] / q[:, 2:]

    for k, (x0, y0) in enumerate(corners):
        want = box[:, :2] + (x0, y0)
        assert np.abs(at_corners(jseq.reg(0).H[k]) - want).max() < 1.0
        assert np.abs(at_corners(tH[k]) - want).max() < 1.0
        assert np.abs(at_corners(tH[k]) -
                      at_corners(jseq.reg(0).H[k])).max() < 0.05
    a = jread(str(tmp_path / "j" / "res.fit")).host()
    b = ts.result.image.host()
    assert a.shape == b.shape == (1, full, full)
    assert float(np.abs(a - b).mean()) < 1e-3
    assert float(np.abs(b[0] - (0.10 + stars))[16:-16, 16:-16].mean()) < 0.01
