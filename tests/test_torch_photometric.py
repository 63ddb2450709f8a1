"""The port's photometry and photometric colour calibration against the
JAX package on the CPU: ``ops/photometry.measure_star``,
``astrometry/pcc.py`` (pcc, bgneutralize), ``astrometry/spcc.py``,
``astrometry/xp_spectra.py``, the XP kinds of ``astrometry/gaia_local.py``,
``astrometry/compstars.py`` and the ``catmag`` / ``findcompstars`` /
``spcc_list`` / ``setphot`` commands, on seeded plate-solved RGB fields.

Tolerances: everything that is host numpy in both packages — the
photometry results, the XP design matrices and spectra, the catalogue
files and their decoded records, the white-balance gains K, the
comparison-star lists — bit-equal; ``catmag``'s offset, 1e-6 mag (it
measures the stars that each package's star finder fits); the PCC / SPCC /
bgneutralize images, one float32 rounding (1.2e-7; the port applies
data·K + offset in float64 on the device as numpy does, and is bit-equal
here).
"""

import numpy as np
import pytest

from siril_tpu.astrometry import compstars as jcs
from siril_tpu.astrometry import gaia_local as jgl
from siril_tpu.astrometry import pcc as jpcc
from siril_tpu.astrometry import spcc as jspcc
from siril_tpu.astrometry import xp_spectra as jxs
from siril_tpu.astrometry.catalog import Catalog as JCat
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import photometry as jph
from siril_tpu.ops.wcs import WCS as JWCS
from siril_tpu_torch.astrometry import compstars as tcs
from siril_tpu_torch.astrometry import gaia_local as tgl
from siril_tpu_torch.astrometry import pcc as tpcc
from siril_tpu_torch.astrometry import spcc as tspcc
from siril_tpu_torch.astrometry import xp_spectra as txs
from siril_tpu_torch.astrometry.catalog import Catalog as TCat
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import photometry as tph
from siril_tpu_torch.ops.wcs import WCS as TWCS

CPU = "cpu"
IMBALANCE = np.array([1.5, 1.0, 0.7])


def _wcs(cls, size, ra=120.0, dec=30.0, scale=3.0):
    s = scale / 3600.0
    return cls(crpix=(size / 2.0, size / 2.0), crval=(ra, dec),
               cd=np.array([[-s, 0.0], [0.0, s]]), height=size)


def _spectra(rng, n):
    """Flat SEDs with red / blue slopes (W·m⁻²·nm⁻¹)."""
    slope = rng.uniform(-0.5, 0.5, n)
    lam = (jspcc.WL - 650.0) / 350.0
    return np.clip(1e-16 * (1.0 + slope[:, None] * lam[None, :]), 1e-18,
                   None)


def _render(size, x, y, colours, rng, sky=0.001, noise=0.0):
    data = np.full((3, size, size), sky, np.float32)
    if noise:
        data += rng.normal(0, noise, data.shape).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for k in range(len(x)):
        g = np.exp(-0.5 * (((xx - x[k]) ** 2 + (yy - y[k]) ** 2) / 4.0))
        for c in range(3):
            data[c] += (colours[c, k] * g).astype(np.float32)
    return np.clip(data, 0, 1)


@pytest.fixture(scope="module")
def spcc_field(tmp_path_factory):
    """A 200² field of 24 stars whose spectra are in an xp_sampled .cat,
    imbalanced by IMBALANCE (tests/test_xp_spectra.py's field)."""
    tmp = tmp_path_factory.mktemp("spcc")
    rng = np.random.default_rng(61)
    size, n = 200, 24
    x, y = rng.uniform(25, size - 25, n), rng.uniform(25, size - 25, n)
    w = _wcs(JWCS, size)
    ra, dec = w.pix2world(x, y)
    flux = _spectra(rng, n)
    lib = jspcc.ResponseLibrary()
    qe = lib.get("generic_qe").resampled()
    resp = [lib.get(f).resampled() * qe for f in ("R", "G", "B")]
    photon = flux * jspcc.WL[None, :]
    photon = photon / photon[:, 82:83]
    true = np.stack([np.trapezoid(photon * r, jspcc.WL, axis=1)
                     for r in resp])
    colours = 0.02 * true / true[1].mean() * IMBALANCE[:, None]
    data = _render(size, x, y, colours, rng)
    p = str(tmp / "xp.cat")
    jgl.write_gaia_xpsamp(p, ra, dec, np.full(n, 10.0), flux)
    return dict(data=data, path=p, ra=ra, dec=dec, flux=flux, x=x, y=y,
                size=size)


def _images(data, size, *sky):
    j, t = JImage(data=data.copy()), TImage(data=data.copy())
    j.wcs, t.wcs = _wcs(JWCS, size, *sky), _wcs(TWCS, size, *sky)
    return j, t


def test_measure_star_bit_equal():
    rng = np.random.default_rng(3)
    layer = (0.1 + rng.normal(0, 0.01, (96, 96))).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:96]
    layer += (0.4 * np.exp(-((xx - 47.3) ** 2 + (yy - 50.6) ** 2)
                           / 5.0)).astype(np.float32)
    for cfg in ({}, dict(inner=8.0, outer=12.0, force_radius=True,
                         aperture=5.0)):
        for x0, y0, fwhm in ((47.3, 50.6, 3.0), (47.0, 50.0, 12.0),
                             (2.0, 3.0, 3.0), (-1.0, 5.0, 3.0)):
            a = tph.measure_star(layer, x0, y0, fwhm, tph.PhotConfig(**cfg))
            b = jph.measure_star(layer, x0, y0, fwhm, jph.PhotConfig(**cfg))
            assert vars(a) == vars(b)
    d = rng.normal(0, 1, 500)
    d[:5] = 40
    assert tph.robust_mean(d) == jph.robust_mean(d)


def test_xp_design_and_spectra_bit_equal(tmp_path):
    a, b = txs.synthetic_design(), jxs.synthetic_design()
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert np.array_equal(txs.hermite_functions(9, np.linspace(-3, 3, 50)),
                          jxs.hermite_functions(9, np.linspace(-3, 3, 50)))
    rng = np.random.default_rng(5)
    bp = rng.normal(0, 1, (6, 55)).astype(np.float32)
    rp = rng.normal(0, 1, (6, 55)).astype(np.float32)
    hints = np.array([3, 0, 12, 55, 7, 1])
    for trunc in (0, txs.XPCTS_USE_HINT, 5):
        f1 = txs.xpcts_to_xpsampled(bp, rp, a, trunc, hints, hints)
        f2 = jxs.xpcts_to_xpsampled(bp, rp, b, trunc, hints, hints)
        assert np.array_equal(f1, f2)
        assert np.array_equal(txs.flux_to_relcount(f1),
                              jxs.flux_to_relcount(f2))
    # a baked .npz through SIRIL_TPU_XP_DESIGN's loader
    np.savez(tmp_path / "d.npz", **a)
    got = txs.load_design(str(tmp_path / "d.npz"))
    assert all(np.array_equal(got[k], a[k]) for k in a)


@pytest.mark.parametrize("kind", ["xpsamp", "xpcts"])
def test_xp_catalogues_across_packages(tmp_path, kind):
    """Each package's writer gives the same bytes, each reader the same
    cone (xp_continuous through the synthetic design)."""
    rng = np.random.default_rng(7)
    n = 40
    ra = 120.0 + rng.uniform(-0.5, 0.5, n)
    dec = 30.0 + rng.uniform(-0.5, 0.5, n)
    mag = rng.uniform(8, 14, n)
    if kind == "xpsamp":
        flux = _spectra(rng, n)
        for mod, name in ((tgl, "t"), (jgl, "j")):
            mod.write_gaia_xpsamp(str(tmp_path / f"{name}.cat"), ra, dec,
                                  mag, flux, level=6)
        design = None
    else:
        bp = rng.normal(0, 1e-16, (n, 12))
        rp = rng.normal(0, 1e-16, (n, 12))
        hints = rng.integers(0, 13, n)
        for mod, name in ((tgl, "t"), (jgl, "j")):
            mod.write_gaia_xpcts(str(tmp_path / f"{name}.cat"), ra, dec, mag,
                                 bp, rp, level=6, bp_n_relevant=hints,
                                 rp_n_relevant=hints)
        design = jxs.synthetic_design()
    assert (tmp_path / "t.cat").read_bytes() == \
        (tmp_path / "j.cat").read_bytes()
    a = tgl.GaiaXPLocalCatalogue(str(tmp_path / "t.cat"), design=design)
    b = jgl.GaiaXPLocalCatalogue(str(tmp_path / "t.cat"), design=design)
    for q in ((120.0, 30.0, 0.4, 13.0), (120.2, 29.9, 1.0, 99.0)):
        ca, cb = a.cone_search(*q), b.cone_search(*q)
        assert len(ca) == len(cb) > 0
        for f in ("ra", "dec", "mag", "pmra", "pmdec", "xp_sampled"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f)), f
    if kind == "xpcts":
        with pytest.raises(ValueError, match="SIRIL_TPU_XP_DESIGN"):
            tgl.GaiaXPLocalCatalogue(str(tmp_path / "t.cat")).cone_search(
                120.0, 30.0, 0.4)


def test_spcc_vs_jax_xpsamp(spcc_field):
    f = spcc_field
    j, t = _images(f["data"], f["size"])
    cj = jgl.GaiaXPLocalCatalogue(f["path"])
    ct = tgl.GaiaXPLocalCatalogue(f["path"])
    a = tspcc.spcc(t, ct, mag_limit=20.0, device=CPU)
    b = jspcc.spcc(j, cj, mag_limit=20.0)
    assert a.history[-1] == b.history[-1]
    assert float(np.max(np.abs(a.data - b.data))) <= 1.2e-7
    # the gains undo the imbalance (8 %, tests/test_xp_spectra.py:229)
    gains = []
    for c in (0, 2):
        rr = []
        for k in range(len(f["x"])):
            xi, yi = int(round(f["x"][k])), int(round(f["y"][k]))
            pin = f["data"][c, yi, xi] - 0.001
            if pin > 0.005:
                rr.append((a.data[c, yi, xi] - np.median(a.data[c])) / pin)
        gains.append(np.median(rr))
    np.testing.assert_allclose(gains, 1.0 / IMBALANCE[[0, 2]], rtol=0.08)


def test_spcc_xpcts_synthetic_design(tmp_path):
    """spcc on an xp_continuous catalogue through synthetic_design, both
    packages; and with the narrowband filters and the atmosphere."""
    rng = np.random.default_rng(67)
    size, n = 160, 20
    x, y = rng.uniform(25, size - 25, n), rng.uniform(25, size - 25, n)
    w = _wcs(JWCS, size)
    ra, dec = w.pix2world(x, y)
    design = jxs.synthetic_design()
    # coefficients whose spectra fit flat SEDs with slopes (least squares
    # through both bands' merged designs)
    A = np.concatenate([design["bp_design"][:12] * design["bp_merge"],
                        design["rp_design"][:12] * design["rp_merge"]]).T
    coef = np.linalg.lstsq(A, _spectra(rng, n).T, rcond=None)[0].T
    bp, rp = coef[:, :12], coef[:, 12:]
    colours = 0.05 * rng.uniform(0.5, 1.0, (3, n)) * IMBALANCE[:, None]
    data = _render(size, x, y, colours, rng)
    p = str(tmp_path / "xpcts.cat")
    jgl.write_gaia_xpcts(p, ra, dec, np.full(n, 10.0), bp, rp)
    j, t = _images(data, size)
    cj = jgl.GaiaXPLocalCatalogue(p, design=design)
    ct = tgl.GaiaXPLocalCatalogue(p, design=txs.synthetic_design())
    for kw in ({}, dict(atmosphere=jspcc.atmospheric_transmission(1000.0))):
        a = tspcc.spcc(t, ct, mag_limit=20.0, device=CPU, **kw)
        b = jspcc.spcc(j, cj, mag_limit=20.0, **kw)
        assert a is not None and b is not None
        assert a.history[-1] == b.history[-1]
        assert float(np.max(np.abs(a.data - b.data))) <= 1.2e-7
    assert np.array_equal(np.stack(tspcc.narrowband_filters()),
                          np.stack(jspcc.narrowband_filters()))
    assert tspcc.ResponseLibrary().names() == jspcc.ResponseLibrary().names()


BV_SKY = (120.0, 35.0, 2.0)


def _bv_field(seed=71, size=256):
    """Stars coloured by bv_to_rgb(B−V) × IMBALANCE
    (tests/test_astro_extras.py's PCC field)."""
    rng = np.random.default_rng(seed)
    w = _wcs(JWCS, size, *BV_SKY)
    n = 250
    ra = 120.0 + rng.uniform(-0.1, 0.1, n)
    dec = 35.0 + rng.uniform(-0.1, 0.1, n)
    mag = rng.uniform(7, 11, n)
    bv = rng.uniform(0.0, 1.2, n)
    x, y = w.world2pix(ra, dec)
    keep = (x > 16) & (x < size - 16) & (y > 16) & (y < size - 16)
    amp = np.minimum(10 ** (-0.4 * (mag - 11.0)) * 0.1, 0.6)
    keep &= amp >= 0.02
    rgb = np.stack([jpcc.bv_to_rgb(b) for b in bv], axis=1)
    colours = amp[None, :] * rgb * IMBALANCE[:, None]
    colours[:, ~keep] = 0.0
    data = _render(size, x, y, colours, rng, sky=0.05, noise=0.002)
    return data, dict(ra=ra, dec=dec, mag=mag, bv=bv), size


def test_pcc_bgneutralize_vs_jax():
    data, cat, size = _bv_field()
    j, t = _images(data, size, *BV_SKY)
    a = tpcc.photometric_color_calibration(t, TCat(**cat), mag_limit=12.0,
                                           device=CPU)
    b = jpcc.photometric_color_calibration(j, JCat(**cat), mag_limit=12.0)
    assert a.history[-1] == b.history[-1]
    assert float(np.max(np.abs(a.data - b.data))) <= 1.2e-7
    k = [float(v) for v in a.history[-1].split("K=[")[1].rstrip("])")
         .split()]
    np.testing.assert_allclose(k, 1.0 / IMBALANCE, rtol=0.08)
    a2 = tpcc.background_neutralization(a, device=CPU)
    b2 = jpcc.background_neutralization(b)
    assert float(np.max(np.abs(a2.data - b2.data))) <= 1.2e-7
    for bv in (-0.3, 0.0, 0.65, 1.4, 2.5):
        assert tpcc.bv_to_temp(bv) == jpcc.bv_to_temp(bv)
        assert np.array_equal(tpcc.bv_to_rgb(bv), jpcc.bv_to_rgb(bv))


def test_compstars_vs_jax(tmp_path):
    rng = np.random.default_rng(73)
    n = 120
    cat = dict(ra=120.0 + rng.uniform(-0.08, 0.08, n),
               dec=35.0 + rng.uniform(-0.08, 0.08, n),
               mag=rng.uniform(8, 14, n), bv=rng.uniform(0.0, 1.5, n))
    j = JImage(data=np.zeros((1, 256, 256), np.float32))
    t = TImage(data=np.zeros((1, 256, 256), np.float32))
    j.wcs = _wcs(JWCS, 256, 120.0, 35.0, 2.0)
    t.wcs = _wcs(TWCS, 256, 120.0, 35.0, 2.0)
    x, y = j.wcs.world2pix(cat["ra"], cat["dec"])
    ti = int(np.nonzero((x > 30) & (x < 220) & (y > 30) & (y < 220))[0][0])
    for args in (dict(delta_vmag=2.0, delta_bv=0.6),
                 dict(narrow_fov=False)):
        a = tcs.find_comp_stars(t, TCat(**cat), (x[ti], y[ti]),
                                tcs.CompStarArgs(**args))
        b = jcs.find_comp_stars(j, JCat(**cat), (x[ti], y[ti]),
                                jcs.CompStarArgs(**args))
        assert a == b
    tcs.export_nina_csv(*a, str(tmp_path / "t.csv"))
    jcs.export_nina_csv(*b, str(tmp_path / "j.csv"))
    tcs.export_compstars_list(*a, str(tmp_path / "t.lst"))
    jcs.export_compstars_list(*b, str(tmp_path / "j.lst"))
    for e in ("csv", "lst"):
        assert (tmp_path / f"t.{e}").read_bytes() == \
            (tmp_path / f"j.{e}").read_bytes()


def test_photometric_commands_vs_jax(tmp_path, monkeypatch, spcc_field):
    """pcc, bgneutralize, spcc (its catalogue picked by the type byte),
    spcc_list, findcompstars, setphot and catmag through both command
    tables."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    data, cat, size = _bv_field(79)
    TCat(**cat).save(str(tmp_path / "bv.npz"))
    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)

    def both(*words):
        rj = JCMD[words[0]].fn(js, list(words[1:]))
        rt = TCMD[words[0]].fn(ts, list(words[1:]))
        return rt, rj

    def same(tol=0.0):
        d = float(np.max(np.abs(ts.image.data - np.asarray(js.image.data))))
        assert d <= tol, d

    j, t = _images(data, size, *BV_SKY)
    js.set_image(j, "f")
    ts.set_image(t, "f")
    both("pcc", "-catalog=bv.npz", "-limitmag=12")
    same(1.2e-7)
    both("bgneutralize")
    same(1.2e-7)
    x, y = j.wcs.world2pix(cat["ra"], cat["dec"])
    k = int(np.argmin((x - 128) ** 2 + (y - 128) ** 2))
    both("findcompstars", f"{x[k]:.2f}", f"{y[k]:.2f}", "-catalog=bv.npz",
         "-out=cs", "-dvmag=4")
    for e in ("lst", "csv"):
        assert (tmp_path / f"cs.{e}").exists()
    monkeypatch.setenv("SIRIL_TPU_CATALOG", str(tmp_path / "bv.npz"))
    both("setphot", "-inner=8", "-outer=12", "-aperture=5",
         "-force_radius=1")
    rt, _ = both("catmag")
    # the stars come from each package's star finder, whose fitted centres
    # agree to ~1e-7 px: the offsets to 1e-6 mag
    assert ts.magnitude_offset == rt
    assert abs(rt - js.magnitude_offset) <= 1e-6
    f = spcc_field
    j, t = _images(f["data"], f["size"])
    js.set_image(j, "s")
    ts.set_image(t, "s")
    both("spcc", f"-catalog={f['path']}", "-limitmag=20")
    same(1.2e-7)
    names, _ = both("spcc_list", "filters")
    assert names == jspcc.ResponseLibrary().names()


@pytest.fixture(scope="module")
def post_runs(tmp_path_factory):
    """chip_smoke's post-stack sessions (POST_SCRIPT on the SPCC field,
    PCC_SCRIPT on the PCC field; chip_smoke.synth_post at 256²) through
    both packages' execute_script on copies of the same files.  The JAX
    package's CSV reader drops the bv column (ROADMAP §3), so its pcc reads
    the same catalogue from post_bv.npz."""
    import os
    import shutil

    import chip_smoke
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.cli.parser import execute_script as jexecute
    from siril_tpu_torch.cli.context import Session as TSession
    from siril_tpu_torch.cli.parser import execute_script as texecute

    root = tmp_path_factory.mktemp("post")
    src = root / "src"
    src.mkdir()
    made = chip_smoke.synth_post(str(src), 97, 256, 60)
    chip_smoke.writes_done()
    dirs = {}
    for who, run, catalog in (
            ("jax", lambda d, p: jexecute(JSession(cwd=d), p), "post_bv.npz"),
            ("port", lambda d, p: texecute(TSession(cwd=d, device=CPU), p),
             "post_bv.csv")):
        d = str(root / who)
        shutil.copytree(str(src), d)
        with open(os.path.join(d, "post.ssf"), "w") as f:
            f.write(made["script"])
        with open(os.path.join(d, "pcc.ssf"), "w") as f:
            f.write(chip_smoke.PCC_SCRIPT.format(catalog=catalog))
        for script in ("post.ssf", "pcc.ssf"):
            assert run(d, os.path.join(d, script)) == 0, (who, script)
        dirs[who] = d
    return dirs


@pytest.mark.parametrize("name,tol", [
    ("post_sky", 1e-5), ("post_cal", 1e-5), ("pcc_sky", 1e-5),
    ("pcc_cal", 1e-5), ("pcc_final", 1e-5), ("post_final", 1e-4)])
def test_post_scripts_vs_jax(post_runs, name, tol):
    """The saved FITS of both packages' post-stack sessions: subsky and
    the calibrations within subsky's 1e-5; the stretched, turned and
    binned result within 1e-4 (autostretch's MTF, about ×5 at the sky,
    and the GHT and asinh after it, scale those 1e-5)."""
    import os

    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu_torch.io.fits_io import read_fits as tread

    a = tread(os.path.join(post_runs["port"], name + ".fit"))
    b = jread(os.path.join(post_runs["jax"], name + ".fit"))
    assert a.data.shape == b.data.shape
    err = float(np.max(np.abs(a.data - b.data)))
    assert err <= tol, err
    assert a.wcs is not None and b.wcs is not None
    shift = (0.0, 0.0)
    if name == "post_final":
        # eqcrop's corner and crop's 8 px move CRPIX in the port; the JAX
        # package writes the loaded file's CRPIX cards before the moved
        # ones, and its reader takes the first (ROADMAP §3)
        import chip_smoke

        w = chip_smoke.sky_wcs(256)
        b0 = chip_smoke.EQCROP_BOX
        ra, dec = w.pix2world(np.array([b0[0], b0[2]]) * 256,
                              np.array([b0[1], b0[3]]) * 256)
        xs, ys = w.world2pix(ra, dec)
        dx = int(np.floor(min(xs))) + 8
        dy = int(np.floor(min(ys))) + 8
        shift = (-dx, dy)
    np.testing.assert_allclose(np.asarray(a.wcs.crpix),
                               np.asarray(b.wcs.crpix) + shift, rtol=0,
                               atol=1e-9)
