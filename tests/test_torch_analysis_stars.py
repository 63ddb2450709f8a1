"""The port's analysis session, part 2: streaks (``ops/streaks``), star
resynthesis and suppression (``ops/synthstar``, ``ssr``), the inspector
tools (``ops/inspector``), sequence photometry and light curves
(``ops/photometry``), ICC profiles (``ops/icc_file``, ``ops/icc``, the FITS
``ICCProfile`` extension), and chip_smoke.ANALYSIS_SCRIPT as a whole,
against the JAX package on the CPU on the same seeded inputs.

Bounds: the Hough accumulator equal and the tracks equal, endpoints and
votes; synthstar and ssr painted from the JAX package's star list within
1e-6 (overlapping boxes included); tilt's figures, the inspector mosaic
and fix_xtrans equal, the profiles within 1e-6; seqpsf's positions
within 0.02 px and its magnitudes within 1e-3 (the two LM fitters agree
to ~1e-4 px on these stars, and a magnitude moves with the aperture's
FWHM); the ICC bytes equal, each package parsing the other's files, the
conversions within 1e-6.  The session: the corrected frames, the
statistics file, the histogram, the trail, the AAVSO rows, find_hot's
list and the cosme'd dark, the profile and the ICC file equal or within
1e-6, the sequence forms within one 16-bit step; the light curve within
its reported error where both packages' fits held (a follow of five
stars over eight frames at 256² takes another LM path here and there).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu_torch.core.image import SirilImage as TImage

torch.set_num_threads(1)

CPU = "cpu"


def star_scene(seed=2, size=160, nstars=22, pairs=4, noise=0.005):
    """Gaussian stars (σ 1.5) on a sky of 0.1, ``pairs`` of them 6 px
    apart so that their boxes overlap."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = 0.1 + noise * rng.standard_normal((size, size))
    pos = [tuple(rng.uniform(12, size - 12, 2)) for _ in range(nstars)]
    pos += [(x + 6.0, y + 2.0) for x, y in pos[:pairs]]
    for x0, y0 in pos:
        img += rng.uniform(0.15, 0.7) * np.exp(
            -((xx + 0.5 - x0) ** 2 + (yy + 0.5 - y0) ** 2) / 4.5)
    return np.clip(img, 0, 1).astype(np.float32)


def trail_scene(size=192, trail=True):
    img = star_scene(5, size, 15, 0)
    if trail:
        t = np.linspace(0, 1, 700)
        img[np.round(20 + 160 * t).astype(int),
            np.round(10 + 170 * t).astype(int)] += 0.3
    return np.clip(img, 0, 1)


def test_hough_accumulator_vs_jax():
    import math

    from siril_tpu_torch.ops.streaks import hough_accumulator

    img = trail_scene()
    ys, xs = np.nonzero(img > 0.3)
    ys, xs = ys.astype(np.float32), xs.astype(np.float32)
    h = w = img.shape[0]
    diag = int(math.ceil(math.hypot(h, w)))
    th = np.linspace(0.0, math.pi, 360, endpoint=False)
    rho = xs[:, None] * np.cos(th).astype(np.float32)[None] + \
        ys[:, None] * np.sin(th).astype(np.float32)[None]
    want = np.zeros((2 * diag + 1, 360), np.int32)
    np.add.at(want, (np.round(rho).astype(np.int32).ravel() + diag,
                     np.broadcast_to(np.arange(360), rho.shape).ravel()), 1)
    got = hough_accumulator(torch.from_numpy(ys), torch.from_numpy(xs),
                            (h, w), 360)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("trail", [True, False], ids=["trail", "clean"])
def test_detect_streaks_vs_jax(trail):
    """The tracks equal, endpoints, angles and votes (the clean scene's
    stars make short chance tracks at this size, in both packages)."""
    from siril_tpu.ops.streaks import detect_streaks as jds
    from siril_tpu_torch.ops.streaks import detect_streaks as tds

    img = trail_scene(trail=trail)
    want = jds(img[None])
    got = tds(img[None], device=CPU)
    assert [vars(t) for t in got] == [vars(t) for t in want]
    if trail:
        assert len(got) >= 1 and got[0].length > 150


def _jax_stars(img):
    from siril_tpu.registration.starfinder import detect_stars

    return detect_stars(img)


@pytest.fixture
def jax_star_list(monkeypatch):
    """Both packages' star finders return the JAX package's star list of
    the layer they are given."""
    import siril_tpu.registration.starfinder as jsf
    import siril_tpu_torch.registration.starfinder as tsf

    orig = jsf.detect_stars
    monkeypatch.setattr(jsf, "detect_stars",
                        lambda lay, *a, **k: orig(np.asarray(lay)))
    monkeypatch.setattr(tsf, "detect_stars",
                        lambda lay, *a, **k: orig(lay.cpu().numpy()))


def test_synthstar_paint_vs_jax(jax_star_list):
    """Painted from the JAX package's star list (overlapping boxes, so
    more than one wave), mono and RGB."""
    from siril_tpu.ops.synthstar import resynthesize_stars as jrs
    from siril_tpu_torch.ops.synthstar import paint_waves, \
        resynthesize_stars as trs

    m = star_scene()
    stars = _jax_stars(m)
    assert len(paint_waves(stars, *m.shape)) > 1
    for data in (m[None], np.stack([m, 0.7 * m, np.clip(1.3 * m, 0, 1)])):
        want = jrs(JImage(data=data.copy())).data
        got = trs(TImage(data=data.copy()), device=CPU).data
        assert float(np.abs(got - np.asarray(want)).max()) <= 1e-6


def _both():
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.context import Session as TSession

    return JSession(cwd="."), TSession(cwd=".", device=CPU)


def _run(j, t, line):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    w = line.split()
    return JCMD[w[0]].fn(j, w[1:]), TCMD[w[0]].fn(t, w[1:])


@pytest.mark.parametrize("line", ["synthstar", "unclipstars", "ssr",
                                  "ssr 0.5"])
def test_star_commands_vs_jax(jax_star_list, line):
    """synthstar, its alias (which rebuilds every star too) and ssr through
    both tables on an RGB image, within 1e-6."""
    m = star_scene(3)
    data = np.stack([m, 0.7 * m, np.clip(1.3 * m, 0, 1)])
    j, t = _both()
    j.set_image(JImage(data=data.copy()), "i")
    t.set_image(TImage(data=data.copy()), "i")
    _run(j, t, line)
    assert float(np.abs(t.image.data - np.asarray(j.image.data)).max()) \
        <= 1e-6
    assert not np.array_equal(t.image.data, data)


def test_findstar_and_tilt_vs_jax(tmp_path, jax_star_list):
    from siril_tpu.ops.inspector import sensor_tilt as jtilt
    from siril_tpu_torch.ops.inspector import sensor_tilt as ttilt

    img = star_scene(4, 200, 40, 0)[None]
    assert vars(ttilt(TImage(data=img), device=CPU)) == \
        vars(jtilt(JImage(data=img)))
    j, t = _both()
    j.cwd = t.cwd = str(tmp_path)
    j.set_image(JImage(data=img.copy()), "i")
    t.set_image(TImage(data=img.copy()), "i")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    JCMD["findstar"].fn(j, ["-out=j/s.csv"])
    TCMD["findstar"].fn(t, ["-out=t/s.csv"])
    assert (tmp_path / "j" / "s.csv").read_text() == \
        (tmp_path / "t" / "s.csv").read_text()
    assert len(t.stars) == len(j.stars) > 10
    TCMD["clearstar"].fn(t, [])
    assert t.stars == []


def test_inspector_tools_vs_jax(tmp_path):
    """inspector and fix_xtrans equal; profile (1 and 3 px wide, every
    layer and one) and seqprofile's .dat files within 1e-6."""
    from siril_tpu.ops import inspector as ji
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops import inspector as ti

    m = star_scene(6, 180)
    rgb = np.stack([m, 0.7 * m, np.clip(1.3 * m, 0, 1)])
    for data in (m[None], rgb):
        assert np.array_equal(ti.aberration_inspector(TImage(data=data)).data,
                              ji.aberration_inspector(JImage(data=data)).data)
        assert np.array_equal(
            ti.fix_xtrans_af(TImage(data=data), device=CPU).data,
            np.asarray(ji.fix_xtrans_af(JImage(data=data)).data))
    for kw in (dict(width=3), dict(layer=0, spacing=0.7)):
        a = ti.intensity_profile(TImage(data=rgb), (3.3, 7.1),
                                 (170.2, 150.9), device=CPU, **kw)
        b = ji.intensity_profile(JImage(data=rgb), (3.3, 7.1),
                                 (170.2, 150.9), **kw)
        assert float(np.abs(a - b).max()) <= 1e-6
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        for i in range(1, 3):
            write_fits(TImage(data=np.roll(rgb, i, axis=2)),
                       str(d / f"s_{i:05d}.fit"), bitdepth=-32)
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    j = JSession(cwd=str(tmp_path / "jax"))
    t = TSession(cwd=str(tmp_path / "port"), device=CPU)
    args = ["s_", "-from=4,5", "-to=150,160"]
    JCMD["seqprofile"].fn(j, args)
    TCMD["seqprofile"].fn(t, args)
    j.set_image(JImage(data=rgb.copy()), "i")
    t.set_image(TImage(data=rgb.copy()), "i")
    args = ["-from=10,12", "-to=100,90", "-layer=1", "-width=3",
            "-filename=prof", "-savedat"]
    JCMD["profile"].fn(j, args)
    TCMD["profile"].fn(t, args)
    names = ["prof.dat"] + [f"s__profile_{i:05d}.dat" for i in range(1, 3)]
    for n in names:
        a = np.loadtxt(str(tmp_path / "port" / n))
        b = np.loadtxt(str(tmp_path / "jax" / n))
        assert float(np.abs(a - b).max()) <= 1e-6, n


def _lc_sequence(d, nframes=4):
    """A plate-solved 4-frame sequence (tests/test_astro_extras.py's
    light-curve scene), its NINA list in sky coordinates."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.wcs import WCS

    rng = np.random.default_rng(33)
    h = w = 96
    yy, xx = np.mgrid[0:h, 0:w]
    scale = 2.8e-4
    wcs = WCS(crpix=(48.0, 48.0), crval=(180.0, 10.0),
              cd=np.array([[-scale, 0.0], [0.0, scale]]), height=h)
    stars_px = [(30.0, 30.0), (60.0, 50.0), (45.0, 70.0)]
    for i in range(nframes):
        img = rng.normal(0.05, 0.002, (h, w))
        for k, (sx, sy) in enumerate(stars_px):
            a = 0.4 * (0.9 if (k == 0 and i == 2) else 1.0)
            img += a * np.exp(-(((xx + 0.5 - sx - 0.3 * i) ** 2 +
                                 (yy + 0.5 - sy + 0.2 * i) ** 2)
                                / (2 * 2.0 ** 2)))
        si = TImage(data=np.clip(img, 0, 1).astype(np.float32)[None])
        si.wcs = wcs
        si.keywords.date_obs = f"2026-08-10T0{i}:00:00"
        write_fits(si, str(d / f"lc_{i + 1:05d}.fit"), bitdepth=-32)
    with open(d / "stars.csv", "w") as f:
        f.write("Type,Name,HFR,xPos,yPos,AvgBright,MaxBright,Background,"
                "Ra,Dec\n")
        for kind, (px, py) in zip(("Target", "Comparison", "Comparison"),
                                  stars_px):
            ra, dec = wcs.pix2world(np.array([px]), np.array([py]))
            f.write(f"{kind},S,,,,,,,{float(ra[0]):.6f},"
                    f"{float(dec[0]):.6f}\n")
    return stars_px


def test_seqpsf_and_light_curve_vs_jax(tmp_path):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.ops.photometry import seq_photometry as jsp
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession
    from siril_tpu_torch.ops.photometry import seq_photometry as tsp

    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        stars = _lc_sequence(tmp_path / who)
    j = JSession(cwd=str(tmp_path / "jax"))
    t = TSession(cwd=str(tmp_path / "port"), device=CPU)
    for x, y in stars[:1]:
        want = jsp(j.load_sequence("lc_"), x + 0.7, y - 0.4)
        got = tsp(t.load_sequence("lc_"), x + 0.7, y - 0.4, device=CPU)
        assert [i for i, _ in got] == [i for i, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert abs(a["x"] - b["x"]) <= 0.02
            assert abs(a["y"] - b["y"]) <= 0.02
            assert abs(a["phot"].mag - b["phot"].mag) <= 1e-3
            assert a["date_obs"] == b["date_obs"]
    args = ["lc_", "0", "-ninastars=stars.csv", "-out=lc.dat", "-aavso",
            "-starid=T"]
    JCMD["light_curve"].fn(j, args)
    TCMD["light_curve"].fn(t, args)
    a = np.loadtxt(str(tmp_path / "port" / "lc.dat"), usecols=(0, 2, 3))
    b = np.loadtxt(str(tmp_path / "jax" / "lc.dat"), usecols=(0, 2, 3))
    assert a.shape == b.shape == (4, 3)
    assert float(np.abs(a - b).max()) <= 1e-3
    ra = [r.split(",") for r in (tmp_path / "port" / "lc_aavso.csv")
          .read_text().splitlines()]
    rb = [r.split(",") for r in (tmp_path / "jax" / "lc_aavso.csv")
          .read_text().splitlines()]
    assert len(ra) == len(rb) == 7 + 4
    for x, y in zip(ra, rb):
        if x[0].startswith("#"):
            assert x == y
        else:
            assert x[:2] == y[:2] and x[4:] == y[4:]
            assert abs(float(x[2]) - float(y[2])) <= 1.5e-3


def test_icc_files_vs_jax(tmp_path):
    """The bytes of every built-in profile and of srgb_profile equal; each
    package parses the other's files; a FITS with an ICCProfile extension
    written by either is read by the other."""
    from siril_tpu.io.fits_io import read_fits as jrf
    from siril_tpu.io.fits_io import read_icc_extension as jre
    from siril_tpu.io.fits_io import write_fits as jwf
    from siril_tpu.ops import icc as jicc
    from siril_tpu.ops import icc_file as jf
    from siril_tpu_torch.io.fits_io import read_fits as trf
    from siril_tpu_torch.io.fits_io import read_icc_extension as tre
    from siril_tpu_torch.io.fits_io import write_fits as twf
    from siril_tpu_torch.ops import icc as ticc
    from siril_tpu_torch.ops import icc_file as tf

    for key in ticc.PROFILES:
        a = tf.write_icc_bytes(ticc._builtin_icc(key))
        assert a == jf.write_icc_bytes(jicc._builtin_icc(key)), key
        pa, pb = tf.read_icc_bytes(a), jf.read_icc_bytes(a)
        assert pa.description == pb.description
        assert pa.color_space == pb.color_space
        assert (pa.matrix is None) == (pb.matrix is None)
        if pa.matrix is not None:
            assert np.array_equal(pa.matrix, pb.matrix)
    assert tf.write_icc_bytes(tf.srgb_profile()) == \
        jf.write_icc_bytes(jf.srgb_profile())
    table = tf.IccProfile(description="table", color_space="GRAY",
                          trc={"k": tf.Trc("table", table=np.linspace(
                              0, 1, 64) ** 2.2)})
    raw = tf.write_icc_bytes(table)
    assert np.array_equal(jf.read_icc_bytes(raw).trc["k"].table,
                          tf.read_icc_bytes(raw).trc["k"].table)
    data = np.random.default_rng(3).random((3, 12, 10)).astype(np.float32)
    img = TImage(data=data)
    img.icc_profile = raw
    twf(img, str(tmp_path / "t.fit"))
    assert jre(str(tmp_path / "t.fit")) == raw
    assert jrf(str(tmp_path / "t.fit")).icc_profile == raw
    jimg = JImage(data=data)
    jimg.icc_profile = raw
    jwf(jimg, str(tmp_path / "j.fit"))
    assert tre(str(tmp_path / "j.fit")) == raw
    back = trf(str(tmp_path / "j.fit"))
    assert back.icc_profile == raw
    assert (tmp_path / "t.fit").read_bytes() == \
        (tmp_path / "j.fit").read_bytes()
    assert trf(str(tmp_path / "t.fit")).copy().icc_profile == raw


ICC_LINES = ["icc_assign rec2020", "icc_convert_to rec2020",
             "icc_convert_to srgblinear", "icc_convert_to graylinear",
             "icc_convert_to rec2020linear", "icc_assign p.icc",
             "icc_convert_to p.icc", "icc_convert_to g.icc",
             "icc_remove"]


@pytest.mark.parametrize("nch", [1, 3], ids=["mono", "rgb"])
def test_icc_commands_vs_jax(tmp_path, nch):
    """icc_assign / icc_convert_to / icc_remove one after another through
    both tables (names and files: a Rec2020 profile, a grey table curve),
    within 1e-6 and the same profile bytes at each step."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession
    from siril_tpu_torch.ops import icc as ticc
    from siril_tpu_torch.ops import icc_file as tf

    tf.write_icc(ticc._builtin_icc("rec2020"), str(tmp_path / "p.icc"))
    tf.write_icc(tf.IccProfile(
        description="grey", color_space="GRAY",
        trc={"k": tf.Trc("table", table=np.linspace(0, 1, 256) ** 1.8)}),
        str(tmp_path / "g.icc"))
    data = np.random.default_rng(4).random((nch, 16, 20)).astype(np.float32)
    j = JSession(cwd=str(tmp_path))
    t = TSession(cwd=str(tmp_path), device=CPU)
    j.set_image(JImage(data=data.copy()), "i")
    t.set_image(TImage(data=data.copy()), "i")
    for line in ICC_LINES:
        w = line.split()
        JCMD[w[0]].fn(j, w[1:])
        TCMD[w[0]].fn(t, w[1:])
        d = float(np.abs(t.image.data.astype(np.float64)
                         - np.asarray(j.image.data)).max())
        assert d <= 1e-6, (line, d)
        assert t.image.icc_profile == j.image.icc_profile, line
        assert t.image.keywords.extra.get("ICCPROF") == \
            j.image.keywords.extra.get("ICCPROF"), line


@pytest.fixture(scope="module")
def session_runs(tmp_path_factory):
    """chip_smoke.ANALYSIS_SCRIPT on a 256² session (synth_analysis, 40
    stars, the first 4 lights: the trail's and the eclipse's start)
    through both packages' execute_script on copies of the same files."""
    import chip_smoke
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.cli.parser import execute_script as jexecute
    from siril_tpu_torch.cli.context import Session as TSession
    from siril_tpu_torch.cli.parser import execute_script as texecute

    root = tmp_path_factory.mktemp("analysis")
    src = root / "src"
    src.mkdir()
    size = 256
    lights = chip_smoke.ANALYSIS_LIGHTS
    chip_smoke.ANALYSIS_LIGHTS = 4
    try:
        made = chip_smoke.synth_analysis(str(src), 9, size, 40, device=CPU)
        chip_smoke.writes_done()
    finally:
        chip_smoke.ANALYSIS_LIGHTS = lights
    k = size / 4096.0
    script = chip_smoke.ANALYSIS_SCRIPT.format(
        cold=chip_smoke.COSME_COLD, hot=chip_smoke.COSME_HOT,
        tx=made["sx"][made["target"]], ty=made["sy"][made["target"]],
        crop_x=int(1024 * k), crop_y=int(1024 * k), crop_w=int(2048 * k),
        trail=chip_smoke.TRAIL_LIGHT + 1, px0=12, py0=25, px1=231, py1=206)
    dirs = {}
    for who, run in (("jax", lambda d, p: jexecute(JSession(cwd=d), p)),
                     ("port", lambda d, p: texecute(
                         TSession(cwd=d, device=CPU), p))):
        d = str(root / who)
        shutil.copytree(str(src), d)
        with open(os.path.join(d, "a.ssf"), "w") as f:
            f.write(script)
        assert run(d, os.path.join(d, "a.ssf")) == 0, who
        dirs[who] = d
    dirs["made"] = made
    return dirs


def _fits(d, name):
    from siril_tpu_torch.io.fits_io import read_fits

    return read_fits(os.path.join(d, name)).data


@pytest.mark.parametrize("name", [
    "cc_light_00001.fit", "cc_light_00003.fit", "cc_light_00004.fit",
    "seqstat.csv", "histo_0.dat", "streaks.csv", "dark/hot.lst",
    "dark/dark_cc.fit", "an_icc.fit", "an_insp.fit",
    "mtf_cc_light_00002.fit", "cropped_cc_light_00003.fit",
    "scaled_cc_light_00004.fit", "ghs_cc_light_00001.fit",
    "bkg_scaled_cc_light_00004.fit", "profile.dat", "light_curve_aavso.csv",
    "light_curve.dat"])
def test_session_vs_jax(session_runs, name):
    a = os.path.join(session_runs["port"], name)
    b = os.path.join(session_runs["jax"], name)
    if name.endswith(".fit"):
        got, want = _fits(session_runs["port"], name), \
            _fits(session_runs["jax"], name)
        # the sequence forms agree within 1e-6 before their 16-bit write:
        # one step, which reads back as up to 1.0005 / 65535 in float32
        tol = 0.0 if name.startswith(("cc_", "dark", "an_")) else \
            1.5 / 65535
        assert float(np.abs(got - want).max()) <= tol
        if name == "an_icc.fit":
            from siril_tpu_torch.io.fits_io import read_icc_extension

            assert read_icc_extension(a) == read_icc_extension(b)
    elif name == "profile.dat":
        assert float(np.abs(np.loadtxt(a) - np.loadtxt(b)).max()) <= 1e-6
    elif name == "light_curve.dat":
        # a follow of five stars over eight frames: where the two LM fitters
        # take another path on a patch, the magnitudes part by up to the
        # reported error; the JAX package's fit can also fail outright
        # (an error near 0.2 mag), and such a frame is left out
        x = np.loadtxt(a, usecols=(0, 2, 3))
        y = np.loadtxt(b, usecols=(0, 2, 3))
        assert x.shape == y.shape
        ok = (x[:, 2] < 0.05) & (y[:, 2] < 0.05)
        assert ok.sum() >= len(ok) - 1
        assert np.all(np.abs(x[ok, 1] - y[ok, 1]) <= x[ok, 2])
    elif name == "light_curve_aavso.csv":
        ra = [r.split(",") for r in open(a).read().splitlines()]
        rb = [r.split(",") for r in open(b).read().splitlines()]
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert x[:2] == y[:2] and x[4:] == y[4:]
    else:
        assert open(a).read() == open(b).read()
    assert not os.path.exists(os.path.join(session_runs["port"],
                                           "nostreak.csv"))


def test_seq_photometry_stars_equal_one_by_one(tmp_path):
    """The light curve's stars fitted together, frame by frame, give each
    star the results it gets alone (the fitter's rows are independent)."""
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.ops.photometry import (
        seq_photometry,
        seq_photometry_stars,
    )

    stars = _lc_sequence(tmp_path)
    seq = Session(cwd=str(tmp_path), device=CPU).load_sequence("lc_")
    xys = [(x + 0.4, y - 0.3) for x, y in stars]
    together = seq_photometry_stars(seq, xys, device=CPU)
    for xy, got in zip(xys, together):
        alone = seq_photometry(seq, *xy, device=CPU)
        assert [i for i, _ in got] == [i for i, _ in alone]
        for (_, a), (_, b) in zip(got, alone):
            assert (a["x"], a["y"], a["fwhm"], a["phot"].mag) == \
                (b["x"], b["y"], b["fwhm"], b["phot"].mag)
