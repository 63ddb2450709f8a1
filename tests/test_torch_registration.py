"""Parity: the port's star detection (``registration/starfinder.py`` with
the batched PSF fit of ``registration/psf.py``), star matching and
transform estimation (``registration/matching.py``) and registration
(``registration/global_reg.py``) against the JAX package on the same
frames made from a seed.

Star lists are compared by nearest position, not by index
(``torch.topk`` and ``lax.top_k`` may order tied candidates differently).
Candidates and detection statistics agree exactly.  Every star brighter
than 25x the pixel noise (all the stars put in the frames) has a star of
the other list within 0.02 px: the LM fit runs 40 float32 steps in both,
with other exp/sin implementations.  Fainter entries are noise peaks
fitted by sub-pixel "stars": the LM problem is ill-conditioned there, so
the two float32 fits may land in different minima and pass or fail the
quality filters differently (recorded in ROADMAP §3 with this input); the
lists' lengths differ by those entries at most.  Matching is numpy in both
packages on those star lists: the shifts agree within 0.01 px.  On the
same star positions, the estimators (shift, similarity, affine,
homography; RANSAC with the same seed) give H within 1e-9.

The rest of registration (``registration/astrometric.py``,
``threestars.py``, the SIP warp of ``-disto``):
- ``register_astrometric`` and ``seqapplyreg`` of a plate-solved sequence
  with no registration data: H within 1e-9 of the JAX package's (the
  same float64 numpy fit on the same WCS), the warped frames within the
  gather warp's 2e-6;
- ``register -3stars`` on ``tests/test_threestars.py``'s four cases: the
  same host search in both packages, H within 1e-12;
- the SIP warp: with no SIP term bit-equal to the gather warp; with a
  master whose terms are read alike in both axis conventions (CRPIX2 =
  (H + 1)/2, A[p, q] with q even, B[p, q] with q odd) within the gather
  warp's 2e-6 of the JAX package's; ``seqapplyreg -disto=`` on
  ``tests/test_registration.py:261``'s field (radial terms, CRPIX2 one
  pixel off that centre, so the two conventions differ by B[1, 1]·u
  there) straightens the same stars, within 0.02 px of the JAX package's
  in x and B[1, 1]·|u| + 0.02 px in y;
- the SIP axis convention (ROADMAP §3): ``platesolve -order=3`` then
  ``seqapplyreg -disto=`` through both packages on a 256² field with a
  distortion that has terms no convention flip preserves (B[2, 0],
  B[0, 2]).  The port straightens the field; the JAX package's chain
  straightens x and makes y worse than it was.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siril_tpu.registration import matching as jmatch
from siril_tpu.registration import starfinder as jsf
from siril_tpu_torch.registration import matching, starfinder

torch.set_num_threads(1)

POS_TOL = 0.02
SHIFT_TOL = 0.01


NOISE = 0.002


def _frames(rng, shifts, h=128, w=144, nstars=14):
    yy, xx = np.mgrid[0:h, 0:w]
    sx = rng.uniform(16, w - 16, nstars)
    sy = rng.uniform(16, h - 16, nstars)
    amp = rng.uniform(0.1, 0.6, nstars)
    out = []
    for dx, dy in shifts:
        f = 0.05 + rng.normal(0, NOISE, (h, w))
        for x0, y0, a in zip(sx, sy, amp):
            f += a * np.exp(-(((xx + 0.5 - x0 - dx) ** 2 +
                               (yy + 0.5 - y0 - dy) ** 2) / (2 * 1.8 ** 2)))
        out.append(np.clip(f, 0, 1))
    return np.asarray(out, np.float32)


def _detect_both(frames, p):
    n, H, W = frames.shape
    R = jsf.detection_radius(H, W, p)
    K = 64
    jpre = jsf._stats_cand_fit_fn(R, K, float(p.sigma), int(p.profile))(
        jnp.asarray(frames))
    jpre = tuple(np.asarray(a) for a in jpre)
    jstars = jsf.detect_stars_batch([jnp.asarray(frames)], p, max_stars=K,
                                    precomputed=jpre)
    tp = starfinder.StarFinderParams(**vars(p))
    tf = torch.from_numpy(frames)
    tpre = tuple(a.numpy() for a in starfinder.stats_cand_fit(
        tf, R, K, float(p.sigma), int(p.profile)))
    tstars = starfinder.detect_stars_batch([tf], tp, K, tpre)
    return jpre, tpre, jstars, tstars


def test_detection_vs_jax():
    rng = np.random.default_rng(31)
    frames = _frames(rng, [(0, 0), (3.3, -2.2), (-4.6, 1.7)])
    p = jsf.StarFinderParams(radius=6)
    jpre, tpre, jstars, tstars = _detect_both(frames, p)
    # detection statistics and candidates: the same order statistics
    np.testing.assert_allclose(tpre[0], jpre[0], rtol=1e-6)
    np.testing.assert_array_equal(tpre[1], jpre[1])
    np.testing.assert_array_equal(tpre[2], jpre[2])
    for f, (js, ts) in enumerate(zip(jstars, tstars)):
        bright = 25.0 * NOISE
        a = np.array([[s.x0, s.y0] for s in js if s.A > bright])
        b = np.array([[s.x0, s.y0] for s in ts if s.A > bright])
        assert len(a) == len(b) >= 8
        d = np.hypot(*(a[:, None, :] - b[None, :, :]).transpose(2, 0, 1))
        assert d.min(axis=1).max() < POS_TOL
        assert d.min(axis=0).max() < POS_TOL
        faint = [s for s in js + ts if s.A <= bright]
        assert abs(len(js) - len(ts)) <= len(faint)


def test_match_stars_vs_jax():
    rng = np.random.default_rng(32)
    shifts = [(0, 0), (5.4, -3.1), (-2.25, 6.8)]
    frames = _frames(rng, shifts)
    p = jsf.StarFinderParams(radius=6)
    _, _, jstars, tstars = _detect_both(frames, p)
    for k in (1, 2):
        jm = jmatch.match_stars(jstars[0], jstars[k],
                                ttype=jmatch.SHIFT_TRANSFORMATION)
        tm = matching.match_stars(tstars[0], tstars[k],
                                  ttype=matching.SHIFT_TRANSFORMATION)
        assert jm is not None and tm is not None
        np.testing.assert_allclose(tm.H, jm.H, rtol=0, atol=SHIFT_TOL)
        # frame → ref maps the frame's stars back by −shift
        np.testing.assert_allclose(tm.H[:2, 2], -np.asarray(shifts[k]),
                                   atol=0.05)
        jh = jmatch.match_stars(jstars[0], jstars[k])
        th = matching.match_stars(tstars[0], tstars[k])
        assert jh is not None and th is not None
        np.testing.assert_allclose(_corners(th.H), _corners(jh.H), rtol=0,
                                   atol=SHIFT_TOL)


def _corners(H, w=144, h=128):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1.0]]) @ H.T
    return c[:, :2] / c[:, 2:]


def _points(rng, n=40, outliers=6):
    """Frame star positions and their reference positions through a
    homography with rotation, scale and perspective, with noise and a few
    wrong pairs."""
    src = rng.uniform(10, 500, (n, 2))
    th = np.deg2rad(1.3)
    H = np.array([[1.01 * np.cos(th), -1.01 * np.sin(th), 7.5],
                  [1.01 * np.sin(th), 1.01 * np.cos(th), -4.25],
                  [3e-6, -2e-6, 1.0]])
    q = np.c_[src, np.ones(n)] @ H.T
    dst = q[:, :2] / q[:, 2:] + rng.normal(0, 0.05, (n, 2))
    dst[:outliers] += rng.uniform(20, 40, (outliers, 2))
    return src, dst


@pytest.mark.parametrize("ttype", range(4))
def test_estimators_vs_jax(ttype):
    rng = np.random.default_rng(70 + ttype)
    src, dst = _points(rng)
    np.testing.assert_allclose(
        matching.estimate_transform(src[6:], dst[6:], ttype),
        jmatch.estimate_transform(src[6:], dst[6:], ttype), rtol=0,
        atol=1e-9)
    m = jmatch._MIN_PAIRS[ttype]
    picks = rng.random((50, len(src))).argsort(axis=1)[:, :m]
    a = matching._batched_minimal_H(src, dst, picks, ttype)
    b = jmatch._batched_minimal_H(src, dst, picks, ttype)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0,
                               atol=1e-9)
    tr = matching.ransac_transform(src, dst, ttype)
    jr = jmatch.ransac_transform(src, dst, ttype)
    np.testing.assert_allclose(tr.H, jr.H, rtol=0, atol=1e-9)
    assert (tr.inliers, tr.pairs) == (jr.inliers, jr.pairs)
    assert tr.residual_px == pytest.approx(jr.residual_px, abs=1e-9)
    # the whole match from star lists (triangles, RANSAC, growing)
    perm = rng.permutation(len(src))
    tm = matching.match_stars(dst[6:], src[6:][perm[perm < 34]], ttype)
    jm = jmatch.match_stars(dst[6:], src[6:][perm[perm < 34]], ttype)
    np.testing.assert_allclose(tm.H, jm.H, rtol=0, atol=1e-9)
    assert tm.inliers == jm.inliers


def test_detect_stars_single_vs_jax():
    """One frame, the staged register's path: threshold at the STATS_BASIC
    median + σ·background noise, as the JAX package's detect_stars."""
    rng = np.random.default_rng(33)
    frame = _frames(rng, [(1.3, -0.7)])[0]
    p = jsf.StarFinderParams(radius=6)
    js = jsf.detect_stars(frame, p)
    ts = starfinder.detect_stars(torch.from_numpy(frame),
                                 starfinder.StarFinderParams(**vars(p)))
    bright = 25.0 * NOISE
    a = np.array([[s.x0, s.y0] for s in js if s.A > bright])
    b = np.array([[s.x0, s.y0] for s in ts if s.A > bright])
    assert len(a) == len(b) >= 8
    d = np.hypot(*(a[:, None, :] - b[None, :, :]).transpose(2, 0, 1))
    assert d.min(axis=1).max() < POS_TOL
    faint = [s for s in js + ts if s.A <= bright]
    assert abs(len(js) - len(ts)) <= len(faint)


def test_save_star_list_csv_vs_jax(tmp_path):
    rng = np.random.default_rng(34)
    frame = _frames(rng, [(0.0, 0.0)])[0]
    stars = starfinder.detect_stars(torch.from_numpy(frame),
                                    starfinder.StarFinderParams(radius=6))
    starfinder.save_star_list_csv(stars, str(tmp_path / "port.lst"))
    from siril_tpu.registration.psf import PSFStar

    jstars = [PSFStar(**{k: getattr(s, k) for k in (
        "x0", "y0", "fwhmx", "fwhmy", "angle", "A", "B", "rmse", "beta",
        "sx", "sy")}) for s in stars]
    jsf.save_star_list_csv(jstars, str(tmp_path / "jax.lst"))
    assert (tmp_path / "port.lst").read_text() == \
        (tmp_path / "jax.lst").read_text()


def _reg_seqs(tmp_path, rng):
    """The same 4-frame sequence for both packages, with regdata."""
    from siril_tpu.core.image import SirilImage
    from siril_tpu.core.sequence import Sequence as JSeq
    from siril_tpu.io.fits_io import write_fits
    from siril_tpu_torch.core.sequence import Sequence

    frames = _frames(rng, [(0, 0), (3.3, -2.2), (-4.6, 1.7), (2.0, 5.5)])
    for i, f in enumerate(frames):
        write_fits(SirilImage(data=f[None]), str(tmp_path / f"g_{i + 1:05d}"
                                                 ".fit"), bitdepth=16)
    return JSeq.scan("g_", str(tmp_path)), Sequence.scan("g_", str(tmp_path))


@pytest.mark.parametrize("framing", range(4))
def test_compute_framing_vs_jax(tmp_path, framing):
    from siril_tpu.registration import global_reg as jgr
    from siril_tpu_torch.registration import global_reg as tgr

    js, ts = _reg_seqs(tmp_path, np.random.default_rng(35))
    rng = np.random.default_rng(36)
    for seq in (js, ts):
        r = seq.reg(0)
        r.H[:] = np.eye(3)
        r.valid[:] = True
    Hs = np.eye(3) + rng.normal(0, 0.01, (4, 3, 3))
    Hs[:, 2] = [0, 0, 1]
    Hs[:, :2, 2] = rng.normal(0, 6, (4, 2))
    js.reg(0).H[:] = Hs
    ts.reg(0).H[:] = Hs
    a = tgr.compute_framing(ts, 0, framing, 1.5)
    b = jgr.compute_framing(js, 0, framing, 1.5)
    assert a[:2] == b[:2]
    np.testing.assert_array_equal(a[2], b[2])
    js.reg(0).number_of_stars[:] = ts.reg(0).number_of_stars[:] = \
        [30, 60, 55, 58]
    js.reg(0).fwhm[:] = ts.reg(0).fwhm[:] = [2.0, 2.6, 2.1, 2.4]
    jgr._pick_best_reference(js, 0)
    tgr._pick_best_reference(ts, 0)
    assert ts.reference_image == js.reference_image == 2
    np.testing.assert_allclose(ts.reg(0).H, js.reg(0).H, rtol=0, atol=1e-12)


@pytest.mark.parametrize("flag", ["-noout", "-2pass"])
def test_register_transform_only_vs_jax(tmp_path, flag):
    """register -noout / -2pass: the batched detection through the fused
    path's decode and stats_cand_fit, matching on the host."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch import cli

    _reg_seqs(tmp_path, np.random.default_rng(37))
    js = JSession(cwd=str(tmp_path))
    js.prefs.sf_radius = 6
    COMMANDS["register"].fn(js, ["g_", flag, "-transf=similarity",
                                 "-nostarlist"])
    jH = js.seq.reg(0).H.copy()
    jref = js.seq.reference_image
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "setfindstar",
                  "-radius=6"])
    cli.commands.cmd_register(ts, ["g_", flag, "-transf=similarity",
                                   "-nostarlist"])
    seq = ts.sequence
    assert seq.reference_image == jref
    assert seq.reg(0).valid.all()
    for k in range(4):
        np.testing.assert_allclose(_corners(seq.reg(0).H[k]),
                                   _corners(jH[k]), rtol=0, atol=SHIFT_TOL)
    assert {"read", "detect", "match"} <= set(ts.stages)
    assert not any(f.startswith("r_") for f in os.listdir(tmp_path))
    with pytest.raises(cli.CommandError, match="master"):
        cli.commands.cmd_register(ts, ["g_", "-disto=master"])


# ---------------------------------------------------------------------------
# plate-solved mosaics, 1/2/3 stars, the SIP warp
# ---------------------------------------------------------------------------


def _solved_frames(tmp_path, corners, size=96, name="m_"):
    """Frames cut from one sky with a TAN WCS each (the sky's, moved by
    the frame's corner), written by the JAX package's writer."""
    from siril_tpu.core.image import SirilImage
    from siril_tpu.io.fits_io import write_fits
    from siril_tpu.ops.wcs import WCS

    rng = np.random.default_rng(38)
    full = size + max(max(c) for c in corners)
    sky = 0.1 + 0.05 * rng.random((full, full)).astype(np.float32)
    th = np.radians(0.3)
    s = 1.0 / 3600.0
    canvas = WCS(crpix=(full / 2 + 0.5, full / 2 + 0.5),
                 crval=(83.8, -5.4),
                 cd=np.array([[-s * np.cos(th), s * np.sin(th)],
                              [s * np.sin(th), s * np.cos(th)]]),
                 height=full)
    for k, (x0, y0) in enumerate(corners):
        img = SirilImage(data=sky[None, y0:y0 + size, x0:x0 + size].copy())
        w = canvas.shifted(-x0, -y0)
        w.height = size
        if k == 2:
            w.crval = (w.crval[0] + 1e-4, w.crval[1])   # not a pure shift
        img.wcs = w
        write_fits(img, str(tmp_path / f"{name}{k + 1:05d}.fit"),
                   bitdepth=-32)


def test_register_astrometric_vs_jax(tmp_path):
    from siril_tpu.core.sequence import Sequence as JSeq
    from siril_tpu.registration import astrometric as jast
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.registration import astrometric as tast

    corners = [(0, 0), (40, 0), (0, 40), (40, 40)]
    _solved_frames(tmp_path, corners)
    js, ts = JSeq.scan("m_", str(tmp_path)), Sequence.scan("m_",
                                                          str(tmp_path))
    ts.incl[3] = js.incl[3] = True
    assert tast.register_astrometric(ts) == \
        jast.register_astrometric(js) == 4
    assert ts.reference_image == js.reference_image
    np.testing.assert_allclose(ts.reg(0).H, js.reg(0).H, rtol=0, atol=1e-9)
    # the frames are the sky moved by their corners
    for k, (x0, y0) in enumerate(corners):
        if k != 2:
            np.testing.assert_allclose(ts.reg(0).H[k][:2, 2], (x0, y0),
                                       atol=1e-6)
    # one solved frame is not enough
    one = Sequence.scan("m_", str(tmp_path))
    one.incl[1:] = False
    assert tast.register_astrometric(one) == 0


def test_seqapplyreg_without_regdata_vs_jax(tmp_path):
    """A plate-solved sequence with no registration data: seqapplyreg
    registers it from the WCS solutions and warps it onto the framing."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits

    corners = [(0, 0), (40, 0), (0, 40)]
    _solved_frames(tmp_path, corners)
    js = JSession(cwd=str(tmp_path))
    COMMANDS["seqapplyreg"].fn(js, ["m_", "-framing=max", "-prefix=j_"])
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "seqapplyreg",
                  "m_", "-framing=max", "-prefix=t_"])
    assert ts.sequence.number == 3
    assert "astrometric" in ts.stages
    for k in range(3):
        a = jread(str(tmp_path / f"j_m_{k + 1:05d}.fit")).host()
        b = read_fits(str(tmp_path / f"t_m_{k + 1:05d}.fit")).host()
        assert a.shape == b.shape == (1, 136, 136)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
    # the registration stays in the source's .seq
    from siril_tpu_torch.io.seqfile import read_seqfile

    reg = read_seqfile(str(tmp_path / "m_.seq")).reg(0)
    assert reg.valid.all()
    np.testing.assert_allclose(reg.H[1][:2, 2], (40, 0), atol=1e-4)
    for f in os.listdir(tmp_path):
        if f.startswith("m_"):
            os.unlink(tmp_path / f)
    with pytest.raises(FileNotFoundError):
        cli.run(["-d", str(tmp_path), "--device", "cpu", "seqapplyreg",
                 "m_"])


def _three_star_case(tmp_path, case):
    """tests/test_threestars.py's sequences: (the JAX package's sequence,
    the picked stars)."""
    import tests.test_threestars as t3

    rng = np.random.default_rng(12345)
    if case == "one":
        stars, shifts, picks = [(40.0, 50.0, 0.6)], \
            [(0, 0), (3.4, -2.2), (-5.1, 4.0)], [(40, 50)]
    elif case == "three":
        stars = [(30.0, 30.0, 0.6), (95.0, 40.0, 0.5), (60.0, 75.0, 0.55)]
        shifts, picks = [(0, 0), (2.5, 1.5)], [(30, 30), (95, 40), (60, 75)]
    elif case == "lost":
        stars, shifts, picks = [(40.0, 50.0, 0.6)], [(0, 0), (0, 0)], \
            [(40, 50)]
    else:
        stars = [(40.0, 50.0, 0.6), (90.0, 20.0, 0.5)]
        shifts, picks = [(0, 0), (1.5, -1.0)], [(40, 50), (90, 20)]
    seq = t3.make_seq(tmp_path, rng, shifts, stars)
    if case == "lost":
        from siril_tpu.core.image import FLOAT_IMG, SirilImage
        from siril_tpu.core.sequence import Sequence as JSeq
        from siril_tpu.io.fits_io import read_fits, write_fits

        d = read_fits(seq._file_list[1]).host()
        d[:, 30:72, 20:62] = 0.05
        write_fits(SirilImage(data=d), seq._file_list[1], bitdepth=FLOAT_IMG)
        seq = JSeq.from_files(seq._file_list, name="t_")
    return seq, picks


@pytest.mark.parametrize("case", ["one", "three", "lost", "command"])
def test_three_stars_vs_jax(tmp_path, case):
    """``register_three_stars`` on the same frames in both packages (the
    command's case through both command tables, compared in the
    ``.seq`` each writes)."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.registration.threestars import register_three_stars as jr
    from siril_tpu_torch import cli
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.registration.threestars import register_three_stars

    jseq, picks = _three_star_case(tmp_path, case)
    if case == "command":
        words = ["-3stars"] + [f"-star{i + 1}={x},{y}"
                               for i, (x, y) in enumerate(picks)]
        COMMANDS["register"].fn(JSession(cwd=str(tmp_path)), ["t_", *words])
        os.rename(tmp_path / "t_.seq", tmp_path / "jax.seq")
        ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "register",
                      "t_", *words])
        assert "follow" in ts.stages
        assert (tmp_path / "t_.seq").read_text() == \
            (tmp_path / "jax.seq").read_text()
        seq = read_seqfile(str(tmp_path / "t_.seq"))
        assert seq.reg(0).valid.all()
        with pytest.raises(cli.CommandError, match="star1"):
            cli.run(["-d", str(tmp_path), "--device", "cpu", "register",
                     "t_", "-3stars"])
        return
    seq = Sequence.from_files(jseq._file_list, name="t_")
    a = jr(jseq, picks)
    b = register_three_stars(seq, picks)
    assert (b.registered, b.failed) == (a.registered, a.failed)
    np.testing.assert_array_equal(seq.incl, jseq.incl)
    np.testing.assert_array_equal(seq.reg(0).valid, jseq.reg(0).valid)
    np.testing.assert_allclose(seq.reg(0).H, jseq.reg(0).H, rtol=0,
                               atol=1e-12)
    if case == "lost":
        assert b.failed == [1] and not seq.incl[1]
    else:
        assert seq.reg(0).valid.all()


def _sip_master(h, w, crpix2, terms):
    A = np.zeros((4, 4))
    B = np.zeros((4, 4))
    for (m, p, q), v in terms.items():
        (A if m == "A" else B)[p, q] = v
    return A, B, (w / 2.0 + 0.5, crpix2)


#: terms both axis conventions read alike: A[p, q] with q even, B with q
#: odd
RADIAL = {("A", 2, 0): 4e-4, ("A", 0, 2): -3e-4, ("B", 1, 1): 5e-4,
          ("A", 3, 0): 2e-6, ("B", 2, 1): -3e-6}


@pytest.mark.parametrize("invert", [True, False])
@pytest.mark.parametrize("method", [1, 3])
def test_sip_warp_vs_jax(invert, method):
    from siril_tpu.ops import interp as jinterp
    from siril_tpu_torch.ops import interp
    from siril_tpu_torch.ops.wcs import sip_frame

    rng = np.random.default_rng(39)
    h, w = 44, 58
    img = (0.1 + rng.random((1, h, w)) ** 4).astype(np.float32)
    H = np.array([[1.01, 0.02, 1.3], [-0.015, 0.99, -0.8], [0, 0, 1.0]])
    A, B, crpix = _sip_master(h, w, (h + 1) / 2.0, RADIAL)
    ref = np.asarray(jinterp.warp_homography_sip(
        img, H, A, B, np.array([crpix[0] - 1.0, crpix[1] - 1.0]), (h, w),
        method, True, invert=invert))
    got = interp.warp_homography_sip(
        torch.from_numpy(img), H, A, B, sip_frame(crpix, h), (h, w),
        method, True, invert=invert).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    plain = interp.warp_homography(torch.from_numpy(img), H, (h, w),
                                   method, True)
    zero = interp.warp_homography_sip(
        torch.from_numpy(img), H, np.zeros((4, 4)), np.zeros((4, 4)),
        sip_frame(crpix, h), (h, w), method, True, invert=invert)
    assert torch.equal(zero, plain)
    assert np.abs(got - plain.numpy()).max() > 0.01


def _centroid(img2d, x0, y0, r=6):
    ys, xs = np.mgrid[int(y0 - r):int(y0 + r + 1),
                      int(x0 - r):int(x0 + r + 1)]
    patch = img2d[int(y0 - r):int(y0 + r + 1),
                  int(x0 - r):int(x0 + r + 1)].astype(np.float64)
    patch = np.maximum(patch - np.median(patch), 0)
    return (float((xs * patch).sum() / patch.sum()),
            float((ys * patch).sum() / patch.sum()))


def test_seqapplyreg_disto_radial_vs_jax(tmp_path):
    """tests/test_registration.py:261's field: both packages straighten
    it, the port's stars within 0.05 px of the JAX package's."""
    import tests.test_registration as treg
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch import cli

    class _Spy(Exception):
        pass

    real = COMMANDS["seqapplyreg"].fn

    def stop(ctx, args):
        raise _Spy()

    COMMANDS["seqapplyreg"].fn = stop
    try:
        with pytest.raises(_Spy):
            treg.test_seqapplyreg_disto_corrects_sip(tmp_path)
    finally:
        COMMANDS["seqapplyreg"].fn = real
    js = JSession(cwd=str(tmp_path))
    js.load_sequence("dd_")
    real(js, ["dd_", "-disto=master_disto.fit", "-interp=bi"])
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "seqapplyreg",
                  "dd_", "-disto=master_disto", "-interp=bi",
                  "-prefix=t_"])
    a = js.seq.read_frame(0).host()[0]
    b = ts.sequence.read_frame(0).host()[0]
    for x0, y0 in ((30, 30), (70, 40), (45, 72)):
        ca = _centroid(a, x0 - 0.5, y0 - 0.5)
        cb = _centroid(b, x0 - 0.5, y0 - 0.5)
        # v's origins differ by one row: B[1, 1]·u of a row apart
        assert abs(ca[0] - cb[0]) < 0.02, (ca, cb)
        assert abs(ca[1] - cb[1]) < 0.15 / 48.0 * abs(x0 - 48) + 0.02, \
            (ca, cb)
        assert np.hypot(cb[0] - (x0 - 0.5), cb[1] - (y0 - 0.5)) < 0.3


def _distorted_field(tmp_path):
    """A 256² field through a TAN WCS with a known SIP whose B[2, 0] and
    B[0, 2] no axis flip preserves; the catalogue of its stars; two
    frames with identity registration.  Returns (stars' RA, Dec, mag,
    observed x, y)."""
    from siril_tpu.astrometry.catalog import Catalog
    from siril_tpu.core.image import SirilImage
    from siril_tpu.io.fits_io import write_fits
    from siril_tpu.ops.wcs import WCS

    rng = np.random.default_rng(5)
    n = h = w = 256
    s = 2.0 / 3600
    A = np.zeros((4, 4))
    B = np.zeros((4, 4))
    # second-order pairs without a mean and a third-order pair orthogonal
    # to u over the square, so that the solver's linear fit is unbiased
    A[2, 0], A[0, 2], A[3, 0], A[1, 2] = 1.2e-4, -1.2e-4, 3e-7, -5.4e-7
    B[2, 0], B[0, 2], B[1, 1] = 1.5e-4, -1.5e-4, 1e-4
    truth = WCS(crpix=(w / 2 + 0.5, h / 2 + 0.5), crval=(150.0, 40.0),
                cd=np.array([[-s, 0], [0, s]]), height=h, sip_a=A, sip_b=B)
    n = 160
    ox = rng.uniform(10, w - 10, n)
    oy = rng.uniform(10, h - 10, n)
    ra, dec = truth.pix2world(ox, oy)
    mag = rng.uniform(7, 11, n)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.05 + rng.normal(0, 0.002, (h, w))
    for x0, y0, m in zip(ox, oy, mag):
        img += 0.6 * 10 ** (-0.4 * (m - 7.0)) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * 1.5 ** 2))
    img = np.clip(img, 0, 1).astype(np.float32)
    Catalog(ra=ra, dec=dec, mag=mag).save(str(tmp_path / "cat.npz"))
    for i in range(2):
        write_fits(SirilImage(data=img[None]),
                   str(tmp_path / f"dd_{i + 1:05d}.fit"), bitdepth=-32)
    return ra, dec, mag, ox, oy, img


def _affine_residuals(ideal, measured):
    """|measured − the best affine image of ideal|, per axis: a straight
    field is an affine image of the TAN projection."""
    M = np.c_[ideal, np.ones(len(ideal))]
    sol, *_ = np.linalg.lstsq(M, measured, rcond=None)
    return np.abs(measured - M @ sol)


def test_sip_axis_convention(tmp_path):
    """``platesolve -order=3`` → ``seqapplyreg -disto=`` through both
    packages on a field distorted with B[2, 0] ≠ 0 (ROADMAP §3): the
    port's chain straightens it; the JAX package's evaluates B at
    top-down v and moves rows the wrong way, so y gets worse."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.ops.wcs import WCS
    from siril_tpu_torch import cli

    ra, dec, mag, ox, oy, img = _distorted_field(tmp_path)
    solve = ["150.0", "40.0", "-catalog=cat.npz", "-order=3",
             "-focal=1000", f"-pixelsize={2.0 * 1000 / 206.265}"]
    js = JSession(cwd=str(tmp_path))
    COMMANDS["load"].fn(js, ["dd_00001.fit"])
    COMMANDS["platesolve"].fn(js, solve)
    COMMANDS["save"].fn(js, ["jmaster"])
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "load",
                  "dd_00001.fit"])
    cli.commands.cmd_platesolve(ts, solve)
    cli.commands.cmd_save(ts, ["tmaster"])
    jw, tw = js.image.wcs, ts.image.wcs
    # the two packages' star positions differ by the LM fits' float32
    # rounding (≤ 0.02 px, test_detection_vs_jax)
    np.testing.assert_allclose(tw.cd, jw.cd, rtol=0,
                               atol=1e-6 * np.abs(jw.cd).max())
    for k in ("sip_a", "sip_b"):
        np.testing.assert_allclose(getattr(tw, k), getattr(jw, k), rtol=0,
                                   atol=2e-6)
    seq = js.load_sequence("dd_")
    seq.reg(0).H[:] = np.eye(3)
    seq.reg(0).valid[:] = True
    seq.save()
    COMMANDS["seqapplyreg"].fn(js, ["dd_", "-disto=jmaster.fit",
                                    "-interp=bi", "-prefix=j_"])
    jout = js.seq.read_frame(0).host()[0]
    cli.commands.cmd_seqapplyreg(ts, ["dd_", "-disto=tmaster", "-interp=bi",
                                      "-prefix=t_"])
    tout = ts.sequence.read_frame(0).host()[0]
    lin = WCS(crpix=tw.crpix, crval=tw.crval, cd=tw.cd, height=256)
    ix, iy = lin.world2pix(ra, dec)
    near = np.array([np.sort(np.hypot(ox - ox[k], oy - oy[k]))[1]
                     for k in range(len(ox))])
    ok = (ix > 15) & (ix < 241) & (iy > 15) & (iy < 241) & (mag < 9.5) \
        & (near > 10)
    assert ok.sum() >= 30
    ideal = np.stack([ix[ok], iy[ok]], 1)
    got = {name: np.array([_centroid(im, x, y, 4) for x, y in pos])
           for name, im, pos in (("before", img, zip(ox[ok], oy[ok])),
                                 ("jax", jout, ideal), ("port", tout,
                                                        ideal))}
    r = {k: _affine_residuals(ideal, v) for k, v in got.items()}
    # the field was distorted in both axes
    assert (r["before"].mean(0) > 0.5).all() and r["before"].max() > 1.5
    # the port straightens both axes
    assert (r["port"].mean(0) < 0.08).all() and r["port"].max() < 0.3
    # the JAX package's chain straightens x, not y: worse than before
    assert r["jax"].mean(0)[0] < 0.08
    assert r["jax"].mean(0)[1] > r["before"].mean(0)[1]


def test_register_disto_vs_jax(tmp_path):
    """``register -disto=``: the star match, then the warp with the
    master's SIP in its sampling, through both packages' commands, on a
    master whose terms both axis conventions read alike: the transforms
    within 0.01 px at the corners (the LM fits differ in float32), so the
    warped frames within 1e-2 and 2e-4 on average."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.core.image import SirilImage
    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu.io.fits_io import write_fits
    from siril_tpu.ops.wcs import WCS
    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits

    _reg_seqs(tmp_path, np.random.default_rng(37))
    h, w = 128, 144
    A, B, crpix = _sip_master(h, w, (h + 1) / 2.0, {
        ("A", 2, 0): 1e-4, ("A", 0, 2): -8e-5, ("B", 1, 1): 1.2e-4})
    master = SirilImage(data=np.zeros((1, h, w), np.float32))
    master.wcs = WCS(crpix=crpix, crval=(150.0, 20.0),
                     cd=np.array([[-2.8e-4, 0], [0, 2.8e-4]]), height=h,
                     sip_a=A, sip_b=B)
    write_fits(master, str(tmp_path / "master.fit"), bitdepth=-32)
    js = JSession(cwd=str(tmp_path))
    js.prefs.sf_radius = 6
    COMMANDS["register"].fn(js, ["g_", "-disto=master", "-prefix=j_",
                                 "-transf=similarity", "-nostarlist"])
    jH = js.load_sequence("g_").reg(0).H.copy()
    ts = cli.run(["-d", str(tmp_path), "--device", "cpu", "setfindstar",
                  "-radius=6"])
    cli.commands.cmd_register(ts, ["g_", "-disto=master", "-prefix=t_",
                                   "-transf=similarity", "-nostarlist"])
    assert ts.sequence.name == "t_g_" and ts.sequence.number == 4
    assert {"detect", "match", "warp"} <= set(ts.stages)
    from siril_tpu_torch.io.seqfile import read_seqfile

    tH = read_seqfile(str(tmp_path / "g_.seq")).reg(0).H
    for k in range(4):
        np.testing.assert_allclose(_corners(tH[k]), _corners(jH[k]), rtol=0,
                                   atol=SHIFT_TOL)
        a = jread(str(tmp_path / f"j_g_{k + 1:05d}.fit")).host()
        b = read_fits(str(tmp_path / f"t_g_{k + 1:05d}.fit")).host()
        assert float(np.abs(a - b).max()) < 1e-2
        assert float(np.abs(a - b).mean()) < 2e-4
