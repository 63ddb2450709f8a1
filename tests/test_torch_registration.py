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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.commands.cmd_register(ts, ["g_", "-disto=master"])
