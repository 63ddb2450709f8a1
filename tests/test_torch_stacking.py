"""Parity: the port's staged ``stack`` path against the JAX package, on the
CPU, on the same small FITS sequences made from a seed with numpy.

- ``ops/stacking.stack_sequence`` against ``siril_tpu.ops.stacking.
  stack_sequence``: the device-resident path on u16 and on f32 frames,
  the streamed row-block path with rejection maps and with integer shifts
  set through ``regparam``, every weighting type, SIGMEDIAN / LINEARFIT /
  GESDT, and the median stack.  The image within atol 1e-5 (the
  estimators are the same order statistics reached by a sort here and by
  bisection or interpolation there, within one float32 ulp, and sums of
  ~3e3 terms run in another order), rejection totals equal.  Winsorized
  cases except the pixels where the JAX package's σ loop differs from the
  C iteration: there the port must equal the oracle on the block it
  stacked (tests/test_torch_rejection.winsorized_vs_jax), and the totals
  and rejection maps may differ by those pixels' counts only;
- the GESDT λ table bit-equal;
- the background noise against ``bgnoise_np``, rtol 1e-5, on the dense
  path and on the path with zero pixels;
- ``stack`` through the CLI writes the image, its STACKCNT and the
  rejection maps;
- ``fusedstack`` with SIGMEDIAN, LINEARFIT and GESDT against the JAX
  fused path (tolerances of tests/test_torch_pipeline.py);
- seam feathering (``-feather=``: per-pixel weights into the weighted
  mean), in the cases above;
- sum / min / max with and without ``-maximize``, with and without
  shifts: equal (the same float64 sums in the same order);
- the overlap normalization of a shifted mosaic of 4 tiles: the
  coefficients equal (the same numpy code) and the stack within 1e-5;
- the frame filters (``-filter-*`` in their absolute, ``%`` and ``k``
  forms and ``-filter-incl``) on ``stack`` and ``seqapplyreg``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from siril_tpu.core.sequence import Sequence as JSequence
from siril_tpu.ops import rejection as jrj
from siril_tpu.ops import stacking as jst
from siril_tpu.ops.statistics import bgnoise_np
from siril_tpu_torch import cli, convert
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.io.fits_io import read_fits, write_fits
from siril_tpu_torch.kernels import reject_stack as k1
from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops import stacking as tst
from siril_tpu_torch.ops.statistics import bgnoise
from tests.test_torch_rejection import jax_winsorized, winsorized_vs_jax

torch.set_num_threads(1)

N, H, W = 7, 40, 48


def _write(d, prefix, bitdepth, seed=21):
    """N frames of one scene with noise that differs frame to frame (so
    noise weights differ), cosmic rays, a dead corner, and per-frame
    stack counts and exposures."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    scene = 0.1 + 0.02 * rng.random((H, W)).astype(np.float32)
    for _ in range(5):
        x0, y0 = rng.uniform(8, W - 8), rng.uniform(8, H - 8)
        scene += 0.4 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 4.0)
    for i in range(N):
        sig = 0.004 * (1 + 0.3 * i)
        f = 1.02 ** i * scene + 0.003 * i + \
            rng.normal(0, sig, (H, W)).astype(np.float32)
        f[rng.integers(0, H, 12), rng.integers(0, W, 12)] = 0.97
        f[:3, :3] = 0.0
        img = SirilImage(data=np.clip(f, 0, 1)[None].astype(np.float32))
        img.keywords.exposure = 30.0
        img.keywords.stackcnt = 1 + i % 3
        write_fits(img, os.path.join(d, f"{prefix}{i + 1:05d}.fit"),
                   bitdepth=bitdepth)
    return scene


@pytest.fixture(scope="module")
def seqdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stackseq"))
    _write(d, "u_", 16)
    _write(d, "f_", -32)
    return d


def _both(d, prefix, shifts=None, reg=None):
    jseq = JSequence.scan(prefix, d)
    tseq = Sequence.scan(prefix, d)
    for seq in (jseq, tseq):
        r = seq.reg(0)
        if shifts is not None:
            for k, (dx, dy) in enumerate(shifts):
                r.H[k, 0, 2], r.H[k, 1, 2] = dx, dy
            r.valid[:] = True
        if reg is not None:
            r.weighted_fwhm[:] = reg["wfwhm"]
            r.number_of_stars[:] = reg["nstars"]
    return jseq, tseq


CASES = {
    # name: (prefix, StackArgs fields, shifts)
    "resident_u16_winsorized": ("u_", dict(normalize=3), None),
    "resident_f32_winsorized": ("f_", dict(normalize=3), None),
    # at N = 7 one outlier lies at most (N−1)/√N = 2.27 σ from the mean,
    # so the σ-based modes clip at 2σ to reject anything
    "resident_u16_sigmedian": ("u_", dict(normalize=3, rejection=4,
                                          siglow=2.0, sighigh=2.0), None),
    "resident_u16_linearfit": ("u_", dict(normalize=3, rejection=6), None),
    "resident_f32_gesdt": ("f_", dict(normalize=3, rejection=7,
                                      siglow=0.3, sighigh=0.05), None),
    "resident_mul_sigma": ("u_", dict(normalize=2, rejection=2, siglow=2.0,
                                      sighigh=2.0), None),
    "streamed_rejmaps": ("u_", dict(normalize=3, create_rejmaps=True),
                         None),
    "streamed_rejmaps_merged_gesdt": (
        "f_", dict(normalize=3, rejection=7, siglow=0.3, sighigh=0.05,
                   create_rejmaps=True, merge_rejmaps=True), None),
    "streamed_shifts": ("u_", dict(normalize=3),
                        [(0, 0), (2, -1), (-3, 1), (1, 2), (0, -2), (3, 3),
                         (-1, 0)]),
    "weight_noise": ("u_", dict(normalize=3, weighting=3), None),
    "weight_noise_streamed": ("f_", dict(normalize=3, weighting=3,
                                         create_rejmaps=True), None),
    "weight_wfwhm": ("u_", dict(normalize=3, weighting=2), None),
    "weight_nbstars": ("u_", dict(normalize=3, weighting=1), None),
    "weight_nbstack": ("f_", dict(normalize=3, weighting=4), None),
    "feather_shifts": ("u_", dict(normalize=3, feather_dist=6),
                       [(0, 0), (2, -1), (-3, 1), (1, 2), (0, -2), (3, 3),
                        (-1, 0)]),
    "feather_weight_noise": ("f_", dict(normalize=3, weighting=3,
                                        feather_dist=4), None),
    "median": ("u_", dict(method="med"), None),
    "median_streamed": ("f_", dict(method="med", create_rejmaps=True),
                        [(1, 0)] * N),
}


def spy_k1(monkeypatch):
    """Record every call of the kernel's wrapper: (block, scale, offset,
    mul, keyword arguments, (mean, rej_low, rej_high))."""
    calls = []
    real = k1.reject_mean

    def spy(stack, scale, offset, mul, **kw):
        out = real(stack, scale, offset, mul, **kw)
        calls.append((stack, scale, offset, mul, kw, out))
        return out

    monkeypatch.setattr(k1, "reject_mean", spy)
    return calls


def winsorized_block_vs_jax(calls):
    """The one winsorized block a stack ran: the port's per-pixel result
    against the JAX package's winsorized rejection of the same normalized
    block, through ``winsorized_vs_jax``.  Returns (differing pixels, the
    JAX package's (mean, rej_low, rej_high), the port's and the JAX
    package's (low, high) counts summed over those pixels)."""
    assert len(calls) == 1                     # one layer, one row block
    stack, scale, offset, mul, kw, out = calls[0]
    assert kw["rtype"] == rj.WINSORIZED
    xn = tst.normalize_block(stack, scale, offset, mul, kw["mode"]).numpy()
    w = kw.get("weights")
    w = None if w is None else w.numpy()
    jref = jax_winsorized(xn, kw["siglow"], kw["sighigh"], w)
    idx, pcount, jcount = winsorized_vs_jax(
        [o.numpy() for o in out], jref, xn, kw["siglow"], kw["sighigh"], w)
    return idx, jref, pcount, jcount


@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_sequence_vs_jax(seqdir, case, monkeypatch):
    prefix, fields, shifts = CASES[case]
    reg = dict(wfwhm=np.linspace(2.0, 3.5, N), nstars=np.arange(N) * 7 + 30)
    jseq, tseq = _both(seqdir, prefix, shifts, reg)
    jargs = jst.StackArgs(**fields)
    ref = jst.stack_sequence(jseq, jargs)
    calls = spy_k1(monkeypatch)
    before = sum(k1.launches.values())
    got = tst.stack_sequence(
        tseq, convert.stack_args(dataclasses.asdict(jargs)), device="cpu")
    assert sum(k1.launches.values()) == before   # plain version on the CPU
    a, b = ref.image.host(), got.image.host()
    assert b.shape == a.shape == (1, H, W)
    winsor = jargs.method == "rej" and jargs.rejection == rj.WINSORIZED
    # the pixels where the JAX package's winsorized σ loop leaves the C
    # iteration, and what the JAX package computes on the port's block
    idx, pcount, jcount = np.zeros(0, int), (0, 0), (0, 0)
    if winsor:
        idx, jref, pcount, jcount = winsorized_block_vs_jax(calls)
        np.testing.assert_allclose(a.reshape(-1)[idx],
                                   np.clip(jref[0][idx], 0.0, 1.0),
                                   rtol=0, atol=1e-5)
    same = np.ones(H * W, bool)
    same[idx] = False
    np.testing.assert_allclose(b.reshape(-1)[same], a.reshape(-1)[same],
                               rtol=0, atol=1e-5)
    for g, r, pc, jc in zip(got.total_rejected, ref.total_rejected, pcount,
                            jcount):
        assert g - pc == r - jc
    assert got.capped == 0
    if jargs.create_rejmaps and jargs.method == "rej":
        assert (got.rejmap_high is None) == (ref.rejmap_high is None)
        for gmap, rmap, k in ((got.rejmap_low, ref.rejmap_low, 1),
                              (got.rejmap_high, ref.rejmap_high, 2)):
            if rmap is None:
                continue
            gm, rm = gmap.host().reshape(-1), rmap.host().reshape(-1)
            np.testing.assert_array_equal(gm[same], rm[same])
            if winsor:
                np.testing.assert_array_equal(
                    np.rint(rm[idx] * 65535.0), jref[k][idx])
    if jargs.method == "rej" and jargs.rejection != rj.NO_REJEC:
        assert sum(got.total_rejected) > 0
    assert got.image.keywords.stackcnt == N
    assert got.image.keywords.livetime == pytest.approx(30.0 * N)
    if jargs.weighting == 3:
        for k in range(N):
            assert tseq.get_frame_stats(0, k).bgnoise == pytest.approx(
                jseq.get_frame_stats(0, k).bgnoise, rel=1e-5)


def test_plan_blocks_and_shifts(seqdir):
    assert tst.plan_blocks(4096, 4096, 24, 1843) == \
        jst.plan_blocks(4096, 4096, 24, 1843)
    assert tst.plan_blocks(40, 48, 7, 1) == jst.plan_blocks(40, 48, 7, 1)
    jseq, tseq = _both(seqdir, "u_", [(2, -1)] * N)
    idx = np.arange(N)
    for a, b in zip(tst.frame_shifts(tseq, idx, 0),
                    jst._frame_shifts(jseq, idx, 0)):
        np.testing.assert_array_equal(a, b)
    for y0, y1, sh in ((0, 17, (2, -1)), (30, 40, (-5, 7)), (5, 9, None)):
        np.testing.assert_array_equal(
            tst.read_block(tseq, 0, 3, y0, y1, sh, W),
            jst._read_block(jseq, 0, 3, y0, y1, sh, W))


@pytest.mark.parametrize("n,alpha,frac", [(7, 0.05, 0.3), (24, 0.05, 0.3),
                                          (50, 0.01, 0.2)])
def test_gesdt_table_bit_equal(n, alpha, frac):
    mo = rj.gesdt_max_outliers(n, frac)
    assert mo == int(np.floor(n * frac))
    got = rj.gesdt_critical_values(n, alpha, mo)
    ref = jrj.gesdt_critical_values(n, alpha, mo)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("zeros", [False, True])
def test_bgnoise_vs_jax(zeros):
    rng = np.random.default_rng(17 + zeros)
    img = (0.2 + 0.01 * rng.standard_normal((64, 80))).astype(np.float32)
    img[rng.integers(0, 64, 40), rng.integers(0, 80, 40)] = 0.9
    if zeros:
        img[rng.random(img.shape) < 0.1] = 0.0
        img[5, :78] = 0.0                      # a row with too few pixels
        img[9, 3] = np.nan
    got = bgnoise(torch.from_numpy(img))
    ref = bgnoise_np(img)
    assert ref > 0
    assert got == pytest.approx(ref, rel=1e-5)


def test_compute_stats_basic_vs_jax():
    from siril_tpu.ops.statistics import STATS_BASIC, compute_stats_np
    from siril_tpu_torch.ops.statistics import compute_stats_basic

    rng = np.random.default_rng(4)
    img = (0.3 + 0.02 * rng.standard_normal((50, 61))).astype(np.float32)
    img[rng.random(img.shape) < 0.05] = 0.0
    got = compute_stats_basic(torch.from_numpy(img))
    ref = compute_stats_np(img, STATS_BASIC)
    for key in ("total", "ngoodpix", "mean", "median", "sigma", "min",
                "max", "bgnoise"):
        assert getattr(got, key) == pytest.approx(getattr(ref, key),
                                                  rel=1e-5), key


def test_cli_stack_writes_outputs(tmp_path):
    d = str(tmp_path)
    _write(d, "r_light_", -32)
    before = sum(k1.launches.values())
    s = cli.run(["-d", d, "--device", "cpu", "stack", "r_light_", "rej",
                 "g", "0.3", "0.05", "-norm=addscale", "-rejmaps",
                 "-out=result"])
    assert sum(k1.launches.values()) == before
    img = read_fits(os.path.join(d, "result.fit"))
    np.testing.assert_array_equal(img.host(), s.result.image.host())
    assert img.keywords.stackcnt == N
    for name in ("rejmap_low", "rejmap_high"):
        rm = read_fits(os.path.join(d, name + ".fit")).host()
        assert rm.shape == (1, H, W)
    low = read_fits(os.path.join(d, "rejmap_low.fit")).host()
    high = read_fits(os.path.join(d, "rejmap_high.fit")).host()
    assert int(round((low.sum() + high.sum()) * 65535)) == \
        sum(s.result.total_rejected)
    s = cli.run(["-d", d, "--device", "cpu", "stack", "r_light_", "rej",
                 "a", "3", "3", "-norm=addscale", "-16b"])
    assert read_fits(os.path.join(d, "r_light_stacked.fit")).orig_bitdepth \
        == 20
    with pytest.raises(cli.CommandError, match="between 0 and 1"):
        cli.run(["-d", d, "--device", "cpu", "stack", "r_light_", "rej",
                 "g", "3", "3"])


def test_stack_args_from_flags_vs_jax():
    from siril_tpu.cli.commands import _stack_args_from_flags

    for words in (["s", "rej", "g"], ["s", "rej", "p"],
                  ["s", "rej", "l", "2", "4", "-norm=mulscale",
                   "-weight_from_wfwhm", "-rejmap=merged", "-16b"],
                  ["s", "med", "-weight_from_nbstack", "-fastnorm"],
                  ["s", "mean", "-rgb_equal", "-output_norm",
                   "-weight_from_noise", "-rejmaps"]):
        pos, flags = cli.parse_flags(words)
        want = dataclasses.asdict(_stack_args_from_flags(pos, flags))
        assert dataclasses.asdict(cli.stack_args_from_flags(pos, flags)) \
            == want


def test_stack_unported_raise(seqdir, tmp_path):
    """``-drizzle`` and ``-upscale``, the last options ``stack`` refused,
    run as in the JAX package on this file's 16-bit sequence with
    integer shifts (tests/test_torch_drizzle.py holds them in full):
    the drizzle within 2e-6, the upscaled stack within one 16-bit step
    (its frames are written at 16 bits).  Without registration data
    both packages refuse to drizzle."""
    import shutil

    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession

    for words, tol in ((["u_", "-drizzle", "-scale=2", "-pixfrac=0.8",
                         "-out=drz"], 2e-6),
                       (["u_", "rej", "s", "3", "3", "-upscale",
                         "-out=ups"], 1.0 / 65535 + 1e-6)):
        for d in ("jax", "port"):
            shutil.rmtree(tmp_path / d, ignore_errors=True)
            shutil.copytree(seqdir, tmp_path / d, ignore=shutil.
                            ignore_patterns("f_*", "*.seq", "upscaled_*"))
        with pytest.raises(ValueError, match="registration"):
            cli.run(["-d", str(tmp_path / "port"), "--device", "cpu",
                     "stack", "u_", "-drizzle"])
        for d in ("jax", "port"):
            seq = Sequence.scan("u_", str(tmp_path / d))
            r = seq.reg(0)
            r.H[:, 0, 2] = [0, 2, -1, 3, 0, 1, -2][:N]
            r.H[:, 1, 2] = [0, -1, 2, 0, 1, -3, 1][:N]
            r.valid[:] = True
            seq.save()
        COMMANDS["stack"].fn(JSession(cwd=str(tmp_path / "jax")), words)
        cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", "stack",
                 *words])
        name = words[-1][5:] + ".fit"
        a, b = (read_fits(str(tmp_path / d / name)).host()
                for d in ("jax", "port"))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def fused_dir(tmp_path_factory):
    from tests.test_pipeline import make_seq

    d = tmp_path_factory.mktemp("fused_algs")
    _, base = make_seq(d, np.random.default_rng(3),
                       [(0, 0), (4, 2), (-3, 5), (6, -4), (2, 2)])
    return d, base


@pytest.mark.parametrize("rtype,sl,sh", [(rj.SIGMEDIAN, 2.0, 2.0),
                                         (rj.LINEARFIT, 2.0, 2.0),
                                         (rj.GESDT, 0.3, 0.05)])
def test_fusedstack_rejections_vs_jax(fused_dir, rtype, sl, sh):
    """The fused path with the K1b-K1d modes (tolerances of
    tests/test_torch_pipeline.py: float32 LM fits and lanczos weights)."""
    from siril_tpu.ops.normalization import ADDITIVE_SCALING
    from siril_tpu.pipeline import FusedArgs, fused_preprocess_stack
    from siril_tpu.registration.starfinder import StarFinderParams
    from siril_tpu_torch import pipeline as tpipe

    d, base = fused_dir
    args = FusedArgs(stack=jst.StackArgs(method="rej", rejection=rtype,
                                         siglow=sl, sighigh=sh,
                                         normalize=ADDITIVE_SCALING),
                     starfinder=StarFinderParams(radius=6))
    ref = fused_preprocess_stack(JSequence.scan("fl_", str(d)), args)
    got = tpipe.fused_preprocess_stack(
        Sequence.scan("fl_", str(d)),
        convert.fused_args(dataclasses.asdict(args)), device="cpu")
    inner = np.s_[20:-20, 20:-20]
    a, b = ref.image.host()[0], got.image.host()[0]
    d = np.abs(a[inner] - b[inner])
    # shifts that differ by ~1e-5 px move values by ~1e-8; where that
    # flips a decision (a GESDT step whose two ends lie almost equally far
    # from the mean removes the other end) the 5-frame mean moves by up to
    # the column's spread / 4, a few noise σ (0.002)
    assert (d > 1e-4).sum() <= 5e-4 * d.size
    assert d.max() <= 5e-3
    for r, g in zip(ref.total_rejected, got.total_rejected):
        assert abs(r - g) <= 0.005 * r
    assert sum(got.total_rejected) > 0
    assert got.capped == 0
    assert np.abs(b[inner] - base[inner]).mean() < 0.01


# ---------------------------------------------------------------------------
# sum / min / max, maximize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("method", ["sum", "min", "max"])
def test_stack_accumulate_vs_jax(seqdir, method, maximize, shifted):
    shifts = [(0, 0), (2, -1), (-3, 1), (1, 2), (0, -2), (3, 3),
              (-1, 0)] if shifted else None
    jseq, tseq = _both(seqdir, "f_", shifts)
    jargs = jst.StackArgs(method=method, maximize=maximize)
    ref = jst.stack_sequence(jseq, jargs)
    got = tst.stack_sequence(
        tseq, convert.stack_args(dataclasses.asdict(jargs)), device="cpu")
    a, b = ref.image.host(), got.image.host()
    want = (1, H + 5, W + 6) if shifted and maximize else (1, H, W)
    assert a.shape == b.shape == want
    np.testing.assert_array_equal(b, a)
    assert got.image.keywords.stackcnt == N
    assert {"read", "upload", "accumulate", "fetch"} <= set(got.stage_s)


def test_cli_stack_sum_max_maximize(tmp_path):
    d = str(tmp_path)
    _write(d, "r_", -32)
    seq = Sequence.scan("r_", d)
    seq.reg(0).H[:, :2, 2] = [(k, -k) for k in range(N)]
    seq.reg(0).valid[:] = True
    seq.save()
    s = cli.run(["-d", d, "--device", "cpu", "stack", "r_", "sum",
                 "-out=sum"])
    out = read_fits(os.path.join(d, "sum.fit")).host()
    np.testing.assert_array_equal(out, s.result.image.host())
    assert out.shape == (1, H, W) and out.max() == 1.0
    s = cli.run(["-d", d, "--device", "cpu", "stack", "r_", "max",
                 "-maximize", "-out=max"])
    out = read_fits(os.path.join(d, "max.fit")).host()
    assert out.shape == (1, H + N - 1, W + N - 1)


# ---------------------------------------------------------------------------
# a mosaic: overlap normalization and feathering
# ---------------------------------------------------------------------------

#: the mosaic's tiles: top-left corners on the sky, sky level, gain
TILES = [((0, 0), 0.10, 1.00), ((32, 0), 0.13, 0.92), ((0, 24), 0.08, 1.07),
         ((32, 24), 0.115, 0.96)]
TILE_H, TILE_W = 32, 40


def _mosaic(d, seed=31):
    """4 tiles of one sky (56 × 72) with 8-pixel overlaps, each with its
    own sky level and gain, 16-bit, and their shifts in both packages'
    sequences; returns the sky."""
    rng = np.random.default_rng(seed)
    sky = (0.02 * rng.random((56, 72))).astype(np.float32)
    yy, xx = np.mgrid[0:56, 0:72]
    for _ in range(12):
        x0, y0 = rng.uniform(4, 68), rng.uniform(4, 52)
        sky += 0.3 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 3.0)
    for i, ((x0, y0), level, gain) in enumerate(TILES):
        f = level + gain * sky[y0:y0 + TILE_H, x0:x0 + TILE_W] + \
            rng.normal(0, 0.003, (TILE_H, TILE_W))
        write_fits(SirilImage(data=np.clip(f, 0, 1)[None].astype(
            np.float32)), os.path.join(d, f"mos_{i + 1:05d}.fit"),
            bitdepth=16)
    seqs = _both(d, "mos_", [xy for xy, _, _ in TILES])
    return sky, seqs


@pytest.mark.parametrize("feather", [0, 8])
@pytest.mark.parametrize("mode", [3, 1, 2])
def test_overlap_normalization_vs_jax(tmp_path, mode, feather,
                                      monkeypatch):
    """The overlap normalization's coefficients on a shifted mosaic of 4
    tiles equal the JAX package's; the stack (with and without seam
    feathering) within 1e-5 of it, counts as test_stack_sequence_vs_jax
    holds them; additive+scaling takes out each tile's level and gain, so
    the seams show no step."""
    from siril_tpu.ops import normalization as jnorm
    from siril_tpu_torch.ops import normalization as tnorm

    sky, (jseq, tseq) = _mosaic(str(tmp_path))
    idx = np.arange(4)
    ref_c = jnorm.compute_overlap_normalization(jseq, idx, mode)
    got_c = tnorm.compute_overlap_normalization(tseq, idx, mode)
    for k in ("offset", "mul", "scale"):
        np.testing.assert_allclose(getattr(got_c, k), getattr(ref_c, k),
                                   rtol=1e-12, atol=1e-15)
    jargs = jst.StackArgs(method="rej", rejection=rj.WINSORIZED,
                          normalize=mode, overlap_norm=True,
                          feather_dist=feather)
    ref = jst.stack_sequence(jseq, jargs)
    calls = spy_k1(monkeypatch)
    got = tst.stack_sequence(
        tseq, convert.stack_args(dataclasses.asdict(jargs)), device="cpu")
    assert calls[0][4]["weights"] is None or feather
    if feather:
        assert tuple(calls[0][4]["weights"].shape) == (4, TILE_H * TILE_W)
    idx_w, _, pcount, jcount = winsorized_block_vs_jax(calls)
    same = np.ones(TILE_H * TILE_W, bool)
    same[idx_w] = False
    a, b = ref.image.host().reshape(-1), got.image.host().reshape(-1)
    np.testing.assert_allclose(b[same], a[same], rtol=0, atol=1e-5)
    for g, r, pc, jc in zip(got.total_rejected, ref.total_rejected, pcount,
                            jcount):
        assert g - pc == r - jc
    if mode == 3:
        # the seam at x = 32 in the reference tile: tile 2 joins there;
        # the level across it matches within the noise
        out = got.image.host()[0]
        step = out[2:22, 33:36].mean() - out[2:22, 28:31].mean()
        want = sky[2:22, 33:36].mean() - sky[2:22, 28:31].mean()
        assert abs(step - want) < 0.003


def test_mosaic_max_maximize(tmp_path):
    """max -maximize spreads the canvas over the four tiles' footprints:
    the union of the mosaic, every pixel covered."""
    sky, (jseq, tseq) = _mosaic(str(tmp_path))
    jargs = jst.StackArgs(method="max", maximize=True)
    ref = jst.stack_sequence(jseq, jargs)
    got = tst.stack_sequence(tseq, convert.stack_args(
        dataclasses.asdict(jargs)), device="cpu")
    out = got.image.host()
    assert out.shape == (1, 56, 72)
    np.testing.assert_array_equal(out, ref.image.host())
    assert (out > 0).all()


def _footprints(d, seed=33):
    """5 frames of 40 × 48 as a warped mosaic canvas leaves them: a
    turned quadrilateral footprint, one touching the frame's border, one
    covering all of it, one empty, one of two patches; zero outside."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] + 0.5
    covs = [(0.97 * xx + 0.26 * yy > 6) & (0.97 * xx + 0.26 * yy < 34) &
            (-0.26 * xx + 0.97 * yy > -4) & (-0.26 * xx + 0.97 * yy < 22),
            (xx > 20) & (yy < 30), np.ones((H, W), bool),
            np.zeros((H, W), bool),
            ((xx - 10) ** 2 + (yy - 10) ** 2 < 40) | ((xx > 30) & (yy > 25))]
    for i, cov in enumerate(covs):
        f = np.where(cov, 0.05 + 0.5 * rng.random((H, W)), 0.0)
        write_fits(SirilImage(data=f[None].astype(np.float32)),
                   os.path.join(d, f"fp_{i + 1:05d}.fit"), bitdepth=-32)
    return _both(d, "fp_")


@pytest.mark.parametrize("case", ["shifted_tiles", "canvas_footprints"])
def test_feather_masks_vs_jax(tmp_path, case):
    """The seam-feathering masks equal the JAX package's bit for bit: the
    port runs the distance transform and the smoothstep on each
    coverage's bounding box and its ring only, the JAX package on the
    whole frame."""
    if case == "shifted_tiles":
        _, (jseq, tseq) = _mosaic(str(tmp_path))
        dist = 8
    else:
        jseq, tseq = _footprints(str(tmp_path))
        dist = 6
    idx = np.arange(tseq.number)
    ref = np.stack(jst.compute_feather_masks(jseq, idx, dist, 0))
    got = tst.compute_feather_masks(tseq, idx, dist, 0)
    assert got.dtype == ref.dtype == np.float16
    np.testing.assert_array_equal(got, ref)
    assert 0 < int((ref > 0).sum()) < ref.size


# ---------------------------------------------------------------------------
# frame filters
# ---------------------------------------------------------------------------

FILTERS = ["filter-fwhm=50%", "filter-fwhm=3k", "filter-fwhm=median",
           "filter-round=75%", "filter-round=median", "filter-wfwhm=2k",
           "filter-nbstars=50%", "filter-bkg=3k", "filter-quality=75%",
           "filter-incl"]


def _filter_seqs(rng):
    """Both packages' sequences of N frames with regdata, frame 2
    excluded and frame 5 without regdata."""
    seqs = []
    for mod in (JSequence, Sequence):
        seq = mod.__new__(mod)
        mod.__init__(seq, "x")
        seq.number = N
        seq.incl = np.ones(N, bool)
        seq.incl[2] = False
        seqs.append(seq)
    vals = {c: rng.uniform(1, 5, N) for c in
            ("fwhm", "weighted_fwhm", "roundness", "quality",
             "background_lvl")}
    vals["number_of_stars"] = rng.integers(10, 90, N)
    for seq in seqs:
        r = seq.reg(0)
        for c, v in vals.items():
            getattr(r, c)[:] = v
        r.valid[:] = True
        r.valid[5] = False
    return seqs, vals


def _flag(word, vals):
    k, _, v = word.partition("=")
    if v == "median":
        attr = {"fwhm": "fwhm", "round": "roundness"}[k[len("filter-"):]]
        v = repr(float(np.median(vals[attr])))
    return k, (v or True)


@pytest.mark.parametrize("word", FILTERS)
def test_apply_filters_vs_jax(word):
    from siril_tpu.core import filtering as jf
    from siril_tpu_torch.core import filtering as tf

    (jseq, tseq), vals = _filter_seqs(np.random.default_rng(5))
    k, v = _flag(word, vals)
    jspec, tspec = jf.parse_filter_flag(k, v), tf.parse_filter_flag(k, v)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    want = jf.apply_filters(jseq, [jspec])
    np.testing.assert_array_equal(tf.apply_filters(tseq, [tspec]), want)
    assert 2 not in want
    assert tf.filter_specs({k: v, "filter-nope": "3", "norm": "add"}) == \
        [tspec]


@pytest.fixture(scope="module")
def registered(tmp_path_factory):
    """A 4-frame sequence the JAX package registered (its .seq holds
    each frame's FWHM, roundness, background and star count)."""
    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.io import seqfile as jsf
    from tests.test_torch_registration import _reg_seqs

    src = tmp_path_factory.mktemp("filters") / "src"
    src.mkdir()
    _reg_seqs(src, np.random.default_rng(44))
    js = JSession(cwd=str(src))
    js.prefs.sf_radius = 6
    COMMANDS["register"].fn(js, ["g_", "-noout", "-transf=shift",
                                 "-nostarlist"])
    reg = jsf.read_seqfile(str(src / "g_.seq")).reg(0)
    assert reg.valid.all() and len(set(reg.fwhm)) == 4
    return src, {"fwhm": reg.fwhm, "roundness": reg.roundness}


@pytest.mark.parametrize("command,word", [
    ("stack", "filter-fwhm=50%"), ("stack", "filter-round=3k"),
    ("stack", "filter-fwhm=median"), ("stack", "filter-incl"),
    ("seqapplyreg", "filter-fwhm=75%"), ("seqapplyreg", "filter-round=2k"),
    ("seqapplyreg", "filter-round=median")])
def test_cli_filters_vs_jax(registered, tmp_path, command, word):
    """``stack`` and ``seqapplyreg`` with a frame filter, through both
    packages' commands on copies of the registered sequence: the same
    frames kept, and the same result: the stack within 2e-6 (the same
    frames), the 16-bit r_ frames within one 16-bit step (warps held to
    2e-6 in tests/test_torch_interp.py round either way)."""
    import shutil

    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession

    src, vals = registered
    k, v = _flag(word, vals)
    flag = f"-{k}" if v is True else f"-{k}={v}"
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    if command == "stack":
        words = ["g_", "rej", "n", "-norm=addscale", flag, "-out=out"]
    else:
        words = ["g_", flag]
    COMMANDS[command].fn(JSession(cwd=str(tmp_path / "jax")), words)
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", command,
                  *words])
    if command == "stack":
        a = read_fits(str(tmp_path / "jax" / "out.fit"))
        b = read_fits(str(tmp_path / "port" / "out.fit"))
        assert a.keywords.stackcnt == b.keywords.stackcnt
        if v is not True:
            assert b.keywords.stackcnt < 4
        np.testing.assert_allclose(b.host(), a.host(), rtol=0, atol=2e-6)
        return
    names = {d: sorted(f for f in os.listdir(tmp_path / d)
                       if f.startswith("r_g_") and f.endswith(".fit"))
             for d in ("jax", "port")}
    assert names["port"] == names["jax"] and 0 < len(names["port"]) < 4
    for f in names["port"]:
        np.testing.assert_allclose(
            read_fits(str(tmp_path / "port" / f)).host(),
            read_fits(str(tmp_path / "jax" / f)).host(), rtol=0,
            atol=1 / 65535 + 1e-7)
    assert ts.sequence.number == len(names["port"])
