"""The port on a CUDA card (marked ``cuda``; each test skips without one).

These tests import neither JAX nor the JAX package, so they also run where
JAX is not installed, without the repository's conftest (which imports
JAX):

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the reject_stack kernel against its plain version on the same card
  tensors, for every mode (K1a-K1d) and with per-frame and per-pixel
  weights (K1e): rejection counts equal on ≥ 99.999 % of pixels,
  |Δmean| ≤ 2e-6 where they agree (chip_smoke.py holds the same
  comparison at the main path's sizes);
- a stack of 1000 frames runs every mode and matches the plain version;
  past the frames a tile of the column kernel holds in shared memory
  (1698, or 875 with a weighted mean) its tiles live in global scratch
  memory, bit-equal to the plain version;
- every mode on both of its paths (registers at N ≤ 32, for each column
  size NMAX = 8, 16, 24, 32; the column kernel above), unweighted and
  weighted, bit-equal to the plain version, with no winsorized or
  SIGMEDIAN loop stopped at its bound;
- the fused pipeline on the card against the same pipeline on the CPU:
  shifts within 0.01 px, interior max |Δ| ≤ 1e-3 and rejection totals
  within 0.5 % (the reasons of tests/test_torch_pipeline.py: float32 LM
  fits and exp/sin implementations differ between the devices);
- calibration with every master and cosmetic correction on the card
  against the CPU within 1e-6, and the gather warp, every interpolation,
  within 2e-6 (the sin of the lanczos weights differs between devices);
- the preprocessing script (chip_smoke.PREPROCESSING_SCRIPT on a small
  synthetic night) on the card against the CPU: the masters and pp_
  frames within one 16-bit step, H within 0.2 px at the corners and the
  results within 1e-4 on average (tests/test_torch_script.py's reasons);
- each rung of the FFT warp ladder on the card against the CPU: cuFFT and
  pocketfft round differently, so the tolerance of
  tests/test_torch_interp.py (2e-5 but where a clamp or mask decided
  otherwise, on at most 1e-3 of the pixels);
- fusedstack with a homography registration (field rotation and a
  meridian flip) on the card against the CPU: the same rung, H within
  0.01 px at the corners, the interior within 1e-4 but on 0.05 % of the
  pixels (a rejection flipped by LM fits that differ between devices),
  at most 5e-3 there;
- a feathered, overlap-normalized mosaic stack (K1e with per-pixel
  weights) and ``max -maximize`` on the card against the CPU: within
  2e-6 and equal;
- every demosaic method (and X-Trans) on the card against the CPU within
  1e-6 (the same eager float32 operations; chip_smoke.py measured 0 on a
  1024² crop), and ``calibrate -cfa -equalize_cfa -debayer`` over a
  small CFA sequence on the card against the CPU within one 16-bit step;
- drizzle, every kernel, mono and CFA, per frame and by chunks of 16-bit
  frames, on the card against the CPU within 2e-6 (another sin / exp and
  a division by a scalar through its reciprocal on the card), the point
  kernel's weights equal; ``stack -drizzle``, ``seqapplyreg -drizzle
  -flat=`` and ``stack -upscale`` through the CLI on the card against the
  CPU (the upscale within one 16-bit step: its frames are written at 16
  bits); the stacks of a SER video and of a FITS cube on the card
  against the CPU within 2e-6 (the resident and streamed paths of the
  stack tests above);
- the SIP warp of ``-disto`` (forward and inverted) on the card against
  the CPU within the gather warp's 2e-6, equal to the gather warp with no
  SIP term; a plate solve with its stars detected on the card against
  the CPU: the same matched count, CRVAL within 1e-6°, CD within 1e-6
  relative;
- every device op of the enhancement session (chip_smoke.enhance_ops)
  on the card against the CPU within its bound (0 for the selections and
  the float64 arithmetic, 1e-6 for the convolutions — which TF32-rounded
  inputs miss — and pointwise ops, 1e-5 for the FFT ops); NL-Bayes and
  DA3D by their effect (the error against a clean scene within 5 %, the
  mean |Δ| within 5e-3; DA3D on one guide within 1e-5 on average), and
  NL-Bayes refusing TF32 matmuls; the ℓ0 blind engine's kernel (cosine ≥
  0.99);
  chip_smoke.ENHANCE_SCRIPT through the CLI on both devices;
- every device op of the analysis session on the card against the CPU:
  the 24-neighbour median, its masks and the correction of find_cosme
  (mono and CFA), the Hough vote, the histogram, the medians and IKSS
  location equal; the float64 sums within 1e-12; the painting of
  synthstar within 1e-6 and ssr's star mask equal; the ICC curves in
  float64 within 1e-12; the profile within 1e-6; and
  chip_smoke.ANALYSIS_SCRIPT through the CLI on both devices (a 512²
  session): the corrected frames, the statistics file, the histogram,
  the trail's CSV and find_hot's list equal, the ICC-converted and
  inspector images within a 16-bit step, the light curve within the
  error it reports (its LM fits run in float32 on each device);
- the planetary device ops on the card against the CPU: the frame
  quality within 1e-5 relative, the phase correlation within 1e-3 px,
  MultiLevelCorrelation on the same windows with the same integer shifts
  and successes and sub-pixel shifts within 1e-3 px, the SER store's
  decode equal; and the native raw decoders (LJPEG, Nikon, Panasonic)
  bit-equal to their Python versions on the card machine's compiler;
- each stage of the compute probe's iteration on the card against the
  CPU (the frames within 2e-6, statistics and estimators within 1e-5
  relative, the stack's counts equal and its mean within 2e-6); the pipe,
  ``pyscript`` and ``precompile`` on a card session, under a
  ``torch.profiler`` trace that names the K1 kernel.
"""

import numpy as np
import pytest
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.io.fits_io import write_fits
from siril_tpu_torch.kernels import reject_stack as k1
from siril_tpu_torch.ops.demosaic import METHOD_NAMES
from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops.normalization import (
    ADDITIVE_SCALING,
    MULTIPLICATIVE,
    NO_NORM,
)
from siril_tpu_torch.ops.stacking import reject_stack_plain
from siril_tpu_torch.pipeline import FusedArgs, fused_preprocess_stack
from siril_tpu_torch.registration.starfinder import StarFinderParams

WINDOW = [(rj.NO_REJEC, 3.0, 3.0), (rj.PERCENTILE, 0.2, 0.1),
          (rj.SIGMA, 3.0, 3.0), (rj.MAD, 3.0, 3.0),
          (rj.WINSORIZED, 3.0, 3.0)]
MASKED = [(rj.SIGMEDIAN, 3.0, 3.0), (rj.LINEARFIT, 3.0, 3.0),
          (rj.GESDT, 0.3, 0.05)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _mkstack(rng, n, p):
    base = 0.2 + 0.5 * rng.random(p).astype(np.float32)
    stack = base[None, :] + rng.normal(0, 0.02, (n, p)).astype(np.float32)
    idx = rng.integers(0, p, p // 6)
    stack[rng.integers(0, n, p // 6), idx] = 0.95
    stack[rng.random((n, p)) < 0.05] = 0.0
    return np.clip(stack, 0.0, 1.0).astype(np.float32)


def _gesdt_kw(rtype, n, sl, mo=None):
    """GESDT's λ table and budget: by default the budget a user's outlier
    fraction ``sl`` gives (300 at 1000 frames and 0.3)."""
    if rtype != rj.GESDT:
        return {}
    if mo is None:
        mo = rj.gesdt_max_outliers(n, sl)
    return dict(max_outliers=mo,
                critical=rj.gesdt_critical_values(n, 0.05, mo))


def _agree(got, ref, p):
    agree = (got[1] == ref[1]) & (got[2] == ref[2])
    assert int((~agree).sum()) <= 1e-5 * p
    assert float((got[0] - ref[0]).abs()[agree].max()) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rtype,sl,sh", WINDOW + MASKED)
def test_kernel_vs_plain_on_card(rtype, sl, sh):
    _need_card()
    rng = np.random.default_rng(5)
    n, p = 24, 1 << 16
    f32 = torch.from_numpy(_mkstack(rng, n, p)).cuda()
    i16 = (torch.round(f32 * 65535.0) - 32768.0).to(torch.int16)
    coef = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        1.0 + 0.05 * rng.standard_normal(n), 0.01 * rng.standard_normal(n),
        1.0 + 0.03 * rng.standard_normal(n))]
    kw = dict(rtype=rtype, siglow=sl, sighigh=sh, **_gesdt_kw(rtype, n, sl))
    for stack in (f32, i16):
        for mode in (NO_NORM, ADDITIVE_SCALING, MULTIPLICATIVE):
            before = sum(k1.launches.values())
            got = k1.reject_mean(stack, *coef, mode=mode, **kw)
            assert sum(k1.launches.values()) == before + 1
            ref = reject_stack_plain(stack, *coef, mode=mode, **kw)
            _agree(got, ref, p)


@pytest.mark.cuda
@pytest.mark.parametrize("rtype,sl,sh", [(rj.WINSORIZED, 3.0, 3.0),
                                         (rj.SIGMA, 3.0, 3.0)] + MASKED)
def test_kernel_weights_vs_plain_on_card(rtype, sl, sh):
    """K1e: per-frame weights (pixel stride 0) and per-pixel weights."""
    _need_card()
    rng = np.random.default_rng(6)
    n, p = 24, 1 << 15
    stack = torch.from_numpy(_mkstack(rng, n, p)).cuda()
    coef = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        1.0 + 0.05 * rng.standard_normal(n), 0.01 * rng.standard_normal(n),
        np.ones(n))]
    kw = dict(rtype=rtype, mode=ADDITIVE_SCALING, siglow=sl, sighigh=sh,
              **_gesdt_kw(rtype, n, sl))
    for w in (0.5 + rng.random((n, 1)), 0.5 + rng.random((n, p))):
        w = torch.from_numpy(w.astype(np.float32)).cuda()
        got = k1.reject_mean(stack, *coef, weights=w, **kw)
        ref = reject_stack_plain(stack, *coef, weights=w, **kw)
        _agree(got, ref, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 8, 12, 16, 24, 32, 33, 48, 64, 100, 300])
def test_kernel_paths_bit_equal_on_card(n):
    _need_card()
    rng = np.random.default_rng(100 + n)
    p = 1 << 14
    f32 = torch.from_numpy(_mkstack(rng, n, p)).cuda()
    i16 = (torch.round(f32 * 65535.0) - 32768.0).to(torch.int16)
    coef = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        1.0 + 0.05 * rng.standard_normal(n), 0.01 * rng.standard_normal(n),
        np.ones(n))]
    wf = torch.from_numpy((0.5 + rng.random((n, 1))).astype(np.float32))
    for rtype, sl, sh in WINDOW + MASKED:
        for stack in (f32, i16):
            for w in (None, wf.cuda()):
                kw = dict(rtype=rtype, mode=ADDITIVE_SCALING, siglow=sl,
                          sighigh=sh, weights=w, **_gesdt_kw(rtype, n, sl))
                k1.reset_counts()
                got = k1.reject_mean(stack, *coef, **kw)
                capped = torch.zeros((), dtype=torch.int64, device="cuda")
                ref = reject_stack_plain(stack, *coef, capped=capped, **kw)
                assert torch.equal(got[0], ref[0])
                assert torch.equal(got[1], ref[1])
                assert torch.equal(got[2], ref[2])
                assert k1.capped_pixels() == int(capped) == 0


@pytest.mark.cuda
def test_kernel_frame_limit():
    """1000 frames, every mode: the column kernel's 16-column tiles."""
    _need_card()
    rng = np.random.default_rng(8)
    n, p = 1000, 4096
    st = torch.from_numpy(_mkstack(rng, n, p)).cuda()
    one = torch.ones(n, device="cuda")
    for rtype, sl, sh in WINDOW + MASKED:
        kw = dict(rtype=rtype, mode=NO_NORM, siglow=sl, sighigh=sh,
                  **_gesdt_kw(rtype, n, sl))
        got = k1.reject_mean(st, one, one * 0, one, **kw)
        ref = reject_stack_plain(st, one, one * 0, one, **kw)
        _agree(got, ref, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,weighted", [(1800, False), (1000, True)])
def test_kernel_global_layout(n, weighted):
    """Past the frames a 32-column tile holds in shared memory (1698, or
    875 with a weighted mean) the tiles live in global scratch memory:
    bit-equal to the plain version, several tiles a block."""
    _need_card()
    rng = np.random.default_rng(9 + n)
    p = 1000
    x = _mkstack(rng, n, p)
    x[:, 8:][x[:, 8:] == 0] = 0.4    # GESDT's budget not spent on zeros
    st = torch.from_numpy(x).cuda()
    coef = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        1.0 + 0.05 * rng.standard_normal(n), 0.01 * rng.standard_normal(n),
        np.ones(n))]
    w = torch.from_numpy((0.5 + rng.random((n, 1))).astype(np.float32))
    w = w.cuda() if weighted else None
    assert k1._library().siril_reject_stack_needs_scratch(n, rj.WINSORIZED,
                                                         int(weighted))
    for rtype, sl, sh in ((rj.WINSORIZED, 3.0, 3.0), (rj.MAD, 3.0, 3.0),
                          (rj.SIGMEDIAN, 3.0, 3.0), (rj.LINEARFIT, 3.0, 3.0),
                          (rj.GESDT, 0.3, 0.05)):
        kw = dict(rtype=rtype, mode=ADDITIVE_SCALING, siglow=sl, sighigh=sh,
                  weights=w, **_gesdt_kw(rtype, n, sl, mo=12))
        got = k1.reject_mean(st, *coef, **kw)
        ref = reject_stack_plain(st, *coef, **kw)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(got[1].sum() + got[2].sum()) > 0


def _write_sequence(d, rng, shifts, h=160, w=192):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.05 + rng.normal(0, 0.002, (h, w)).astype(np.float32)
    for _ in range(16):
        x0 = rng.uniform(30, w - 30)
        y0 = rng.uniform(30, h - 30)
        base += 0.5 * np.exp(-(((xx + 0.5 - x0) ** 2 +
                                (yy + 0.5 - y0) ** 2) / (2 * 2.0 ** 2)))
    base = np.clip(base, 0, 1)
    for i, (dx, dy) in enumerate(shifts):
        f = np.roll(np.roll(base, dy, 0), dx, 1) \
            + rng.normal(0, 0.002, (h, w)).astype(np.float32)
        f[rng.integers(0, h, 30), rng.integers(0, w, 30)] = 0.95
        img = SirilImage(data=np.clip(f, 1e-4, 1)[None].astype(np.float32))
        img.keywords.exposure = 10.0
        write_fits(img, str(d / f"fl_{i:05d}.fit"), bitdepth=16)
    return base


@pytest.mark.cuda
def test_fused_on_card_vs_cpu(tmp_path):
    _need_card()
    base = _write_sequence(tmp_path, np.random.default_rng(3),
                           [(0, 0), (4, 2), (-3, 5), (6, -4), (2, 2)])
    args = FusedArgs(starfinder=StarFinderParams(radius=6))
    args.stack.normalize = ADDITIVE_SCALING
    runs = {}
    for dev in ("cpu", "cuda"):
        seq = Sequence.scan("fl_", str(tmp_path))
        before = sum(k1.launches.values())
        res = fused_preprocess_stack(seq, args, device=dev)
        runs[dev] = (seq, res, sum(k1.launches.values()) - before)
    (cseq, cres, claunch), (gseq, gres, glaunch) = runs["cpu"], runs["cuda"]
    assert claunch == 0 and glaunch == 1
    np.testing.assert_allclose(gseq.reg(0).H[:, :2, 2],
                               cseq.reg(0).H[:, :2, 2], atol=0.01)
    inner = np.s_[20:-20, 20:-20]
    a, b = cres.image.host()[0], gres.image.host()[0]
    assert np.abs(a[inner] - b[inner]).max() <= 1e-3
    for r, g in zip(cres.total_rejected, gres.total_rejected):
        assert abs(r - g) <= 0.005 * r
    assert np.abs(b[inner] - base[inner]).mean() < 0.01


@pytest.mark.cuda
def test_calibration_on_card_vs_cpu():
    _need_card()
    from siril_tpu_torch.ops.calibration import CalibArgs, calibrate_image

    rng = np.random.default_rng(81)
    h, w = 96, 128

    def img(a):
        return SirilImage(data=np.asarray(a, np.float32))

    dark = 0.02 + rng.normal(0, 0.002, (1, h, w))
    dark[0, rng.integers(0, h, 30), rng.integers(0, w, 30)] = 0.4
    dark[0, rng.integers(0, h, 10), rng.integers(0, w, 10)] = 0.0005
    ca = CalibArgs(bias=img(0.03 + rng.normal(0, 0.001, (1, h, w))),
                   dark=img(dark), flat=img(0.5 + 0.1 * rng.random((1, h, w))),
                   sig_cold=2.0)
    raw = img(np.clip(0.1 + dark + rng.normal(0, 0.01, (1, h, w)), 0, 1))
    for cfa in (False, True):
        ca.is_cfa = ca.equalize_cfa = cfa
        a = calibrate_image(raw, ca, device="cpu").host()
        b = calibrate_image(raw, ca, device="cuda").host()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("method", range(6))
def test_gather_warp_on_card_vs_cpu(method):
    _need_card()
    from siril_tpu_torch.ops.interp import warp_homography

    rng = np.random.default_rng(82)
    img = torch.from_numpy((0.1 + rng.random((1, 300, 260)) ** 4).astype(
        np.float32))
    th = np.deg2rad(1.5)
    H = np.array([[1.01 * np.cos(th), -1.01 * np.sin(th), 5.3],
                  [1.01 * np.sin(th), 1.01 * np.cos(th), -3.1],
                  [2e-5, -1e-5, 1.0]])
    for clamp in (True, False):
        a = warp_homography(img, H, (310, 270), method, clamp).numpy()
        b = warp_homography(img.cuda(), H, (310, 270), method,
                            clamp).cpu().numpy()
        np.testing.assert_array_equal(a == 0, b == 0)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_script_on_card_vs_cpu(tmp_path):
    _need_card()
    import os
    import shutil

    import chip_smoke
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.cli.parser import execute_script
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.io.seqfile import read_seqfile

    src = str(tmp_path / "src")
    chip_smoke.synth_session(src, 9, 256, lights=12, calib=4, nstars=300,
                             gain=6.0)
    with open(os.path.join(src, "script.ssf"), "w") as f:
        f.write(chip_smoke.PREPROCESSING_SCRIPT.format(stack_flags=""))
    runs = {}
    for dev in ("cpu", "cuda"):
        d = str(tmp_path / dev)
        shutil.copytree(src, d)
        before = sum(k1.launches.values())
        assert execute_script(Session(cwd=d, device=dev),
                              os.path.join(d, "script.ssf")) == 0
        runs[dev] = (d, sum(k1.launches.values()) - before)
    (cdir, claunch), (gdir, glaunch) = runs["cpu"], runs["cuda"]
    assert claunch == 0 and glaunch == 4          # the four stacks
    step = 1.0 / 65535 + 1e-7
    for n in (["bias_stacked", "pp_dark_stacked", "pp_flat_stacked"]
              + [f"pp_light_{k:05d}" for k in range(1, 13)]):
        a = read_fits(os.path.join(cdir, "process", n + ".fit")).host()
        b = read_fits(os.path.join(gdir, "process", n + ".fit")).host()
        np.testing.assert_allclose(b, a, rtol=0, atol=step, err_msg=n)
    cs = read_seqfile(os.path.join(cdir, "process", "pp_light_.seq"))
    gs = read_seqfile(os.path.join(gdir, "process", "pp_light_.seq"))
    c = np.array([[0, 0, 1], [256, 0, 1], [0, 256, 1], [256, 256, 1.0]])
    for k in range(12):
        qa, qb = c @ cs.reg(0).H[k].T, c @ gs.reg(0).H[k].T
        assert np.abs(qa[:, :2] / qa[:, 2:] - qb[:, :2] / qb[:, 2:]).max() \
            < 0.2
    a = read_fits(os.path.join(cdir, "process", "result.fit")).host()[0]
    b = read_fits(os.path.join(gdir, "process", "result.fit")).host()[0]
    inner = np.s_[16:-16, 16:-16]
    assert np.abs(a[inner] - b[inner]).mean() < 1e-4


def _stars(rng, n, h, w, nstars=12):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((n, 1, h, w), 0.05, np.float32)
    for k in range(n):
        for _ in range(nstars):
            x0, y0 = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
            out[k, 0] += 0.5 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                      / (2 * 1.5 ** 2))
        out[k, 0] += rng.normal(0, 0.01, (h, w)).astype(np.float32)
    return out


def _similar(*params, size=(200, 240)):
    from chip_smoke import similar_map

    return similar_map(*params, size=size)


LADDER = {
    "rotation": ("rotations_from_Hs", "warp_rotation_batch",
                 [(1, 0, 0, 0), (1, 0.6, 2.3, -1.2), (1, 179.6, -1.5, 2.2)]),
    "affine": ("affines_from_Hs", "warp_affine_batch",
               [(1, 0, 0, 0), (1.01, 0.6, 2.3, -1.2),
                (0.99, 179.6, -1.5, 2.2)]),
    "perspective": ("perspective_split_from_Hs", "warp_perspective_batch",
                    [(1, 0, 0, 0), (1.004, 0.5, 2, -1, 1e-4, -0.6e-4),
                     (0.997, 179.3, -2, 2, -0.7e-4, 0.5e-4)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rung", sorted(LADDER))
def test_ladder_rung_on_card_vs_cpu(rung):
    _need_card()
    from siril_tpu_torch.ops import interp

    gate, warp, params = LADDER[rung]
    size = (200, 240)
    frames = torch.from_numpy(_stars(np.random.default_rng(83), 3, *size))
    prm = getattr(interp, gate)(np.stack([_similar(*p) for p in params]),
                                size)
    assert prm is not None
    for clamp in (True, False):
        a = getattr(interp, warp)(frames, prm, clamp=clamp).numpy()
        b = getattr(interp, warp)(frames.cuda(), prm,
                                  clamp=clamp).cpu().numpy()
        far = np.abs(a - b) > 2e-5
        assert far.sum() <= 1e-3 * a.size
        assert np.abs(a - b)[~far].max() <= 2e-5
        assert ((a == 0) != (b == 0)).sum() <= 1e-3 * a.size


@pytest.mark.cuda
def test_fused_homography_on_card_vs_cpu(tmp_path):
    """A field-rotated session with a meridian flip (frames 3 and 4
    turned by 180°): the rotation rung on both devices."""
    _need_card()
    from siril_tpu_torch.ops import interp
    from siril_tpu_torch.registration.matching import (
        HOMOGRAPHY_TRANSFORMATION,
    )

    h, w = 160, 192
    rng = np.random.default_rng(84)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    stars = [(rng.uniform(30, w - 30), rng.uniform(30, h - 30))
             for _ in range(24)]
    maps = [_similar(1, th, tx, ty, size=(h, w)) for th, tx, ty in
            ((0, 0, 0), (0.6, 2, -1), (180.4, -2, 2), (179.5, 1, 1),
             (-0.5, 3, -2))]
    for i, Hm in enumerate(maps):
        img = np.full((h, w), 0.05, np.float32)
        for x0, y0 in stars:
            v = Hm @ [x0, y0, 1.0]
            img += 0.5 * np.exp(-(((xx - v[0]) ** 2 + (yy - v[1]) ** 2)
                                  / (2 * 2.0 ** 2)))
        img += rng.normal(0, 0.002, (h, w)).astype(np.float32)
        si = SirilImage(data=np.clip(img, 1e-4, 1)[None].astype(np.float32))
        si.keywords.exposure = 10.0
        write_fits(si, str(tmp_path / f"rot_{i:05d}.fit"), bitdepth=16)
    args = FusedArgs(ttype=HOMOGRAPHY_TRANSFORMATION,
                     starfinder=StarFinderParams(radius=6))
    args.stack.normalize = ADDITIVE_SCALING
    runs = {}
    real = interp.warp_rotation_batch
    for dev in ("cpu", "cuda"):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(interp, "warp_rotation_batch",
                       lambda *a, **k: calls.append(1) or real(*a, **k))
            seq = Sequence.scan("rot_", str(tmp_path))
            res = fused_preprocess_stack(seq, args, device=dev)
        assert calls
        runs[dev] = (seq, res)
    (cseq, cres), (gseq, gres) = runs["cpu"], runs["cuda"]
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                  [w - 1, h - 1, 1.0]])
    qa = np.einsum("nij,cj->nci", cseq.reg(0).H, c)
    qb = np.einsum("nij,cj->nci", gseq.reg(0).H, c)
    assert np.abs(qa[..., :2] / qa[..., 2:]
                  - qb[..., :2] / qb[..., 2:]).max() < 0.01
    inner = np.s_[20:-20, 20:-20]
    a, b = cres.image.host()[0][inner], gres.image.host()[0][inner]
    d = np.abs(a - b)
    assert (d > 1e-4).sum() <= 5e-4 * d.size
    assert d.max() <= 5e-3
    for r, g in zip(cres.total_rejected, gres.total_rejected):
        assert abs(r - g) <= 0.005 * r


@pytest.mark.cuda
def test_mosaic_stack_on_card_vs_cpu(tmp_path):
    """stack rej -norm=addscale -overlap_norm -feather= (K1e with
    per-pixel weights) and max -maximize on 4 shifted tiles."""
    _need_card()
    from siril_tpu_torch.ops.stacking import StackArgs, stack_sequence

    rng = np.random.default_rng(85)
    sky = _stars(rng, 1, 120, 150, nstars=30)[0, 0]
    th, tw = 72, 90
    tiles = [(0, 0), (60, 0), (0, 48), (60, 48)]
    for i, (x0, y0) in enumerate(tiles):
        f = 0.02 * i + (1.0 - 0.03 * i) * sky[y0:y0 + th, x0:x0 + tw]
        si = SirilImage(data=np.clip(f, 0, 1)[None].astype(np.float32))
        write_fits(si, str(tmp_path / f"mos_{i + 1:05d}.fit"), bitdepth=-32)
    runs = {}
    for dev in ("cpu", "cuda"):
        seq = Sequence.scan("mos_", str(tmp_path))
        seq.reg(0).H[:, :2, 2] = tiles
        seq.reg(0).valid[:] = True
        k1.reset_counts()
        rej = stack_sequence(seq, StackArgs(normalize=ADDITIVE_SCALING,
                                            overlap_norm=True,
                                            feather_dist=12), device=dev)
        launches = dict(k1.launches)
        mx = stack_sequence(seq, StackArgs(method="max", maximize=True),
                            device=dev)
        runs[dev] = (rej, mx, launches)
    (crej, cmax, cl), (grej, gmax, gl) = runs["cpu"], runs["cuda"]
    assert sum(cl.values()) == 0 and gl["K1e"] == 1
    np.testing.assert_allclose(grej.image.host(), crej.image.host(), rtol=0,
                               atol=2e-6)
    for r, g in zip(crej.total_rejected, grej.total_rejected):
        assert abs(r - g) <= 1e-5 * th * tw + 1
    assert gmax.image.host().shape == (1, 120, 150)
    np.testing.assert_array_equal(gmax.image.host(), cmax.image.host())


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHOD_NAMES)
def test_debayer_on_card_vs_cpu(method):
    _need_card()
    from siril_tpu_torch.ops import demosaic as dm
    from siril_tpu_torch.ops.xtrans import XTRANS_PATTERNS

    rng = np.random.default_rng(91)
    cfa = torch.from_numpy((0.05 + 0.9 * rng.random((210, 246)) ** 3
                            ).astype(np.float32))
    for pat, xo, yo in (("GRBG", 1, 0), ("BGGR", 0, 1)):
        if method == "xtrans":
            pat = XTRANS_PATTERNS[xo]
        mid = dm.METHOD_NAMES[method]
        a = dm.debayer(cfa, pat, mid, xo, yo).numpy()
        b = dm.debayer(cfa.cuda(), pat, mid, xo, yo).cpu().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_calibrate_debayer_on_card_vs_cpu(tmp_path):
    _need_card()
    import os

    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.calibration import CalibArgs, calibrate_sequence

    rng = np.random.default_rng(92)
    h, w = 96, 128
    dark = 0.02 + rng.normal(0, 0.002, (1, h, w))
    dark[0, rng.integers(0, h, 20), rng.integers(0, w, 20)] = 0.4
    ca = CalibArgs(dark=SirilImage(data=dark.astype(np.float32)),
                   flat=SirilImage(data=(0.5 + 0.1 * rng.random((1, h, w))
                                         ).astype(np.float32)),
                   is_cfa=True, equalize_cfa=True, debayer=True)
    for dev in ("cpu", "cuda"):
        os.makedirs(tmp_path / dev)
    for i in range(3):
        img = SirilImage(data=np.clip(0.1 + dark + rng.normal(
            0, 0.01, (1, h, w)), 0, 1).astype(np.float32), orig_bitdepth=20)
        img.keywords.bayer_pattern = "RGGB"
        for dev in ("cpu", "cuda"):
            write_fits(img, str(tmp_path / dev / f"c_{i + 1:05d}.fit"))
    for dev in ("cpu", "cuda"):
        res = calibrate_sequence(Sequence.scan("c_", str(tmp_path / dev)),
                                 ca, device=dev)
        assert res.processed == 3
    for i in range(3):
        a, b = (read_fits(str(tmp_path / dev / f"pp_c_{i + 1:05d}.fit"))
                for dev in ("cpu", "cuda"))
        assert a.nchans == b.nchans == 3
        np.testing.assert_allclose(b.host(), a.host(), rtol=0,
                                   atol=1.0 / 65535 + 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", range(6))
def test_drizzle_on_card_vs_cpu(kernel):
    _need_card()
    from siril_tpu_torch.ops import drizzle as td

    rng = np.random.default_rng(93 + kernel)
    h, w = 40, 52
    t = np.deg2rad(1.1)
    Hs = np.stack([np.eye(3), np.array([[1, 0, 0.4], [0, 1, -0.6], [0, 0, 1]]),
                   np.array([[np.cos(t), -np.sin(t), 1.3],
                             [np.sin(t), np.cos(t), -0.2], [0, 0, 1]])])
    raw = rng.integers(-30000, 30000, (3, 1, h, w)).astype(np.int16)
    wp = rng.uniform(0.8, 1.2, (h, w)).astype(np.float32)
    for cfa in (False, True):
        outs = []
        for dev in ("cpu", "cuda"):
            args = td.DrizzleArgs(scale=2.0, pixfrac=0.8, kernel=kernel,
                                  use_bayer=cfa)
            acc = td.DrizzleAccumulator((3 if cfa else 1, 2 * h, 2 * w),
                                        args, dev)
            img = SirilImage(data=((raw[0].astype(np.float32) + 32768.0)
                                   / 65535.0).astype(np.float32))
            if cfa:
                img.keywords.bayer_pattern = "GRBG"
            acc.add_frame(img, Hs[2], weight_plane=wp)
            acc.add_frames(torch.from_numpy(raw).to(dev), Hs,
                           weights=[1.0, 0.7, 1.3], weight_plane=wp,
                           pattern="GRBG" if cfa else None)
            outs.append([x.host() for x in acc.finalize()])
        (a, aw), (b, bw) = outs
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
        np.testing.assert_allclose(bw, aw, rtol=0, atol=2e-6)
        if kernel == td.KERNEL_POINT:
            np.testing.assert_array_equal(bw > 0, aw > 0)


@pytest.mark.cuda
def test_drizzle_commands_on_card_vs_cpu(tmp_path):
    _need_card()
    import os
    import shutil

    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits

    rng = np.random.default_rng(94)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        img = SirilImage(data=rng.uniform(0.1, 0.6, (1, 48, 64)).astype(
            np.float32), orig_bitdepth=20)
        img.keywords.bayer_pattern = "RGGB"
        write_fits(img, str(src / f"d_{i + 1:05d}.fit"))
    write_fits(SirilImage(data=rng.uniform(0.5, 1.0, (1, 48, 64)).astype(
        np.float32)), str(src / "flat.fit"), bitdepth=-32)
    seq = Sequence.scan("d_", str(src))
    for k in range(4):
        seq.reg(0).H[k][:2, 2] = (0.35 * k, -0.6 * k + 1)
        seq.reg(0).valid[k] = True
    seq.save()
    for dev in ("cpu", "cuda"):
        shutil.copytree(src, tmp_path / dev)
        d = str(tmp_path / dev)
        for words in (["stack", "d_", "-drizzle", "-scale=2",
                       "-pixfrac=0.9", "-out=drz"],
                      ["seqapplyreg", "d_", "-drizzle", "-scale=1",
                       "-flat=flat"],
                      ["stack", "d_", "rej", "s", "3", "3", "-upscale",
                       "-out=up"]):
            cli.run(["-d", d, "--device", dev, *words])
    for name, tol in (("drz.fit", 2e-6), ("r_d_00003.fit", 2e-6),
                      ("up.fit", 1.0 / 65535 + 1e-6)):
        a, b = (read_fits(os.path.join(tmp_path, dev, name)).host()
                for dev in ("cpu", "cuda"))
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["ser", "fitseq"])
def test_video_and_cube_stack_on_card_vs_cpu(tmp_path, output):
    _need_card()
    from siril_tpu_torch.io.conversion import convert_to_sequence
    from siril_tpu_torch.ops.stacking import StackArgs, stack_sequence

    rng = np.random.default_rng(95)
    files = []
    for i in range(6):
        p = str(tmp_path / f"IMG{i}.fit")
        write_fits(SirilImage(data=(0.2 + 0.3 * rng.random((1, 64, 80))
                                    ).astype(np.float32)), p, bitdepth=20)
        files.append(p)
    seq = convert_to_sequence(files, "v", str(tmp_path / "out"),
                              output=output)
    res = [stack_sequence(seq, StackArgs(method="rej", rejection=rj.SIGMA,
                                         normalize=ADDITIVE_SCALING),
                          device=dev) for dev in ("cpu", "cuda")]
    np.testing.assert_allclose(res[1].image.host(), res[0].image.host(),
                               rtol=0, atol=2e-6)
    assert res[1].total_rejected == res[0].total_rejected


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 3])
def test_sip_warp_on_card_vs_cpu(method):
    """The SIP warp of ``-disto`` (forward and inverted) on the card
    against the CPU, within the gather warp's 2e-6; with no SIP term equal
    to the gather warp on the card."""
    _need_card()
    from siril_tpu_torch.ops.interp import (
        warp_homography,
        warp_homography_sip,
    )
    from siril_tpu_torch.ops.wcs import sip_frame

    rng = np.random.default_rng(86)
    img = torch.from_numpy((0.1 + rng.random((1, 300, 260)) ** 4).astype(
        np.float32))
    H = np.array([[1.002, 0.003, 5.3], [-0.002, 0.998, -3.1],
                  [0, 0, 1.0]])
    A = np.zeros((4, 4))
    B = np.zeros((4, 4))
    A[2, 0], A[0, 2], A[3, 0], A[1, 2] = 6e-5, -6e-5, 1e-7, -1.8e-7
    B[2, 0], B[0, 2], B[1, 1] = 8e-5, -8e-5, 5e-5
    frame = sip_frame((130.5, 150.5), 300)
    for invert in (True, False):
        a = warp_homography_sip(img, H, A, B, frame, (300, 260), method,
                                True, invert=invert).numpy()
        b = warp_homography_sip(img.cuda(), H, A, B, frame, (300, 260),
                                method, True, invert=invert).cpu().numpy()
        np.testing.assert_array_equal(a == 0, b == 0)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
    z = np.zeros((4, 4))
    assert torch.equal(
        warp_homography_sip(img.cuda(), H, z, z, frame, (300, 260), method),
        warp_homography(img.cuda(), H, (300, 260), method))


@pytest.mark.cuda
def test_platesolve_on_card_vs_cpu():
    """solve_image with its stars detected on the card against the CPU:
    the same matched count, CRVAL within 1e-6° and CD within 1e-6
    relative (LM fits on the two devices differ in float32)."""
    _need_card()
    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.solver import SolveArgs, solve_image
    from siril_tpu_torch.ops.wcs import WCS

    rng = np.random.default_rng(87)
    h = w = 512
    s = 2.0 / 3600.0
    th = np.radians(12.0)
    true = WCS(crpix=(w / 2 + 0.5, h / 2 + 0.5), crval=(150.0, 40.0),
               cd=np.array([[-s * np.cos(th), s * np.sin(th)],
                            [s * np.sin(th), s * np.cos(th)]]), height=h)
    ox = rng.uniform(-0.3 * w, 1.3 * w, 700)
    oy = rng.uniform(-0.3 * h, 1.3 * h, 700)
    ra, dec = true.pix2world(ox, oy)
    mag = rng.uniform(7, 12, 700)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.05 + rng.normal(0, 0.002, (h, w))
    for x0, y0, m in zip(ox, oy, mag):
        if -5 < x0 < w + 5 and -5 < y0 < h + 5:
            img += min(0.6 * 10 ** (-0.4 * (m - 7.0)), 0.8) * np.exp(
                -((xx + 0.5 - x0) ** 2 + (yy + 0.5 - y0) ** 2)
                / (2 * 1.5 ** 2))
    img = np.clip(img, 0, 1).astype(np.float32)[None]
    cat = Catalog(ra=np.asarray(ra), dec=np.asarray(dec), mag=mag)
    res = {dev: solve_image(SirilImage(data=img), cat, SolveArgs(
        ra=150.2, dec=39.85, pixel_scale=2.05, mag_limit=13.0), device=dev)
        for dev in ("cpu", "cuda")}
    assert res["cuda"].n_matched == res["cpu"].n_matched >= 20
    np.testing.assert_allclose(res["cuda"].wcs.crval, res["cpu"].wcs.crval,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["cuda"].wcs.cd, res["cpu"].wcs.cd,
                               rtol=0, atol=1e-6 * s)


def _post_image(seed, size=192):
    """A small stacked RGB field: a sky gradient, noise and stars."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.empty((3, size, size), np.float32)
    for c in range(3):
        f = 0.1 + 0.02 * (xx / size) ** 2 + rng.normal(0, 0.003, (size, size))
        for _ in range(25):
            x0, y0 = rng.uniform(8, size - 8, 2)
            f += rng.uniform(0.05, 0.6) * np.exp(
                -((xx - x0) ** 2 + (yy - y0) ** 2) / 4.5)
        d[c] = np.clip(f, 0, 1)
    return d


@pytest.mark.cuda
def test_post_ops_on_card_vs_cpu():
    """Every device op of the post-stack session (chip_smoke.post_ops: the
    stretches, the GHT family in every colour model, the colour ops, the
    binning and the pcc / spcc apply) and the image entry points (with
    the rotation, without its clamp) on the card against the CPU, within
    the CPU tests' bounds against the JAX package (2e-6, 1e-5, 1.2e-7, or
    equal)."""
    _need_card()
    import chip_smoke
    from siril_tpu_torch.ops import colors as col
    from siril_tpu_torch.ops import geometry as geo
    from siril_tpu_torch.ops import stretch as st

    d = _post_image(88)
    x = torch.from_numpy(d)
    for label, fn, bound in chip_smoke.post_ops():
        a = fn(x).numpy()
        b = fn(x.cuda()).cpu().numpy()
        assert float(np.max(np.abs(a.astype(np.float64) - b))) <= bound, \
            label
    img = SirilImage(data=d)
    for fn, bound in ((lambda dev: st.autostretch(img, device=dev), 2e-6),
                      (lambda dev: col.saturation(img, 0.5, 1.0,
                                                  device=dev), 1e-5),
                      (lambda dev: col.scnr(img, "maxneutral", 0.7, False,
                                            device=dev), 2e-6),
                      (lambda dev: geo.crop(img, 5, 7, 100, 90,
                                            device=dev), 0.0),
                      (lambda dev: geo.mirrorx(img, device=dev), 0.0),
                      (lambda dev: geo.rotate(img, 7.5, clamp=False,
                                              device=dev), 2e-6),
                      (lambda dev: geo.binxy(img, 3, False, device=dev),
                       1.2e-7)):
        a, b = fn("cpu").data, fn("cuda").data
        assert float(np.max(np.abs(a - b))) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("method", [0, 1])
def test_subsky_on_card_vs_cpu(method):
    """subsky (poly 2 and RBF) on the card against the CPU within 1e-5;
    the RBF evaluated in row blocks within 1e-6 of it whole, taking at
    most its blocks' memory beyond the image (four float32 (pixels,
    samples) temporaries)."""
    _need_card()
    from siril_tpu_torch.ops import background as bg

    d = _post_image(89, 256)
    img = SirilImage(data=d)
    a = bg.extract_background(img, method, 2, device="cpu").data
    b = bg.extract_background(img, method, 2, device="cuda").data
    assert float(np.max(np.abs(a - b))) <= 1e-5
    if method == 1:
        s = bg.generate_samples(d[0], 20, 1.0)
        n = sum(x.valid for x in s)
        block = 8 * 256 * n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        whole = bg.compute_background_rbf(s, (256, 256), 0.5, "cuda")
        rows = bg.compute_background_rbf(s, (256, 256), 0.5, "cuda",
                                         block_elems=block)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # cuBLAS sums the samples of a block in another order for another
        # block height: within float32 sums of ~400 terms
        assert float((whole - rows).abs().max()) <= 1e-6
        # the grids, the float64 affine part and the result, and at most
        # four block temporaries of the whole evaluation
        assert peak <= 256 * 256 * (4 * 2 + 8 * 3 + 4 * 2) + \
            4 * 4 * 256 * 256 * n


@pytest.mark.cuda
def test_pcc_spcc_on_card_vs_cpu(tmp_path):
    """pcc and spcc (chip_smoke.synth_post's fields at 256²) on the card
    against the CPU: the same gains, the images bit-equal (the apply is
    float64 on both devices)."""
    _need_card()
    import chip_smoke
    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.gaia_local import GaiaXPLocalCatalogue
    from siril_tpu_torch.astrometry.pcc import photometric_color_calibration
    from siril_tpu_torch.astrometry.spcc import spcc

    made = chip_smoke.synth_post(str(tmp_path), 90, 256, 60)
    chip_smoke.writes_done()
    w = chip_smoke.sky_wcs(256)
    for name, run in (
            ("post_spcc", lambda img, dev: spcc(
                img, GaiaXPLocalCatalogue(str(tmp_path / "post_xp.cat")),
                mag_limit=20.0, device=dev)),
            ("post_pcc", lambda img, dev: photometric_color_calibration(
                img, Catalog.load(str(tmp_path / "post_bv.csv")),
                mag_limit=20.0, device=dev))):
        img = SirilImage(data=made[name], wcs=w)
        a, b = run(img, "cpu"), run(img, "cuda")
        assert a.history[-1] == b.history[-1]
        assert np.array_equal(a.data, b.data)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its float32 mantissas cut to TF32's 10 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
def test_enhance_ops_on_card_vs_cpu():
    """Every device op of the enhancement session (chip_smoke.enhance_ops:
    the blur, unsharp, ddp, the median filter, the bilateral and guided
    filters, CLAHE, the à-trous planes and the wavelet denoiser,
    unpurple, rgradient, fftd / ffti, rl, wiener, sb, pixel math, the
    arithmetic and the curves) on the card against the CPU within its
    bound.  The 1e-6 of the convolutions is one TF32 could not meet:
    the blur of the same image with TF32-rounded inputs is further off."""
    _need_card()
    import chip_smoke
    from siril_tpu_torch.ops import filters as ft

    d = _post_image(91, 160)
    x = torch.from_numpy(d)
    for label, fn, bound in chip_smoke.enhance_ops():
        a = fn(x).numpy()
        b = fn(x.cuda()).cpu().numpy()
        assert float(np.max(np.abs(a.astype(np.float64) - b))) <= bound, \
            label
    noise = torch.from_numpy(np.random.default_rng(92).random(
        (1, 256, 256)).astype(np.float32))
    ref = ft.gaussian_blur_chw(noise, 1.5)
    card = ft.gaussian_blur_chw(noise.cuda(), 1.5).cpu()
    rounded = ft.gaussian_blur_chw(_tf32(noise.cuda()), 1.5).cpu()
    assert float((card - ref).abs().max()) <= 1e-6
    assert float((rounded - ref).abs().max()) > 1e-6


@pytest.mark.cuda
def test_denoise_on_card_vs_cpu():
    """NL-Bayes (plain, VST, SOS) and DA3D on the card against the CPU,
    held as tests/test_torch_denoise.py holds the port against the JAX
    package, on a 96² scene of noise σ 0.03: the error against the clean
    scene within 5 %, the mean |Δ| within 5e-3 (the first pass's
    ill-conditioned float32 solve, and the card's atomic adds); the DA3D
    refinement of one guide within 1e-5 on average; and the pass refuses
    TF32 matmuls."""
    _need_card()
    from siril_tpu_torch.ops import nlbayes as nl
    from siril_tpu_torch.ops.da3d import da3d

    rng = np.random.default_rng(93)
    yy, xx = np.mgrid[0:96, 0:96]
    clean = 0.2 + 0.3 * xx / 96 + 0.1 * np.sin(yy / 7.0)
    for _ in range(10):
        x0, y0 = rng.uniform(6, 90, 2)
        clean = clean + rng.uniform(0.1, 0.4) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / 5.0)
    clean = np.clip(np.stack([clean] * 3), 0, 1)
    d = np.clip(clean + rng.normal(0, 0.03, clean.shape), 0, 1).astype(
        np.float32)
    img = SirilImage(data=d)
    for kw in (dict(), dict(use_vst=True), dict(sos_iters=1)):
        a = nl.nlbayes_denoise(img, device="cpu", **kw).data
        b = nl.nlbayes_denoise(img, device="cuda", **kw).data
        assert float(np.abs(a.astype(np.float64) - b).mean()) <= 5e-3, kw
        err_a = np.sqrt(np.mean((a - clean) ** 2))
        err_b = np.sqrt(np.mean((b - clean) ** 2))
        assert abs(err_b / err_a - 1) <= 0.05, kw
    guide = nl.nlbayes_denoise(img, device="cpu").data[1]
    r_cpu = da3d(d[1], guide, 0.03, device="cpu")
    r_card = da3d(d[1], guide, 0.03, device="cuda").cpu()
    assert float((r_cpu - r_card).abs().mean()) <= 1e-5
    assert float((r_cpu - r_card).abs().max()) <= 1e-3
    x = torch.from_numpy(d[1]).cuda()
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32|tf32"):
            nl.nlbayes_tensor(x, 0.003)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_blind_engines_on_card_vs_cpu():
    """The ℓ0 engine's kernel on the card against the CPU (cosine ≥
    0.99); the spectral engine's restarts are chaotic (as against the JAX
    package), so its kernel is held by its shape: one 15 × 15 kernel,
    non-negative, summing to 1."""
    _need_card()
    from siril_tpu_torch.ops import blind_deconv as bd

    v = _post_image(94, 256)[1]
    a = bd.estimate_kernel_blind(v, 15, "l0", device="cpu")
    b = bd.estimate_kernel_blind(v, 15, "l0", device="cuda")
    cos = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    assert cos >= 0.99
    k = bd.estimate_kernel_blind(v, 15, "si", device="cuda")
    assert k.shape == (15, 15) and k.min() >= 0
    assert abs(float(k.sum()) - 1.0) <= 1e-5


@pytest.mark.cuda
def test_enhance_script_on_card_vs_cpu(tmp_path):
    """chip_smoke.ENHANCE_SCRIPT on a small post-stack field
    (chip_smoke.synth_post at 256², pcc-calibrated by PCC_SCRIPT) through
    the CLI on the card and on the CPU: the star PSF within 1e-6, rl
    within 1e-5, and after denoise every saved image within 5e-3 on
    average (the denoiser's bound above)."""
    _need_card()
    import shutil

    import chip_smoke
    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits

    src = tmp_path / "src"
    src.mkdir()
    chip_smoke.synth_post(str(src), 95, 256, 60)
    chip_smoke.writes_done()
    (src / "pcc.ssf").write_text(chip_smoke.PCC_SCRIPT.format(
        catalog="post_bv.csv").replace("pcc_cal", "post_cal"))
    cli.run(["-d", str(src), "--device", "cpu", "-s", str(src / "pcc.ssf")])
    (src / "enhance.ssf").write_text(chip_smoke.ENHANCE_SCRIPT)
    sessions = {}
    for dev in ("cpu", "cuda"):
        shutil.copytree(src, tmp_path / dev)
        sessions[dev] = cli.run(["-d", str(tmp_path / dev), "--device", dev,
                                 "-s", str(tmp_path / dev / "enhance.ssf")])
    assert float(np.abs(sessions["cpu"].psf - sessions["cuda"].psf).max()) \
        <= 1e-6
    for name, bound, stat in (("enh_rl", 1e-5, np.max),
                              ("enh_dn", 5e-3, np.mean),
                              ("enh_us", 5e-3, np.mean),
                              ("enh_final", 5e-3, np.mean)):
        a = read_fits(str(tmp_path / "cpu" / f"{name}.fit")).data
        b = read_fits(str(tmp_path / "cuda" / f"{name}.fit")).data
        assert float(stat(np.abs(a.astype(np.float64) - b))) <= bound, name


def _analysis_scene(seed=5, size=256):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = 0.1 + 0.005 * rng.standard_normal((size, size))
    for _ in range(30):
        x0, y0 = rng.uniform(8, size - 8, 2)
        img += rng.uniform(0.05, 0.6) * np.exp(
            -((xx + 0.5 - x0) ** 2 + (yy + 0.5 - y0) ** 2) / 3.4)
    img[rng.integers(0, size, 40), rng.integers(0, size, 40)] = 0.95
    img[rng.integers(0, size, 40), rng.integers(0, size, 40)] = 0.0
    t = np.linspace(0, 1, 600)
    img[np.round(20 + 200 * t).astype(int),
        np.round(30 + 190 * t).astype(int)] += 0.2
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.cuda
def test_analysis_ops_on_card_vs_cpu():
    _need_card()
    from siril_tpu_torch.ops import cosmetic, icc, inspector, statistics
    from siril_tpu_torch.ops import streaks, synthstar
    from siril_tpu_torch.registration.starfinder import detect_stars

    h = _analysis_scene()
    xh = torch.from_numpy(h)
    xc = xh.cuda()
    for cfa in (False, True):
        a = cosmetic.auto_detect_tensor(xc, 3.0, 3.0, cfa)
        b = cosmetic.auto_detect_tensor(xh, 3.0, 3.0, cfa)
        for u, v in zip(a, b):
            assert torch.equal(u.cpu(), v)
    yx = torch.nonzero(xh > 0.2).float()
    assert np.array_equal(
        streaks.hough_accumulator(yx[:, 0].cuda(), yx[:, 1].cuda(),
                                  h.shape, 360),
        streaks.hough_accumulator(yx[:, 0], yx[:, 1], h.shape, 360))
    assert [(t.start, t.end, t.votes) for t in
            streaks.detect_streaks_tensor(xc)] == \
        [(t.start, t.end, t.votes) for t in streaks.detect_streaks_tensor(xh)]
    assert np.array_equal(statistics.histogram256(xc),
                          statistics.histogram256(xh))
    sc = statistics.compute_stats_tensor(xc, statistics.STATS_EXTRA)
    sh = statistics.compute_stats_tensor(xh, statistics.STATS_EXTRA)
    for k in ("median", "mad", "location", "min", "max", "ngoodpix"):
        assert getattr(sc, k) == getattr(sh, k), k
    for k in ("mean", "avgdev", "sigma", "bgnoise", "sqrtbwmv", "scale"):
        assert abs(getattr(sc, k) - getattr(sh, k)) <= 1e-12, k
    stars = detect_stars(xh)
    rgb = np.stack([h, 0.8 * h, np.clip(1.2 * h, 0, 1)]).astype(np.float32)
    a, b = (synthstar.paint_stars(torch.from_numpy(rgb.copy()).to(d), stars,
                                  0).cpu() for d in ("cuda", "cpu"))
    assert float((a - b).abs().max()) <= 1e-6
    assert torch.equal(
        synthstar.star_discs(stars, 256, 256, torch.device("cuda")).cpu(),
        synthstar.star_discs(stars, 256, 256, torch.device("cpu")))
    img = icc.assign_profile(SirilImage(data=rgb), "srgb")
    for prof in ("rec2020", "srgblinear", "graylinear"):
        d = torch.from_numpy(rgb).double()
        a = icc.convert_tensor(d.cuda(), img, prof)[0].cpu()
        assert float((a - icc.convert_tensor(d, img, prof)[0]).abs().max()) \
            <= 1e-12
    a, b = (inspector.intensity_profile(SirilImage(data=rgb), (3.2, 5.7),
                                        (250.1, 240.3), width=3, device=d)
            for d in ("cuda", "cpu"))
    assert float(np.abs(a - b).max()) <= 1e-6


@pytest.mark.cuda
def test_analysis_script_on_card_vs_cpu(tmp_path):
    """chip_smoke.ANALYSIS_SCRIPT on a 512² session (synth_analysis)
    through the CLI on the card and on the CPU."""
    _need_card()
    import shutil

    import chip_smoke
    from siril_tpu_torch import cli
    from siril_tpu_torch.io.fits_io import read_fits

    src = tmp_path / "src"
    src.mkdir()
    size = 512
    made = chip_smoke.synth_analysis(str(src), 7, size, 80)
    chip_smoke.writes_done()
    k = size / 4096.0
    (src / "a.ssf").write_text(chip_smoke.ANALYSIS_SCRIPT.format(
        cold=chip_smoke.COSME_COLD, hot=chip_smoke.COSME_HOT,
        tx=made["sx"][made["target"]], ty=made["sy"][made["target"]],
        crop_x=int(1024 * k), crop_y=int(1024 * k), crop_w=int(2048 * k),
        trail=chip_smoke.TRAIL_LIGHT + 1, px0=12, py0=25, px1=487, py1=462))
    for dev in ("cpu", "cuda"):
        shutil.copytree(src, tmp_path / dev)
        cli.run(["-d", str(tmp_path / dev), "--device", dev, "-s",
                 str(tmp_path / dev / "a.ssf")])
    for i in range(1, chip_smoke.ANALYSIS_LIGHTS + 1):
        a = read_fits(str(tmp_path / "cpu" / f"cc_light_{i:05d}.fit")).data
        b = read_fits(str(tmp_path / "cuda" / f"cc_light_{i:05d}.fit")).data
        assert np.array_equal(a, b)
    for name in ("seqstat.csv", "histo_0.dat", "streaks.csv",
                 "dark/hot.lst"):
        assert (tmp_path / "cpu" / name).read_text() == \
            (tmp_path / "cuda" / name).read_text(), name
    # the LM fits of the follow run in float32 on each device: the
    # magnitudes part by a few 1e-4 (1.45e-3 measured), within the error
    # each reports
    a, b = (np.loadtxt(str(tmp_path / d / "light_curve.dat"),
                       usecols=(0, 2, 3)) for d in ("cpu", "cuda"))
    assert a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0])
    assert np.all(np.abs(a[:, 1] - b[:, 1]) <= a[:, 2])
    for name in ("an_icc", "an_insp"):
        a = read_fits(str(tmp_path / "cpu" / f"{name}.fit")).data
        b = read_fits(str(tmp_path / "cuda" / f"{name}.fit")).data
        assert float(np.abs(a - b).max()) <= 1.5 / 65535, name



def _planet(rng, n=6, size=128):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = np.hypot(yy - size / 2, xx - size / 2)
    disc = np.clip(1.0 - (r / (0.38 * size)) ** 8, 0, 1)
    scene = 0.05 + disc * (0.55 + 0.12 * np.sin(yy / size * 9 * np.pi))
    out = []
    for _ in range(n):
        dy, dx = rng.integers(-4, 5, 2)
        f = np.roll(np.roll(scene, dy, 0), dx, 1)
        out.append(f + rng.normal(0, 0.01, f.shape))
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


@pytest.mark.cuda
def test_planetary_ops_on_card_vs_cpu(tmp_path):
    _need_card()
    from siril_tpu_torch.io.ser import SER_MONO, SerWriter
    from siril_tpu_torch.planetary import mlc, quality, source
    from siril_tpu_torch.registration import shift

    rng = np.random.default_rng(4)
    fr = _planet(rng)
    qc = quality.quality_batch(fr, device="cuda")
    qh = quality.quality_batch(fr, device="cpu")
    assert np.abs(qc / qh - 1).max() <= 1e-5
    assert np.array_equal(np.argsort(qc), np.argsort(qh))
    a = shift.phase_correlate(fr[0], fr, device="cuda")
    b = shift.phase_correlate(fr[0], fr, device="cpu")
    assert np.abs(a - b).max() <= 1e-3
    E, S = mlc.mlc_window_extent(14), 48
    big = np.stack([f[64 - S // 2 - E:64 + S // 2 + E,
                      64 - S // 2 - E:64 + S // 2 + E] for f in fr])
    ref = np.repeat(fr[:1, 64 - S // 2:64 + S // 2, 64 - S // 2:64 + S // 2],
                    len(fr), 0)
    dc = mlc.multilevel_correlation_batch(big, ref, device="cuda")
    dh = mlc.multilevel_correlation_batch(big, ref, device="cpu")
    assert np.array_equal(dc[2], dh[2])
    assert np.array_equal(np.round(dc[0]), np.round(dh[0]))
    assert np.array_equal(np.round(dc[1]), np.round(dh[1]))
    assert max(np.abs(dc[0] - dh[0]).max(), np.abs(dc[1] - dh[1]).max()) \
        <= 1e-3
    w = SerWriter(str(tmp_path / "v.ser"), 128, 128, SER_MONO, 16)
    for f in fr:
        w.write_frame(SirilImage(data=f[None]))
    w.close()
    seq = Sequence.from_ser(str(tmp_path / "v.ser"))
    (_, c), = list(source.frame_chunks(seq, np.arange(4), 0, 8, "cuda"))
    seq2 = Sequence.from_ser(str(tmp_path / "v.ser"))
    (_, h), = list(source.frame_chunks(seq2, np.arange(4), 0, 8, "cpu"))
    assert torch.equal(c.cpu(), h)


@pytest.mark.cuda
def test_native_raw_decoders_on_card_machine():
    """The C++ decoders built by the card machine's compiler, bit-equal to
    the port's Python decoders on streams of their own encoders."""
    _need_card()
    import chip_smoke
    from siril_tpu_torch import native
    from siril_tpu_torch.io import dng, rawfile

    rng = np.random.default_rng(6)
    img = rng.integers(0, 1 << 14, (64, 64)).astype(np.uint16)
    blob = chip_smoke.encode_ljpeg(img, 14)
    assert np.array_equal(native.decode_ljpeg(blob)[0],
                          dng._ljpeg_decode_py(blob)[0])
    raw, vpred = chip_smoke.encode_nikon(img)
    assert np.array_equal(native.decode_nikon(raw, 64, 64, 5, vpred, 0),
                          rawfile._nikon_decode_py(raw, 64, 64, 5, vpred, 0))
    pb = rng.integers(0, 256, 0x4000).astype(np.uint8).tobytes()
    assert np.array_equal(native.decode_panasonic(pb, 70, 64),
                          rawfile._pana_bits_decode_py(pb, 70, 64))


@pytest.mark.cuda
def test_survey_nccl_world1_on_card(monkeypatch):
    """A world-1 NCCL group: ``survey_stack_sharded`` on the card launches
    K1 once a row block, each launch bit-equal to ``reject_stack_plain``
    on its inputs, and the whole stack equal to the same survey over the
    group's gloo side on the CPU."""
    _need_card()
    import tempfile

    import torch.distributed as dist

    from siril_tpu_torch.kernels import reject_stack as k1
    from siril_tpu_torch.parallel.sharding import make_mesh
    from siril_tpu_torch.parallel.survey import survey_stack_sharded
    from tests.test_torch_parallel import survey_reader

    d = tempfile.mkdtemp()
    dist.init_process_group("cuda:nccl,cpu:gloo",
                            init_method=f"file://{d}/store", world_size=1,
                            rank=0)
    try:
        calls, orig = [], k1.reject_mean

        def spy(*a, **kw):
            out = orig(*a, **kw)
            calls.append((a, kw, out))
            return out

        monkeypatch.setattr(k1, "reject_mean", spy)
        n, L, H, W = 6, 1, 64, 67
        runs = {}
        for kind in ("cuda", "cpu"):
            runs[kind] = survey_stack_sharded(
                survey_reader(n, H, W), n, L, H, W,
                make_mesh(1, 1, device_type=kind), rj.WINSORIZED,
                ADDITIVE_SCALING, budget_bytes_per_dev=6 * 67 * 16 * 20)
        card = [c for c in calls if c[0][0].is_cuda]
        assert runs["cuda"].n_blocks == 4 and len(card) == 4
        for a, kw, out in card:
            ref = reject_stack_plain(*a, **kw)
            for got, want in zip(out, ref):
                assert torch.equal(got, want)
        np.testing.assert_array_equal(runs["cuda"].data, runs["cpu"].data)
        assert runs["cuda"].total_rejected == runs["cpu"].total_rejected
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_compute_probe_on_card_vs_cpu():
    """Each stage of the compute probe's iteration on the card against the
    CPU on the same inputs (n = 3, 256²): the calibrated and warped frames
    within 2e-6, the statistics and estimators within 1e-5 relative, the
    stack's mean within 2e-6 and its counts equal (the K1 kernel on the
    card, its plain version on the CPU)."""
    _need_card()
    from siril_tpu_torch.tools import compute_probe as cp

    inputs = [t.cpu() for t in cp.make_inputs(3, 256, 5, "cuda")]
    for stage in cp.STAGE_FEATURES:
        pc, ph = {}, {}
        ac = cp.probe_iteration(1, *inputs, stage, device="cuda", parts=pc)
        ah = cp.probe_iteration(1, *inputs, stage, device="cpu", parts=ph)
        assert np.isfinite(float(ac)) and np.isfinite(float(ah)), stage
        for key, tol in (("calib", 2e-6), ("warped", 2e-6)):
            if key in pc:
                assert (pc[key].cpu() - ph[key]).abs().max() <= tol, stage
        for key in ("stats", "scale"):
            if key in pc:
                rel = ((pc[key].cpu() - ph[key]).abs()
                       / ph[key].abs().clamp_min(1e-30)).max()
                assert rel <= 1e-5, (stage, key)
        if "stack" in pc:
            mc, lc, hc = (t.cpu() for t in pc["stack"])
            mh, lh, hh = ph["stack"]
            assert torch.equal(lc, lh) and torch.equal(hc, hh), stage
            assert (mc - mh).abs().max() <= 2e-6, stage


@pytest.mark.cuda
def test_session_surface_on_card(tmp_path):
    """On the card: the pipe runs a stack and ``precompile`` finds the
    library; ``pyscript`` moves the card session's image through SHM and
    back; a ``torch.profiler`` trace of a stack names the K1 kernel."""
    _need_card()
    import io

    from siril_tpu_torch.cli import build_session, pipe_loop
    from siril_tpu_torch.utils import trace

    rng = np.random.default_rng(8)
    for i in range(6):
        write_fits(SirilImage(data=_mkstack(rng, 1, 64 * 48).reshape(
            1, 64, 48)), str(tmp_path / f"c_{i + 1:05d}.fit"), bitdepth=-32)
    write_fits(SirilImage(data=rng.random((3, 32, 40)).astype(np.float32)),
               str(tmp_path / "rgb.fit"), bitdepth=-32)
    (tmp_path / "s.py").write_text(
        "px = siril.get_image_pixeldata()\n"
        "siril.set_image_pixeldata(px * 0.5)\n")
    s = build_session(str(tmp_path), "cuda")
    out = io.StringIO()
    trace.start_device_trace(str(tmp_path / "tr"))
    try:
        pipe_loop(s, ["stack c_ rej 3 3 -norm=addscale\n", "load rgb\n",
                      "pyscript s.py\n", "precompile 6\n"], out)
    finally:
        path = trace.stop_device_trace()
    status = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("status:")]
    assert status == ["status: success stack", "status: success load",
                      "status: success pyscript",
                      "status: success precompile"]
    assert "already built" in out.getvalue()
    assert s.command_log[0]["launches"].get("K1a", 0) >= 1
    from siril_tpu_torch.io.fits_io import read_fits

    rgb = read_fits(str(tmp_path / "rgb.fit")).data
    assert np.array_equal(s.image.host(), rgb * np.float32(0.5))
    names = trace.busy_share(path)["kernels"]
    assert any("register_kernel" in n for n in names)
