"""Parity: the port's calibration and cosmetic correction
(``siril_tpu_torch/ops/calibration.py``, ``ops/cosmetic.py``) against the
JAX package on the same frames and masters made from a seed, on the CPU.

Tolerances, each with its reason:
- ``calibrate_image`` within 1e-6: the same float32 operations, with
  ``x − k·dark`` as one fused multiply-add as XLA:CPU compiles it; the
  3×3 mean of a hot pixel is summed in another order (a few ulp);
- the deviant masks equal: the same numpy statistics on the host;
- the dark-optimization k within the golden-section search's tolerance
  (2e-3): a float32 noise comparison summed in another order can flip
  one step of the search;
- ``equalize_cfa_flat`` and ``evaluate_offset_level`` exact (numpy and
  Python in both);
- the calibrated ``pp_`` frames of ``calibrate_sequence`` equal: 16-bit
  frames are written as 16-bit, as the reference's engine does.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from siril_tpu.core.image import USHORT_IMG, SirilImage
from siril_tpu.core.sequence import Sequence as JSeq
from siril_tpu.io.fits_io import read_fits as jread
from siril_tpu.io.fits_io import write_fits as jwrite
from siril_tpu.ops import calibration as jcal
from siril_tpu.ops import cosmetic as jcos
from siril_tpu_torch import convert
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.io.fits_io import read_fits
from siril_tpu_torch.ops import calibration as cal
from siril_tpu_torch.ops import cosmetic as cos

torch.set_num_threads(1)

H, W = 64, 72
ATOL = 1e-6


def _img(a, exposure=0.0, offset=0):
    img = SirilImage(data=np.asarray(a, np.float32))
    img.keywords.exposure = exposure
    img.keywords.offset = offset
    return img


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    dark = 0.02 + rng.normal(0, 0.002, (1, H, W))
    dark[0, rng.integers(0, H, 12), rng.integers(0, W, 12)] = 0.4   # hot
    dark[0, rng.integers(0, H, 6), rng.integers(0, W, 6)] = 0.001   # cold
    dark[0, 0, 5] = dark[0, H - 1, W - 1] = 0.5     # hot at the edges
    yy, xx = np.mgrid[0:H, 0:W]
    vig = 1.0 - 0.3 * ((xx - W / 2) ** 2 + (yy - H / 2) ** 2) / (W / 2) ** 2
    flat = 0.5 * vig[None] + rng.normal(0, 0.003, (1, H, W))
    flat[0, 1::2, ::2] *= 1.1                        # a CFA-like pattern
    bias = 0.03 + rng.normal(0, 0.001, (1, H, W))
    raw = bias + 0.7 * dark + 0.1 * vig[None] + \
        rng.normal(0, 0.004, (1, H, W))
    return dict(raw=_img(np.clip(raw, 0, 1), exposure=60.0, offset=2048),
                bias=_img(bias), dark=_img(np.clip(dark, 0, 1),
                                           exposure=120.0),
                flat=_img(flat))


#: (bias, synthetic bias, dark, -opt, -opt=exp, flat, -cc=dark, -cfa)
COMBOS = [c for c in itertools.product((0, 1), (0, 1), (0, 1), (0, 1, 2),
                                       (0, 1), (0, 1), (0, 1))
          if not (c[0] and c[1]) and (c[2] or (not c[3] and not c[5]))
          and not (c[6] and not c[4] and not c[5])]


def _ids(c):
    names = ("bias", "=expr", "dark", ("", "opt", "opt=exp"), "flat", "cc",
             "cfa")
    out = []
    for n, v in zip(names, c):
        if isinstance(n, tuple):
            if v:
                out.append(n[v])
        elif v:
            out.append(n)
    return "-".join(out) or "none"


@pytest.mark.parametrize("combo", COMBOS, ids=[_ids(c) for c in COMBOS])
def test_calibrate_image_vs_jax(frames, combo):
    bias, expr, dark, opt, flat, cc, cfa = combo
    ja = jcal.CalibArgs()
    if bias:
        ja.bias = frames["bias"]
    if expr:
        ja.bias_level = jcal.evaluate_offset_level("=64*$OFFSET/2048",
                                                   frames["raw"])
    if dark:
        ja.dark = frames["dark"]
    ja.use_dark_optim = bool(opt)
    ja.use_exposure = opt == 2
    if flat:
        ja.flat = frames["flat"]
    ja.use_cosmetic = bool(cc)
    ja.is_cfa = bool(cfa)
    ja.equalize_cfa = bool(cfa)
    ta = convert.calib_args(dataclasses.asdict(ja))
    raw = frames["raw"]
    ref = jcal.calibrate_image(raw, ja)
    got = cal.calibrate_image(convert.siril_image(dataclasses.asdict(raw)),
                              ta, device="cpu")
    assert got.history == ref.history
    assert got.orig_bitdepth == ref.orig_bitdepth
    np.testing.assert_allclose(got.host(), ref.host(), rtol=0, atol=ATOL)


def test_fma_of_the_dark(frames):
    """x − k·dark is one rounding, as XLA:CPU compiles it: the port is
    bit-equal to the JAX kernel without a flat or cosmetic correction,
    and two separately rounded operations are not."""
    raw = frames["raw"].host()
    dark = frames["dark"].host()
    k = np.float32(0.7371234)
    jk = jcal.make_calibrate_kernel(False, True, False, False, False)
    z = np.zeros((H, W), bool)
    ref = np.asarray(jk(raw, raw, dark, k, raw, np.float32(1), z, z))
    tk = cal.make_calibrate_kernel(False, True, False, False, False)
    got = tk(torch.from_numpy(raw), None, torch.from_numpy(dark), float(k),
             None, None).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(raw - k * dark, ref)


def test_dark_optimization_k_vs_jax(frames):
    raw, dark = frames["raw"].host(), frames["dark"].host()
    kj = jcal.dark_optimization_k(raw, dark, False)
    kt = cal.dark_optimization_k(torch.from_numpy(raw),
                                 torch.from_numpy(dark), False)
    assert 0.0 < kt < 2.0
    assert abs(kt - kj) <= 2e-3
    assert cal.dark_optimization_k(None, None, True, 60.0, 120.0) == \
        jcal.dark_optimization_k(None, None, True, 60.0, 120.0) == 0.5
    with pytest.raises(ValueError, match="EXPTIME"):
        cal.dark_optimization_k(None, None, True, 0.0, 120.0)


@pytest.mark.parametrize("sig_cold,sig_hot", [(-1.0, 3.0), (2.0, 3.0),
                                              (1.0, -1.0), (0.5, 0.5)])
def test_deviant_masks_equal(frames, sig_cold, sig_hot):
    dark = frames["dark"].host()[0]
    for a, b in zip(cos.detect_deviant_from_dark(dark, sig_cold, sig_hot),
                    jcos.detect_deviant_from_dark(dark, sig_cold, sig_hot)):
        np.testing.assert_array_equal(a, b)
    flat = np.full((H, W), 0.1, np.float32)
    assert not any(m.any() for m in cos.detect_deviant_from_dark(flat, 1, 1))


def test_even_count_median_pinned():
    """The cold replacement is the mean of the two middle values of the
    24 neighbours, as jnp.median, not torch.median's lower one."""
    layer = np.zeros((9, 9), np.float32)
    vals = np.arange(1, 25, dtype=np.float32) / 100.0      # 0.01 … 0.24
    ring = [(y, x) for y in range(2, 7) for x in range(2, 7)
            if (y, x) != (4, 4)]
    for (y, x), v in zip(ring, np.random.default_rng(0).permutation(vals)):
        layer[y, x] = v
    cold = np.zeros((9, 9), bool)
    cold[4, 4] = True
    hot = np.zeros((9, 9), bool)
    got = cos.correct_deviant(torch.from_numpy(layer), cold, hot).numpy()
    ref = np.asarray(jcos.correct_deviant(layer, cold, hot))
    assert got[4, 4] == ref[4, 4] == np.float32((0.12 + 0.13) * 0.5)
    assert got[4, 4] != float(torch.median(torch.from_numpy(vals)))


@pytest.mark.parametrize("cfa", [False, True])
def test_correct_deviant_vs_jax(frames, cfa):
    rng = np.random.default_rng(12 + cfa)
    layer = rng.random((H, W)).astype(np.float32)
    cold = rng.random((H, W)) < 0.02
    hot = rng.random((H, W)) < 0.02
    cold[0, 0] = hot[H - 1, 3] = hot[2, W - 1] = True       # edges
    cold[5, 5] = hot[5, 5] = True                           # both: hot wins
    got = cos.correct_deviant(torch.from_numpy(layer), cold, hot,
                              cfa).numpy()
    ref = np.asarray(jcos.correct_deviant(layer, cold, hot, cfa))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert cos._offsets(2, cfa) == jcos._offsets(2, cfa)


def test_equalize_and_offset_level_exact(frames):
    flat = frames["flat"].host()
    np.testing.assert_array_equal(cal.equalize_cfa_flat(flat),
                                  jcal.equalize_cfa_flat(flat))
    raw = frames["raw"]
    for expr in ("500", "=2048", "=64*$OFFSET", "=(2*$offset+10)/3"):
        assert cal.evaluate_offset_level(expr, raw) == \
            jcal.evaluate_offset_level(expr, raw)
    with pytest.raises(ValueError, match="invalid"):
        cal.evaluate_offset_level("=__import__('os')", raw)


def test_calibrate_sequence_vs_jax(tmp_path, frames):
    """``calibrate`` over a 16-bit sequence writes the same 16-bit pp_
    frames as the JAX package's engine."""
    rng = np.random.default_rng(13)
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        raw = frames["raw"].host() + rng.normal(0, 0.003, (1, H, W))
        for d in ("jax", "port"):
            jwrite(_img(np.clip(raw, 0, 1)),
                   str(tmp_path / d / f"l_{i + 1:05d}.fit"),
                   bitdepth=USHORT_IMG)
    ja = jcal.CalibArgs(bias=frames["bias"], dark=frames["dark"],
                        flat=frames["flat"])
    jres = jcal.calibrate_sequence(JSeq.scan("l_", str(tmp_path / "jax")), ja)
    tres = cal.calibrate_sequence(Sequence.scan("l_", str(tmp_path / "port")),
                                  convert.calib_args(dataclasses.asdict(ja)),
                                  device="cpu")
    assert tres.processed == jres.processed == 3
    assert tres.new_seq.name == jres.new_seq.name == "pp_l_"
    assert {"read", "upload", "calibrate", "fetch", "write"} <= \
        set(tres.stage_s)
    for i in range(3):
        a = jread(str(tmp_path / "jax" / f"pp_l_{i + 1:05d}.fit"))
        b = read_fits(str(tmp_path / "port" / f"pp_l_{i + 1:05d}.fit"))
        assert a.orig_bitdepth == b.orig_bitdepth == USHORT_IMG
        np.testing.assert_array_equal(b.host(), a.host())
    # -debayer leaves frames without a Bayer pattern as they are (mono)
    ja = jcal.CalibArgs(bias=frames["bias"], debayer=True, prefix="d_")
    jcal.calibrate_sequence(JSeq.scan("l_", str(tmp_path / "jax")), ja)
    cal.calibrate_sequence(Sequence.scan("l_", str(tmp_path / "port")),
                           convert.calib_args(dataclasses.asdict(ja)),
                           device="cpu")
    for i in range(3):
        a = jread(str(tmp_path / "jax" / f"d_l_{i + 1:05d}.fit"))
        b = read_fits(str(tmp_path / "port" / f"d_l_{i + 1:05d}.fit"))
        assert a.nchans == b.nchans == 1
        np.testing.assert_array_equal(b.host(), a.host())


def test_calibrate_debayer_vs_jax(tmp_path, frames):
    """``calibrate -cfa -equalize_cfa -debayer`` on 16-bit CFA frames
    (BAYERPAT GBRG with an x offset): the masters, the CFA-aware cosmetic
    correction, then RCD on the calibrated frame; three 16-bit layers, no
    pattern left, "Debayer applied" last in the history.  Within one
    16-bit step of the JAX package's frames: the calibrated values agree
    to 1e-6 and RCD to 1e-6 (tests/test_torch_demosaic.py), so a value
    near a rounding boundary can land on the next step."""
    rng = np.random.default_rng(17)
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        raw = frames["raw"].host() + rng.normal(0, 0.003, (1, H, W))
        img = _img(np.clip(raw, 0, 1))
        img.keywords.bayer_pattern = "GBRG"
        img.keywords.bayer_xoffset = 1
        for d in ("jax", "port"):
            jwrite(img, str(tmp_path / d / f"c_{i + 1:05d}.fit"),
                   bitdepth=USHORT_IMG)
    ja = jcal.CalibArgs(bias=frames["bias"], dark=frames["dark"],
                        flat=frames["flat"], is_cfa=True, equalize_cfa=True,
                        debayer=True)
    jres = jcal.calibrate_sequence(JSeq.scan("c_", str(tmp_path / "jax")), ja)
    tres = cal.calibrate_sequence(Sequence.scan("c_", str(tmp_path / "port")),
                                  convert.calib_args(dataclasses.asdict(ja)),
                                  device="cpu")
    assert tres.processed == jres.processed == 2
    assert "debayer" in tres.stage_s
    for i in range(2):
        a = jread(str(tmp_path / "jax" / f"pp_c_{i + 1:05d}.fit"))
        b = read_fits(str(tmp_path / "port" / f"pp_c_{i + 1:05d}.fit"))
        assert a.orig_bitdepth == b.orig_bitdepth == USHORT_IMG
        assert a.nchans == b.nchans == 3
        assert a.keywords.bayer_pattern == b.keywords.bayer_pattern == ""
        assert b.history[-1] == a.history[-1] == "Debayer applied"
        np.testing.assert_allclose(b.host(), a.host(), rtol=0,
                                   atol=1.0 / 65535 + 1e-7)


def test_calibrate_sequence_drops_frame_without_exposure(tmp_path, frames):
    """``calibrate -opt=exp`` leaves out and unselects a frame that has
    no EXPTIME to scale the dark by, as the JAX package's engine does, and
    calibrates the others the same way."""
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        for i, e in enumerate((60.0, 0.0, 90.0)):
            jwrite(_img(frames["raw"].host(), exposure=e),
                   str(tmp_path / d / f"l_{i + 1:05d}.fit"),
                   bitdepth=USHORT_IMG)
    ja = jcal.CalibArgs(dark=frames["dark"], use_dark_optim=True,
                        use_exposure=True, use_cosmetic=False)
    jseq = JSeq.scan("l_", str(tmp_path / "jax"))
    tseq = Sequence.scan("l_", str(tmp_path / "port"))
    jres = jcal.calibrate_sequence(jseq, ja)
    tres = cal.calibrate_sequence(tseq,
                                  convert.calib_args(dataclasses.asdict(ja)),
                                  device="cpu")
    assert tres.processed == jres.processed == 2
    assert tres.failed == list(jres.failed) == [1]
    assert list(tseq.incl) == list(jseq.incl) == [True, False, True]
    for i in (1, 3):
        a = jread(str(tmp_path / "jax" / f"pp_l_{i:05d}.fit"))
        b = read_fits(str(tmp_path / "port" / f"pp_l_{i:05d}.fit"))
        np.testing.assert_array_equal(b.host(), a.host())
