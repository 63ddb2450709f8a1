"""The plain reference against the program at tiny sizes on the CPU:
each stage on its own, then whole cells, whose check must pass with
room."""

import numpy as np
import pytest
import torch

from benchmark.reference import deepsky as ref
from benchmark.tests.conftest import run_tiny

DEEPSKY = ["deepsky_mono_imx571.lights24",
           "deepsky_mono_imx571.flats32_noreg"]
PLANETARY = ["planetary_mono_640x480.jupiter1000"]


def _stack(seed, n=24, p=4000):
    g = np.random.default_rng(seed)
    x = 0.1 + 0.01 * g.standard_normal((n, p))
    hit = g.random((n, p)) < 0.01
    x[hit] += g.uniform(0.05, 0.9, hit.sum())
    x[g.random((n, p)) < 0.002] = 0.0            # not data
    return x


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_winsorized_against_the_program(seed):
    from siril_tpu_torch.ops import rejection as rj

    x = _stack(seed)
    m, lo, hi = ref.winsorized_mean(torch.from_numpy(x), 3.0, 3.0)
    pm, plo, phi = rj.rejection_mean(torch.from_numpy(x).float(),
                                     rj.WINSORIZED, 3.0, 3.0)
    assert np.abs(m.numpy() - pm.double().numpy()).max() < 1e-6
    assert int(lo.sum()) == int(plo.sum())
    assert int(hi.sum()) == int(phi.sum())


def test_ikss_against_the_program():
    from siril_tpu_torch.ops.statistics import norm_estimators

    x = _stack(4, n=3, p=20000)
    e = norm_estimators(torch.from_numpy(x).float())
    for k in range(3):
        loc, sca = ref.ikss(torch.from_numpy(x[k]))
        assert loc == pytest.approx(float(e["location"][k]), rel=1e-6)
        assert sca == pytest.approx(float(e["scale"][k]), rel=1e-5)


@pytest.mark.parametrize("dx,dy", [(3.25, -7.6), (-12.4, 0.5), (0.0, 2.0)])
def test_translation_warp_against_the_program(dx, dy):
    from siril_tpu_torch.ops import interp

    g = np.random.default_rng(5)
    f = 0.1 + 0.01 * g.standard_normal((96, 128))
    f[40:43, 60:63] += 0.5                        # a star to clamp round
    out = ref.shift_frame(torch.from_numpy(f), dx, dy).numpy()
    got = interp.warp_translation_batch(
        torch.from_numpy(f).float()[None, None], np.array([[dx, dy]]),
        interp.INTERP_LANCZOS4, clamp=True)[0, 0].double().numpy()
    assert np.abs(out - got).max() < 2e-6


def test_calibration_against_the_program():
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops.calibration import (
        CalibArgs,
        calibrate_tensor,
        prepare_calibration,
    )

    g = np.random.default_rng(6)
    H, W = 64, 80
    bias = (0.03 + 0.0005 * g.standard_normal((H, W))).astype(np.float32)
    dark = (0.005 + 0.0005 * g.standard_normal((H, W))).astype(np.float32)
    dark[10, 20] = dark[30, 40] = 0.3
    flat = (0.5 + 0.01 * g.standard_normal((H, W))).astype(np.float32)
    raw = (bias + dark + 0.1 + 0.01 * g.standard_normal((H, W))).astype(
        np.float32)
    ca = CalibArgs(bias=SirilImage(data=bias[None]),
                   dark=SirilImage(data=dark[None]),
                   flat=SirilImage(data=flat[None]), use_cosmetic=True)
    st = prepare_calibration(ca, SirilImage(data=raw[None]), "cpu")
    got = calibrate_tensor(torch.from_numpy(raw[None]), st)[0].double()
    t = {k: torch.from_numpy(v.astype(np.float64)) for k, v in
         dict(bias=bias, dark=dark, flat=flat, raw=raw).items()}
    hot = ref.hot_pixels(t["dark"], 3.0)
    assert bool(hot[10, 20]) and bool(hot[30, 40])
    out = ref.calibrate(t["raw"], t["bias"], t["dark"], t["flat"], hot)
    assert (out - got).abs().max() < 1e-6


def test_planetary_pieces_against_the_program():
    from siril_tpu_torch.planetary.mpp import _shift_core
    from siril_tpu_torch.planetary.quality import quality_core
    from siril_tpu_torch.registration.shift import (
        decode_phasecorr_peaks,
        phase_correlate_device,
    )

    from benchmark.reference import planetary as pl

    g = np.random.default_rng(8)
    y, x = np.mgrid[0:96, 0:128]
    base = np.exp(-((x - 64) ** 2 + (y - 48) ** 2) / 300.0)
    f = np.stack([np.roll(base, (k, 2 * k), (0, 1)) for k in range(3)])
    f = f + 0.01 * g.standard_normal(f.shape)
    t = torch.from_numpy(f)
    assert np.allclose(pl.quality(t).numpy(),
                       quality_core(t.float()).double().numpy(), rtol=1e-5)
    d = np.array([[0.3, -1.2], [2.5, 0.7], [-0.4, 0.0]])
    got = _shift_core(t.float(), torch.from_numpy(d).float()).double()
    want = pl.fourier_shift(t, torch.from_numpy(d))
    assert (got - want).abs().max() < 1e-5
    packed = phase_correlate_device(t[0].float(), t.float())
    assert np.allclose(pl.phase_shifts(t[0], t),
                       decode_phasecorr_peaks(packed, 96, 128), atol=1e-4)


@pytest.mark.parametrize("cell", DEEPSKY + PLANETARY)
def test_cell_passes_its_check(cell, tmp_path):
    res = run_tiny(cell, tmp=tmp_path)
    assert res["correct"], res["checks"]
    for name in ("image_mean_abs", "image_tile_max"):
        # the images agree with room; the counts and shifts at this size
        # rest on a few pixels and stars
        c = res["checks"][name]
        assert c["value"] <= 0.1 * c["limit"], name
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["leaked"] == []
