"""The port's filters, wavelets, FFT tool and curves
(siril_tpu_torch/ops/filters.py, wavelets.py, curves.py) against the JAX
package on the CPU, on the same seeded inputs (64²-128² RGB unless
stated), and their commands through both packages' command tables.

Bounds (absolute, on [0, 1] data):
- the pointwise ops, the median filter, the threshold family and the
  curves: 1e-6;
- the convolutions and the FFT ops (gauss, unsharp, ddp, epf bilateral
  and guided, the à-trous planes and their reconstruction, the wavelet
  denoiser, fftd / ffti, rgradient): 1e-5 (float32 sums in another
  order than XLA's convolutions and FFTs);
- CLAHE, banding and linear_match: bit-equal (host numpy in both; CLAHE's
  per-pixel part on the device in float64).
"""

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import curves as jcu
from siril_tpu.ops import filters as jft
from siril_tpu.ops import wavelets as jwv
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import curves as tcu
from siril_tpu_torch.ops import filters as tft
from siril_tpu_torch.ops import wavelets as twv

torch.set_num_threads(1)

CPU = "cpu"


def scene(seed=3, size=96, nch=3, noise=0.01):
    """A sky at 0.05-0.15 with a gradient, noise and 15 stars."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    data = np.empty((nch, size, size), np.float32)
    for c in range(nch):
        d = 0.05 + 0.1 * xx / size * (0.8 + 0.2 * c) + rng.normal(
            0, noise, (size, size))
        for _ in range(15):
            x0, y0 = rng.uniform(4, size - 4, 2)
            d += rng.uniform(0.1, 0.8) * np.exp(
                -((xx - x0) ** 2 + (yy - y0) ** 2) / 4.0)
        data[c] = np.clip(d, 0.0, 1.0)
    return data


def pair(data):
    return JImage(data=data.copy()), TImage(data=data.copy())


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err


@pytest.mark.parametrize("sigma", [0.8, 2.0, 5.0])
def test_gaussian_blur_vs_jax(sigma):
    d = scene(1)
    want = np.asarray(jft.gaussian_blur_chw(d, sigma))
    close(tft.gaussian_blur_chw(torch.from_numpy(d), sigma), want, 1e-5)


@pytest.mark.parametrize("name,args,tol", [
    ("gauss", (1.5,), 1e-5),
    ("unsharp", (1.6, 1.5), 1e-5),
    ("unsharp", (2.0, 0.0), 1e-5),
    ("ddp", (0.05, 0.3, 1.2), 1e-5),
    ("ddp", (0.05, 0.3, 0.0), 1e-6),
    ("median_filter", (3, 1.0), 1e-6),
    ("median_filter", (5, 0.6), 1e-6),
    ("median_filter", (3, 0.8, 2), 1e-6),
    ("bilateral", (5.0, 0.1, 3.0, 1.0), 1e-5),
    ("bilateral", (7.0, 0.05, 2.0, 0.7), 1e-5),
    ("guided_filter", (8, 0.01, 1.0), 1e-5),
    ("guided_filter", (4, 1e-3, 0.5), 1e-5),
    ("unpurple", (0.05, 0.8), 1e-6),
    ("rgradient", (40.5, 50.0, 3.0, 5.0), 1e-5),
])
def test_device_filter_vs_jax(name, args, tol):
    d = scene(2)
    d[2] += 0.1 * (d[0] > 0.3)                  # some purple fringes
    j, t = pair(np.clip(d, 0, 1))
    want = getattr(jft, name)(j, *args).data
    got = getattr(tft, name)(t, *args, device=CPU).data
    close(got, want, tol)


def test_median_filter_blocks(monkeypatch):
    """Row blocks of one row give the whole image's result."""
    d = scene(4, 48)
    whole = tft.median_blocks(torch.from_numpy(d), 5)
    monkeypatch.setattr(tft, "MEDIAN_BLOCK_BYTES", 1)
    assert torch.equal(tft.median_blocks(torch.from_numpy(d), 5), whole)


def test_box_departure():
    """At 2048² the JAX package's float32 integral image is up to 3.5e-4
    off the box mean (r 8, sky 0.1, σ 0.01; scripts/box_departure.py)
    where the port's float64 one is within a float32 rounding; at 64²
    the two packages agree within 1e-6."""
    rng = np.random.default_rng(0)
    big = (0.1 + 0.01 * rng.standard_normal((1, 2048, 2048))).astype(
        np.float32)
    c = np.pad(np.pad(big[0].astype(np.float64), 8, mode="edge").cumsum(0)
               .cumsum(1), ((1, 0), (1, 0)))
    exact = ((c[17:, 17:] - c[:-17, 17:] - c[17:, :-17] + c[:-17, :-17])
             / 289.0)[None]
    jax_err = float(np.max(np.abs(np.asarray(jft._box(big, 8)) - exact)))
    port_err = float(np.max(np.abs(
        tft.box_mean(torch.from_numpy(big), 8).numpy() - exact)))
    assert jax_err > 1e-4, jax_err
    assert port_err <= 1e-8, port_err            # float32 rounding
    small = big[:, :64, :64]
    close(tft.box_mean(torch.from_numpy(small), 8),
          np.asarray(jft._box(small, 8)), 1e-6)


@pytest.mark.parametrize("name,args", [
    ("fix_banding", dict(sigma=1.0, amount=1.0)),
    ("fix_banding", dict(sigma=2.0, amount=0.7, vertical=True)),
    ("fix_banding", dict(sigma=1.0, amount=1.0, protect_highlights=False)),
    ("clahe", dict(clip_limit=2.0, tile_size=8)),
    ("clahe", dict(clip_limit=3.0, tile_size=7)),
    ("clahe", dict(clip_limit=4.0, tile_size=5)),
])
def test_host_filter_bit_equal(name, args):
    """Banding (host numpy) and CLAHE (its tables on the host, counted
    and interpolated on the device in float64) bit-equal; 7 tiles of a
    96² image leave a wider last tile."""
    d = scene(5)
    d += (np.random.default_rng(5).normal(0, 0.01, 96)[None, :, None]
          ).astype(np.float32)                 # row bands
    j, t = pair(np.clip(d, 0, 1))
    kw = dict(device=CPU) if name == "clahe" else {}
    assert np.array_equal(getattr(tft, name)(t, **args, **kw).data,
                          getattr(jft, name)(j, **args).data)


def test_linear_match_bit_equal():
    d = scene(6)
    ref = np.clip(0.8 * d + 0.03, 0, 1)
    j, t = pair(d)
    assert np.array_equal(
        tft.linear_match(t, TImage(data=ref)).data,
        jft.linear_match(j, JImage(data=ref)).data)


@pytest.mark.parametrize("name,args", [
    ("threshlo", (0.1,)), ("threshhi", (0.3,)), ("thresh", (0.08, 0.4)),
    ("nozero", (0.01,)), ("fill", (0.2, (5, 7, 20, 11))), ("fill", (0.5,)),
])
def test_threshold_family_vs_jax(name, args):
    d = scene(7)
    d[:, 10:14, 10:30] = 0.0
    j, t = pair(d)
    close(getattr(tft, name)(t, *args).data,
          getattr(jft, name)(j, *args).data, 1e-6)


@pytest.mark.parametrize("shifted", [True, False])
def test_fftd_ffti_vs_jax(shifted):
    """The modulus within 1e-5, and each coefficient (modulus and phase
    together) within 1e-5 of the maximum.  The phase alone is held to
    1e-5 where the modulus is at least 1e-3 of the maximum: the phase of
    the smallest coefficients carries the FFTs' rounding divided by their
    modulus (1.07e-5 on a coefficient of 5.3e-5 of the maximum here)."""
    d = scene(8, 64)
    j, t = pair(d)
    jm, jp = jft.fftd(j, shifted)
    tm, tp = tft.fftd(t, shifted, device=CPU)
    close(tm.data, jm.data, 1e-5)

    def coef(m, p):
        return m.data * np.exp(2j * np.pi * p.data.astype(np.float64))

    assert np.abs(coef(tm, tp) - coef(jm, jp)).max() <= 1e-5
    big = jm.data >= 1e-3
    close(tp.data[big], jp.data[big], 1e-5)
    assert np.allclose(tm.keywords.extra["FFTNORM"],
                       jm.keywords.extra["FFTNORM"], rtol=1e-5)
    back = tft.ffti(tm, tp, device=CPU).data
    close(back, jft.ffti(jm, jp).data, 1e-5)
    close(back, d, 1e-5)


@pytest.mark.parametrize("ktype", [jwv.WAVELET_LINEAR, jwv.WAVELET_BSPLINE])
def test_atrous_vs_jax(ktype):
    d = scene(9)
    want = jwv.atrous_decompose(d, 5, ktype)
    got = twv.atrous_decompose(torch.from_numpy(d), 5, ktype)
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    coeffs = [1.3, 1.2, 1.0, 0.5, 1.0]
    close(torch.clamp(twv.atrous_reconstruct(got, coeffs), 0, 1),
          np.clip(np.asarray(jwv.atrous_reconstruct(want, coeffs)), 0, 1),
          1e-5)
    close(twv.atrous_reconstruct(got), d, 1e-6)


@pytest.mark.parametrize("mode,vst", [("soft", False), ("bishrink", False),
                                      ("soft", True)])
def test_wavelet_denoise_vs_jax(mode, vst):
    d = scene(10, 64)
    j, t = pair(d)
    close(twv.wavelet_denoise(t, 4, mode=mode, use_vst=vst, device=CPU).data,
          jwv.wavelet_denoise(j, 4, mode=mode, use_vst=vst).data, 1e-5)


def test_wavelet_denoise_hard_vs_jax():
    """Hard thresholding is a step: at thresholds that no coefficient
    lies within 1e-7 of (the planes agree to ~1e-8), the packages agree
    within 1e-5.  (With the automatic thresholds of this scene, one
    coefficient lies 5.6e-9 from layer 3's, whose median differs by one
    float32 step, and flips.)"""
    d = scene(10, 64)
    th = [0.03, 0.012, 0.01, 0.008]
    planes = jwv.atrous_decompose(d, 4)
    assert min(float(np.abs(np.abs(np.asarray(planes[i])) - th[i]).min())
               for i in range(4)) > 1e-7
    j, t = pair(d)
    close(twv.wavelet_denoise(t, 4, th, mode="hard", device=CPU).data,
          jwv.wavelet_denoise(j, 4, th, mode="hard").data, 1e-5)


def test_median_all_even_count():
    """The mean of the middle pair, as jnp.median, for an even count."""
    x = np.random.default_rng(11).random(1000).astype(np.float32)
    import jax.numpy as jnp

    assert float(twv.median_all(torch.from_numpy(x))) == \
        float(jnp.median(jnp.asarray(x)))


def test_anscombe_vs_jax():
    x = np.linspace(-0.2, 40.0, 5001, dtype=np.float32)
    close(twv.anscombe(torch.from_numpy(x)), jwv.anscombe(x), 1e-6)
    y = np.linspace(0.5, 14.0, 5001, dtype=np.float32)
    close(twv.anscombe_inverse_exact(torch.from_numpy(y)),
          jwv.anscombe_inverse_exact(y), 1e-5)


@pytest.mark.parametrize("algo,points,channels", [
    (jcu.CURVE_CUBIC, [(0.0, 0.0), (0.25, 0.4), (0.7, 0.8), (1.0, 1.0)],
     None),
    (jcu.CURVE_LINEAR, [(0.1, 0.0), (0.5, 0.6), (0.9, 1.0)], (0, 2)),
    (jcu.CURVE_CUBIC, [(0.2, 0.3), (0.8, 0.7)], (1,)),
])
def test_curves_vs_jax(algo, points, channels):
    assert np.array_equal(tcu.build_curve_lut(points, algo),
                          jcu.build_curve_lut(points, algo))
    d = scene(12)
    j, t = pair(d)
    close(tcu.apply_curve(t, points, algo, channels, device=CPU).data,
          jcu.apply_curve(j, points, algo, channels).data, 1e-6)


def _sessions(tmp_path, data):
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.context import Session as TSession

    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)
    js.set_image(JImage(data=data.copy()), "x")
    ts.set_image(TImage(data=data.copy()), "x")
    return js, ts


FILTER_COMMANDS = [
    (["ddp", "0.05", "0.3", "1.2"], 1e-5),
    (["thresh", "3000", "30000"], 1e-6),
    (["threshlo", "5000"], 1e-6),
    (["threshhi", "20000"], 1e-6),
    (["nozero", "300"], 1e-6),
    (["fill", "6000", "4", "5", "20", "10"], 1e-6),
    (["ffill", "6000", "4", "5", "20", "10"], 1e-6),
    (["gauss", "1.2"], 1e-5),
    (["unsharp", "1.5", "1.6"], 1e-5),
    (["fmedian", "3", "1"], 1e-6),
    (["clahe", "2", "8"], 0.0),
    (["epf"], 1e-5),
    (["epf", "-d=3", "-si=0.05", "-ss=2", "-mod=0.5"], 1e-5),
    (["epf", "-guided"], 1e-5),
    (["epf", "-guided", "-d=4", "-si=0.05", "-mod=0"], 1e-5),
    (["fixbanding", "1", "1"], 0.0),
    (["fixbanding", "0.5", "2", "-vertical"], 0.0),
    (["unpurple", "-blue=0.05", "-strength=0.5"], 1e-6),
    (["rgradient", "40", "45", "2", "4"], 1e-5),
]


@pytest.mark.parametrize("words,tol", FILTER_COMMANDS,
                         ids=[" ".join(w) for w, _ in FILTER_COMMANDS])
def test_filter_commands_vs_jax(tmp_path, words, tol):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    d = scene(13)
    d[:, 0:3, 0:5] = 0.0
    js, ts = _sessions(tmp_path, d)
    JCMD[words[0]].fn(js, words[1:])
    TCMD[words[0]].fn(ts, words[1:])
    close(ts.image.data, np.asarray(js.image.data), tol)


def test_wavelet_fft_linear_match_commands_vs_jax(tmp_path):
    """wavelet / wrecons, fftd / ffti and linear_match through both
    command tables."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.io.fits_io import write_fits

    d = scene(14, 64)
    write_fits(TImage(data=np.clip(0.9 * d + 0.02, 0, 1)),
               str(tmp_path / "ref.fit"), bitdepth=-32)
    js, ts = _sessions(tmp_path, d)
    for words, tol in ((["wavelet", "4"], None),
                       (["wrecons", "1.3", "1.2", "1", "1"], 1e-5),
                       (["wavelet", "3", "1"], None),
                       (["wrecons", "1", "1", "1"], 1e-5),
                       (["fftd", "fmod", "fphase"], None),
                       (["ffti", "fmod", "fphase"], 1e-5),
                       (["linear_match", "ref", "0", "0.92"], 1e-5)):
        JCMD[words[0]].fn(js, words[1:])
        TCMD[words[0]].fn(ts, words[1:])
        if tol is not None:
            close(ts.image.data, np.asarray(js.image.data), tol)
    close(ts.pm_images["__fft_mod"].data, js.pm_images["__fft_mod"].data,
          1e-5)
