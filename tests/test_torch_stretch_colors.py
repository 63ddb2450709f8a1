"""The port's stretches and colour ops (siril_tpu_torch/ops/stretch.py,
ops/colors.py, the mask blend of core/image.py) against the JAX package on
the CPU, on the same seeded 64² RGB inputs.

Tolerances (absolute, on [0, 1] data unless stated):
- ``neg``: bit-equal;
- ``mtf``, ``invmtf``, ``asinh``, ``linstretch``, ``ccm``, ``scnr`` and
  the colour-space round trips: 2e-6 (XLA:CPU contracts some a·b + c into
  fused multiply-adds that torch rounds twice; a few float32 roundings);
- ``ght`` in all five stretch types and every colour model, ``satu``:
  1e-5 (powers, logs and exponentials of float32 values, each of a few
  ulps in either library, through the GHT's steep segments);
- the torch ``interp`` against ``jnp.interp``: 1e-7.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import colors as jcol
from siril_tpu.ops import stretch as jst
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import colors as tcol
from siril_tpu_torch.ops import stretch as tst

import torch

CPU = "cpu"


def _scene(seed=5, size=64, nch=3):
    """A sky at 0.05-0.12 with noise, a few stars and a gradient."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = 0.05 + 0.07 * xx / size
    data = np.empty((nch, size, size), np.float32)
    for c in range(nch):
        d = base * (0.8 + 0.2 * c) + rng.normal(0, 0.01, (size, size))
        for _ in range(12):
            x0, y0 = rng.uniform(4, size - 4, 2)
            d += rng.uniform(0.1, 0.9) * np.exp(
                -((xx - x0) ** 2 + (yy - y0) ** 2) / 3.0)
        data[c] = np.clip(d, 0.0, 1.0)
    return data


def _pair(data):
    return JImage(data=data.copy()), TImage(data=data.copy())


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol, err


def test_interp_vs_jnp():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 1, 20)).astype(np.float32)
    xp[5] = xp[4]                                 # a repeated knot
    fp = rng.uniform(0, 1, 20).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 5000), xp]).astype(
        np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = tst.interp(torch.from_numpy(x), xp, fp).numpy()
    _close(got, want, 1e-7)


@pytest.mark.parametrize("params", [(0.0, 0.2, 1.0), (0.05, 0.1, 0.9),
                                    (0.02, 0.6, 1.0)])
def test_mtf_invmtf_vs_jax(params):
    data = _scene()
    j, t = _pair(data)
    jp = jst.MTFParams(*params)
    tp = tst.MTFParams(*params)
    _close(tst.apply_mtf(t, tp, device=CPU).data,
           jst.apply_mtf(j, jp).data, 2e-6)
    want = np.clip(np.asarray(jst.mtf_pseudoinverse(j.device(), jp)), 0, 1)
    _close(tst.invmtf(t, tp, device=CPU).data, want, 2e-6)


@pytest.mark.parametrize("linked", [True, False])
def test_autostretch_vs_jax(linked):
    data = _scene(8)
    j, t = _pair(data)
    if linked:
        jp = jst.find_linked_midtones_balance(j)
        tp = tst.find_linked_midtones_balance(t)
        assert (tp.shadows, tp.midtones, tp.highlights) == \
            (jp.shadows, jp.midtones, jp.highlights)
    _close(tst.autostretch(t, linked=linked, device=CPU).data,
           jst.autostretch(j, linked=linked).data, 2e-6)


_GHT_CASES = [(st, B) for st in (tst.STRETCH_PAYNE_NORMAL,
                                 tst.STRETCH_PAYNE_INVERSE)
              for B in (-1.0, -0.5, 0.0, 3.0)] + \
    [(tst.STRETCH_ASINH, 0.0), (tst.STRETCH_INVASINH, 0.0),
     (tst.STRETCH_LINEAR, 0.0)]


@pytest.mark.parametrize("model", [tst.COL_INDEP, tst.COL_HUMANLUM,
                                   tst.COL_EVENLUM, tst.COL_SAT])
@pytest.mark.parametrize("stretchtype,B", _GHT_CASES)
def test_ght_vs_jax(stretchtype, B, model):
    data = _scene(11)
    j, t = _pair(data)
    kw = dict(B=B, D=4.0, LP=0.02, SP=0.08, HP=0.9, BP=0.03,
              stretchtype=stretchtype, payne_colourstretchmodel=model)
    _close(tst.apply_ght(t, tst.GHTParams(**kw), device=CPU).data,
           jst.apply_ght(j, jst.GHTParams(**kw)).data, 1e-5)


def test_ght_setup_same_coefficients():
    for st, B in _GHT_CASES:
        a = vars(tst.ght_setup(B, 4.0, 0.02, 0.08, 0.9, st))
        b = vars(jst.ght_setup(B, 4.0, 0.02, 0.08, 0.9, st))
        assert a == b


@pytest.mark.parametrize("human,offset", [(False, 0.0), (True, 0.02)])
@pytest.mark.parametrize("nch", [1, 3])
def test_asinh_linstretch_vs_jax(human, offset, nch):
    data = _scene(13, nch=nch)
    j, t = _pair(data)
    _close(tst.asinh_stretch(t, 50.0, offset, human_luminance=human,
                             device=CPU).data,
           jst.asinh_stretch(j, 50.0, offset, human_luminance=human).data,
           2e-6)
    _close(tst.linstretch(t, 0.04, device=CPU).data,
           jst.linstretch(j, 0.04).data, 2e-6)


@pytest.mark.parametrize("algo", ["spline", "linear"])
def test_curve_vs_jax(algo):
    data = _scene(17)
    j, t = _pair(data)
    pts = [(0.0, 0.0), (0.1, 0.3), (0.5, 0.7), (1.0, 1.0)]
    _close(tst.apply_curve(t, pts, algo, device=CPU).data,
           jst.apply_curve(j, pts, algo).data, 2e-6)


def test_colour_space_round_trips_vs_jax():
    data = _scene(19)
    r, g, b = (torch.from_numpy(data[c]) for c in range(3))
    jr, jg, jb = (jnp.asarray(data[c]) for c in range(3))
    for fwd, inv, jfwd, jinv in (
            (tcol.rgb_to_hsl, tcol.hsl_to_rgb, jcol.rgb_to_hsl,
             jcol.hsl_to_rgb),
            (tcol.rgb_to_hsv, tcol.hsv_to_rgb, jcol.rgb_to_hsv,
             jcol.hsv_to_rgb),
            (tcol.rgb_to_xyz, tcol.xyz_to_rgb, jcol.rgb_to_xyz,
             jcol.xyz_to_rgb)):
        tf, jf = fwd(r, g, b), jfwd(jr, jg, jb)
        for a, w in zip(tf, jf):
            _close(a.numpy(), w, 2e-6)
        for a, w in zip(inv(*tf), jinv(*jf)):
            _close(a.numpy(), w, 2e-6)
    # Lab: L in [0, 100], a and b in about ±128 (2e-6 relative)
    tl = tcol.xyz_to_lab(*tcol.rgb_to_xyz(r, g, b))
    jl = jcol.xyz_to_lab(*jcol.rgb_to_xyz(jr, jg, jb))
    for a, w in zip(tl, jl):
        _close(a.numpy() / 100.0, np.asarray(w) / 100.0, 2e-6)
    for a, w in zip(tcol.xyz_to_rgb(*tcol.lab_to_xyz(*tl)),
                    jcol.xyz_to_rgb(*jcol.lab_to_xyz(*jl))):
        _close(a.numpy(), w, 2e-6)


@pytest.mark.parametrize("kind,preserve,amount",
                         [("avgneutral", True, 1.0),
                          ("maxneutral", True, 1.0),
                          ("avgneutral", False, 0.5),
                          ("maxneutral", False, 1.0)])
def test_scnr_vs_jax(kind, preserve, amount):
    data = _scene(23)
    data[1] *= 1.3
    j, t = _pair(np.clip(data, 0, 1))
    _close(tcol.scnr(t, kind, amount, preserve, device=CPU).data,
           jcol.scnr(j, kind, amount, preserve).data, 2e-6)


@pytest.mark.parametrize("bkg,hues", [(0.0, (0, 360)), (1.0, (0, 360)),
                                      (1.0, (330, 30)), (0.5, (90, 150))])
def test_satu_vs_jax(bkg, hues):
    data = _scene(29)
    j, t = _pair(data)
    _close(tcol.saturation(t, 0.6, bkg, *hues, device=CPU).data,
           jcol.saturation(j, 0.6, bkg, *hues).data, 1e-5)


def test_neg_ccm_vs_jax():
    data = _scene(31)
    j, t = _pair(data)
    assert np.array_equal(tcol.negative(t, device=CPU).data,
                          np.asarray(jcol.negative(j).data))
    m = [1.1, -0.05, -0.05, -0.1, 1.2, -0.1, 0.0, -0.1, 1.1]
    for gamma in (1.0, 2.2):
        _close(tcol.apply_ccm(t, m, gamma, device=CPU).data,
               jcol.apply_ccm(j, m, gamma).data, 2e-6)


@pytest.mark.parametrize("space", ["rgb", "hsl", "hsv", "lab"])
def test_split_rgbcomp_vs_jax(space):
    data = _scene(37)
    j, t = _pair(data)
    for a, w in zip(tcol.split_channels(t, space, device=CPU),
                    jcol.split_channels(j, space)):
        assert a.keywords.filter == w.keywords.filter
        _close(a.data, w.data, 2e-6)
    tr, tg, tb = (TImage(data=data[c:c + 1].copy()) for c in range(3))
    jr, jg, jb = (JImage(data=data[c:c + 1].copy()) for c in range(3))
    assert np.array_equal(tcol.rgb_compose(tr, tg, tb, device=CPU).data,
                          jcol.rgb_compose(jr, jg, jb).data)
    lum = _scene(41, nch=1)
    _close(tcol.rgb_compose(tr, tg, tb, TImage(data=lum), device=CPU).data,
           jcol.rgb_compose(jr, jg, jb, JImage(data=lum)).data, 2e-6)


def test_mask_blend_vs_jax():
    """A mask set on both images: every op's result is blended through it
    (m·new + (1 − m)·old) on the result's device."""
    data = _scene(43)
    j, t = _pair(data)
    mask = np.random.default_rng(3).uniform(0, 1, data.shape[1:]).astype(
        np.float32)
    for im in (j, t):
        im.mask, im.mask_active = mask.copy(), True
    _close(tst.apply_mtf(t, tst.MTFParams(0.0, 0.2, 1.0), device=CPU).data,
           jst.apply_mtf(j, jst.MTFParams(0.0, 0.2, 1.0)).data, 2e-6)
    _close(tcol.negative(t, device=CPU).data, jcol.negative(j).data, 2e-6)
    out = tcol.negative(t, device=CPU)
    assert out.mask_active and np.array_equal(out.mask, mask)
    t.mask_active = False
    assert np.array_equal(tcol.negative(t, device=CPU).data, 1.0 - data)


def test_align_rgb_raises(monkeypatch):
    """Without a card and without ``device="cpu"`` the channel alignment
    raises (no fallback); a mono image is returned as it is, as in the
    JAX package.  The alignment itself is held against the JAX package
    in tests/test_torch_planetary.py::test_commands_vs_jax."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = TImage(data=_scene(47))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcol.align_rgb_channels(t)
    mono = TImage(data=_scene(47)[:1])
    assert tcol.align_rgb_channels(mono) is mono
    assert jcol.align_rgb_channels(JImage(data=_scene(47)[:1])).nchans == 1
