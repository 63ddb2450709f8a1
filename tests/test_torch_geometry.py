"""The port's single-image geometry (siril_tpu_torch/ops/geometry.py and
its commands) against the JAX package on the CPU, on seeded RGB inputs.

Tolerances: ``crop``, ``mirrorx``, ``mirrory`` and the turns by multiples
of 90°: bit-equal; ``binxy``: one float32 rounding (1.2e-7; the port adds
each block in numpy's order, and is bit-equal on these inputs);
``rotate`` at other angles: 2e-6, the gather warp's bound against the JAX
warp (tests/test_torch_interp.py).
"""

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import geometry as jgeo
from siril_tpu.ops.wcs import WCS as JWCS
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import geometry as tgeo
from siril_tpu_torch.ops.interp import INTERP_BILINEAR, INTERP_LANCZOS4
from siril_tpu_torch.ops.wcs import WCS as TWCS

CPU = "cpu"


def _data(seed=3, h=72, w=96):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    d += 0.5 * np.exp(-((xx - 40.3) ** 2 + (yy - 30.7) ** 2) / 20.0)
    return np.clip(d * 0.6, 0, 1).astype(np.float32)


def _wcs(cls, h):
    s = 1.5 / 3600.0
    return cls(crpix=(48.5, 36.5), crval=(120.0, 30.0),
               cd=np.array([[-s, 0.0], [0.0, s]]), height=h)


def test_crop_mirror_vs_jax():
    d = _data()
    j, t = JImage(data=d.copy()), TImage(data=d.copy())
    j.wcs, t.wcs = _wcs(JWCS, 72), _wcs(TWCS, 72)
    for args in ((10, 5, 40, 30), (-3, 60, 500, 40), (90, 70, 20, 20)):
        a, b = tgeo.crop(t, *args, device=CPU), jgeo.crop(j, *args)
        assert np.array_equal(a.data, b.data)
        assert a.history[-1] == b.history[-1]
        assert a.wcs.crpix == b.wcs.crpix
    assert np.array_equal(tgeo.mirrorx(t, device=CPU).data,
                          jgeo.mirrorx(j).data)
    assert np.array_equal(tgeo.mirrory(t, device=CPU).data,
                          jgeo.mirrory(j).data)


@pytest.mark.parametrize("factor", [2, 3, 5, 9])
@pytest.mark.parametrize("mean", [True, False])
def test_binxy_vs_jax(factor, mean):
    d = _data(5, 90, 117)
    a = tgeo.binxy(TImage(data=d.copy()), factor, mean, device=CPU)
    b = jgeo.binxy(JImage(data=d.copy()), factor, mean)
    assert a.data.shape == b.data.shape
    assert float(np.max(np.abs(a.data - b.data))) <= 1.2e-7
    assert a.keywords.extra["XBINNING"] == b.keywords.binning_x == factor


@pytest.mark.parametrize("angle,method,nocrop",
                         [(90.0, INTERP_LANCZOS4, False),
                          (180.0, INTERP_LANCZOS4, False),
                          (-90.0, INTERP_LANCZOS4, False),
                          (12.5, INTERP_LANCZOS4, False),
                          (12.5, INTERP_LANCZOS4, True),
                          (-33.0, INTERP_BILINEAR, True)])
def test_rotate_vs_jax(angle, method, nocrop):
    d = _data(7)
    a = tgeo.rotate(TImage(data=d.copy()), angle, method,
                    crop_to_fit=not nocrop, device=CPU)
    b = jgeo.rotate(JImage(data=d.copy()), angle, method,
                    crop_to_fit=not nocrop)
    assert a.data.shape == np.asarray(b.data).shape
    if angle % 90.0 == 0.0:
        assert np.array_equal(a.data, b.data)
    else:
        assert float(np.max(np.abs(a.data - b.data))) <= 2e-6


def test_geometry_commands_vs_jax(tmp_path):
    """crop, rotate, rotatepi, mirrorx, mirrory, binxy and resample
    through both packages' command tables, one after the other."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    d = _data(9)
    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)
    js.set_image(JImage(data=d.copy()), "x")
    ts.set_image(TImage(data=d.copy()), "x")
    for words in (["crop", "4", "6", "80", "60"], ["mirrorx"], ["mirrory"],
                  ["rotatepi"], ["rotate", "7.5", "-interp=bilinear"],
                  ["rotate", "90"], ["binxy", "2"], ["resample", "0.5"]):
        JCMD[words[0]].fn(js, words[1:])
        TCMD[words[0]].fn(ts, words[1:])
        a, b = ts.image.data, np.asarray(js.image.data)
        assert a.shape == b.shape, words
        assert float(np.max(np.abs(a - b))) <= 2e-6, words
