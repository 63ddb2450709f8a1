"""The port's background extraction (siril_tpu_torch/ops/background.py,
``subsky``) against the JAX package on the CPU, on a seeded RGB field with
a quadratic sky gradient and stars.

Tolerances: the samples (host numpy medians): bit-equal; the polynomial
and RBF models and the ``subsky`` results: 1e-5 absolute (float32 sums
of 15 terms or of one term a sample — ~400 at the default grid — in
another order than XLA's dot; the RBF's weights cancel to a smooth
surface, so its sum carries a few hundred ulps of its largest term).
"""

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import background as jbg
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import background as tbg

CPU = "cpu"
TOL = 1e-5


def _field(seed=4, h=128, w=160):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    u, v = xx / w - 0.4, yy / h - 0.55
    out = np.empty((3, h, w), np.float32)
    for c in range(3):
        sky = 0.1 * (1.0 + 0.2 * (u * u + 0.5 * v * v + 0.3 * u * v)
                     + 0.05 * c)
        d = sky + rng.normal(0, 0.004, (h, w))
        for _ in range(30):
            x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
            d += rng.uniform(0.05, 0.6) * np.exp(
                -((xx - x0) ** 2 + (yy - y0) ** 2) / 4.0)
        out[c] = np.clip(d, 0, 1)
    return out


def test_samples_bit_equal():
    d = _field()
    for nb, tol in ((20, 1.0), (10, 0.5)):
        a = tbg.generate_samples(d[0], nb, tol)
        b = jbg.generate_samples(d[0], nb, tol)
        assert [(s.x, s.y, s.median, s.valid) for s in a] == \
            [(s.x, s.y, s.median, s.valid) for s in b]


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_poly_model_vs_jax(degree):
    d = _field(6)
    s = jbg.generate_samples(d[1], 20, 1.0)
    want = jbg.compute_background_poly(s, d.shape[1:], degree)
    got = tbg.compute_background_poly(s, d.shape[1:], degree, CPU).numpy()
    assert float(np.max(np.abs(got - want))) <= TOL


@pytest.mark.parametrize("smoothing", [0.5, 0.1])
def test_rbf_model_vs_jax_in_blocks(smoothing):
    """Whole, and in blocks of a few rows (the card's bounded path)."""
    d = _field(8)
    s = jbg.generate_samples(d[2], 20, 1.0)
    want = jbg.compute_background_rbf(s, d.shape[1:], smoothing)
    whole = tbg.compute_background_rbf(s, d.shape[1:], smoothing, CPU)
    n = sum(1 for x in s if x.valid)
    rows = tbg.compute_background_rbf(s, d.shape[1:], smoothing, CPU,
                                      block_elems=3 * d.shape[2] * n)
    assert float(np.max(np.abs(whole.numpy() - want))) <= TOL
    assert np.array_equal(whole.numpy(), rows.numpy())


@pytest.mark.parametrize("kw", [dict(method=0, degree=2),
                                dict(method=0, degree=4, correction=1),
                                dict(method=1, smoothing=0.5),
                                dict(method=0, degree=1, dither=True,
                                     nb_samples=12, tolerance=2.0)])
def test_extract_background_vs_jax(kw):
    d = _field(10)
    a = tbg.extract_background(TImage(data=d.copy()), device=CPU, **kw)
    b = jbg.extract_background(JImage(data=d.copy()), **kw)
    assert float(np.max(np.abs(a.data - b.data))) <= TOL
    assert a.history[-1] == b.history[-1]


def test_subsky_removes_gradient():
    """A 2nd-degree model takes the quadratic sky down to the noise."""
    d = _field(12)
    out = tbg.extract_background(TImage(data=d.copy()), degree=2,
                                 device=CPU).data
    for c in range(3):
        before = np.percentile(d[c], 50, axis=0)
        after = np.percentile(out[c], 50, axis=0)
        assert np.ptp(after) < 0.5 * np.ptp(before)
