"""The port's deconvolution and blind PSF estimation
(siril_tpu_torch/ops/deconvolution.py, blind_deconv.py) against the JAX
package on the CPU, on the same seeded inputs, and the ``makepsf``, ``rl``,
``wiener`` and ``sb`` commands through both packages' command tables.

Bounds: the synthetic PSFs bit-equal (host numpy in both); the PSF from
stars 1e-6 (the same stars from each package's finder, host medians);
Richardson–Lucy (20 iterations plain and by gradient descent, 5 with TV,
the early stop), Wiener and split-Bregman 1e-5 on [0, 1] data (float32
FFTs in another library); 20 TV iterations by the mean and largest |Δ|
(test_richardson_lucy_tv_20_vs_jax); the ℓ0 engine's pieces (one step
of the latent update, one kernel update) 1e-5 and its kernel a cosine
similarity of at least 0.99 with the JAX package's; the spectral
engine's HIO and ER steps 1e-6 and its kernel by its effect
(test_blind_si_vs_jax).
"""

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import blind_deconv as jbd
from siril_tpu.ops import deconvolution as jdc
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import blind_deconv as tbd
from siril_tpu_torch.ops import deconvolution as tdc

torch.set_num_threads(1)

CPU = "cpu"


def star_field(seed=21, size=128, nstars=40, sigma=1.8, noise=0.004,
               nch=3):
    """Gaussian stars of σ ``sigma`` on a sky of 0.1 with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    sx = rng.uniform(20, size - 20, nstars)
    sy = rng.uniform(20, size - 20, nstars)
    amp = rng.uniform(0.1, 0.7, nstars)
    base = np.full((size, size), 0.1)
    for x, y, a in zip(sx, sy, amp):
        base += a * np.exp(-((xx + 0.5 - x) ** 2 + (yy + 0.5 - y) ** 2)
                           / (2 * sigma * sigma))
    data = np.empty((nch, size, size), np.float32)
    for c in range(nch):
        data[c] = np.clip(base * (0.9 + 0.1 * c)
                          + rng.normal(0, noise, base.shape), 0, 1)
    return data


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err


@pytest.mark.parametrize("kind,kw", [
    (jdc.PSF_GAUSSIAN, dict(size=31, fwhm=4.0)),
    (jdc.PSF_GAUSSIAN, dict(size=15, fwhm=3.0, ratio=0.6, angle_deg=30)),
    (jdc.PSF_MOFFAT, dict(size=21, fwhm=4.0, beta=3.0)),
    (jdc.PSF_DISC, dict(size=15, diameter=7.0)),
    (jdc.PSF_AIRY, dict(size=31, diameter=5.0)),
    (jdc.PSF_AIRY, dict(size=31, diameter=5.0, obstruction=0.3)),
])
def test_make_psf_bit_equal(kind, kw):
    assert np.array_equal(tdc.make_psf(kind, **kw), jdc.make_psf(kind, **kw))


def test_psf_from_stars_vs_jax():
    d = star_field(22, 160, 30)
    got = tdc.psf_from_stars(TImage(data=d), device=CPU)
    want = jdc.psf_from_stars(JImage(data=d))
    close(got, want, 1e-6)


PSF = jdc.make_psf(jdc.PSF_GAUSSIAN, size=15, fwhm=4.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(tv_alpha=0.01, iterations=5),
    dict(multiplicative=False, step=0.0002),
    dict(stop_delta=5.5e-4, iterations=40),
])
def test_richardson_lucy_vs_jax(kw):
    d = star_field(23)
    got = tdc.richardson_lucy(TImage(data=d), PSF, device=CPU, **kw).data
    want = jdc.richardson_lucy(JImage(data=d), PSF, **kw).data
    close(got, want, 1e-5)


def test_richardson_lucy_tv_20_vs_jax():
    """With TV, the divergence term divides the gradient by its own
    magnitude (+1e-8), so the packages' float32 differences grow from
    iteration to iteration (2.4e-7 after 1, 9.5e-7 after 5, 8.0e-6 after
    10, 4.3e-4 after 20 on this field, at 0.3 % of the pixels past 1e-5):
    after 20 iterations the mean |Δ| is held to 1e-6 (2.6e-7 here) and
    the largest to 1e-3."""
    d = star_field(23)
    got = tdc.richardson_lucy(TImage(data=d), PSF, 20, tv_alpha=0.01,
                              device=CPU).data
    want = jdc.richardson_lucy(JImage(data=d), PSF, 20, tv_alpha=0.01).data
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.mean() <= 1e-6, diff.mean()
    assert diff.max() <= 1e-3, diff.max()


def test_rl_early_stop_iterations():
    """-stop ends the loop at the first iteration whose mean update is
    at most stop_delta, as the JAX while_loop does: on this field the
    16th update is the first below 5.5e-4 (5.33e-4; the 15th 5.67e-4),
    and the result is a run of exactly 16 iterations."""
    d = torch.from_numpy(star_field(23))
    stopped = tdc.richardson_lucy_tensor(d, PSF, 40, stop_delta=5.5e-4)
    n = next(n for n in range(1, 41) if torch.equal(
        stopped, tdc.richardson_lucy_tensor(d, PSF, n)))
    assert n == 16


@pytest.mark.parametrize("alpha", [1.0 / 500.0, 0.05])
def test_wiener_vs_jax(alpha):
    d = star_field(24)
    close(tdc.wiener(TImage(data=d), PSF, alpha, device=CPU).data,
          jdc.wiener(JImage(data=d), PSF, alpha).data, 1e-5)


@pytest.mark.parametrize("lam,iters", [(3000.0, 10), (500.0, 4)])
def test_split_bregman_vs_jax(lam, iters):
    d = star_field(25)
    close(tdc.split_bregman_tv(TImage(data=d), PSF, lam, iters,
                               device=CPU).data,
          jdc.split_bregman_tv(JImage(data=d), PSF, lam, iters).data, 1e-5)


def blurred_scene(seed=31, size=160):
    """tests/test_blind_deconv.py's scene blurred by its 7×7 kernel."""
    from tests.test_blind_deconv import blur, make_scene, true_kernel7

    rng = np.random.default_rng(seed)
    v = blur(make_scene(rng, size, size), true_kernel7())
    return (v + rng.normal(0, 5e-4, v.shape)).astype(np.float32)


def test_l0_pieces_vs_jax():
    """One step of the latent update (β from 6e4, so the loop runs once;
    λ puts the hard threshold λ/β at 1e-4, inside the gradients' range,
    and no pixel's |∇v|² lies within 1e-9 of it) and one kernel update of
    the ℓ0 engine on the same inputs.  Over the whole β ladder (26 steps
    from 2λ) a gradient near the threshold flips and the latent images
    part by up to 5e-3, as in the reference's C++ against itself with
    another FFT."""
    import jax.numpy as jnp

    v = jbd._grey(blurred_scene())[:96, :96].copy()
    h, w = v.shape
    u_j, k_j = jbd._l0_fns(h, w, 15)
    k = jbd._kernel_cleanup(np.asarray(k_j(jnp.asarray(v), jnp.asarray(v),
                                           20.0)))
    otf = jbd._psf2otf_np(k, (h, w))
    beta = 6e4
    lam = 1e-4 * beta
    gx = np.roll(v, -1, 1).astype(np.float64) - v
    gy = np.roll(v, -1, 0).astype(np.float64) - v
    assert np.abs(gx * gx + gy * gy - lam / beta).min() > 1e-9
    want_u = np.asarray(u_j(jnp.asarray(v), jnp.asarray(otf),
                            jnp.float32(lam), jnp.float32(beta)))
    got_u = tbd.l0_u_update(torch.from_numpy(v), tbd._c64(otf, "cpu"),
                            lam, beta).numpy()
    close(got_u, want_u, 1e-5)
    want_k = np.asarray(k_j(jnp.asarray(want_u), jnp.asarray(v), 20.0))
    got_k = tbd.l0_k_update(torch.from_numpy(want_u), torch.from_numpy(v),
                            20.0, 15).numpy()
    close(got_k, want_k, 1e-5)


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def truth_cosine(k):
    """The best cosine similarity of ``k`` with the scene's true kernel
    over shifts of up to a pixel (the centroid recentring may differ by
    one)."""
    from tests.test_blind_deconv import _embed, true_kernel7

    kt = _embed(true_kernel7(), k.shape[0])
    return max(cosine(np.roll(k, (dy, dx), (0, 1)), kt)
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))


@pytest.mark.parametrize("multiscale", [False, True])
def test_blind_l0_vs_jax(multiscale):
    v = blurred_scene()
    want = jbd.estimate_kernel_blind(v, 15, "l0", multiscale)
    got = tbd.estimate_kernel_blind(v, 15, "l0", multiscale, device=CPU)
    assert got.shape == want.shape == (15, 15)
    assert cosine(got, want) >= 0.99, cosine(got, want)


def test_pr_steps_vs_jax():
    """One HIO and one error-reduction step of the spectral engine on
    the same inputs."""
    import jax.numpy as jnp

    v = jbd._best_patch(jbd._grey(blurred_scene()), 128)
    mag, n = jbd._kernel_spectrum(v, 15)
    sup = np.zeros((n, n), bool)
    sup[:5, :5] = sup[-4:, :5] = sup[:5, -4:] = sup[-4:, -4:] = True
    g = np.random.default_rng(1).random((n, n)).astype(np.float32) * sup
    step, er = jbd._pr_step_fns(n, 15)
    mt, st = torch.from_numpy(mag.astype(np.float32)), torch.from_numpy(sup)
    close(tbd.pr_step(torch.from_numpy(g), mt, st, 0.9),
          step(jnp.asarray(g), jnp.asarray(mag), jnp.asarray(sup),
               jnp.float32(0.9)), 1e-6)
    close(tbd.pr_er(torch.from_numpy(g), mt, st),
          er(jnp.asarray(g), jnp.asarray(mag), jnp.asarray(sup)), 1e-6)


def test_blind_si_vs_jax():
    """The spectral engine by its effect.  Its 160 phase-retrieval
    steps amplify the packages' FFT roundings (7e-9 after one HIO step,
    1.4e-5 after 20, 1e-2 after 50: the iteration is chaotic), so the
    restarts land on other candidates and the kernels' cosine with each
    other is 0.84 on this scene, not the 0.99 asked of the ℓ0 engine.
    Held instead: each package's kernel recovers the true one, the
    port's no worse than the JAX package's by more than 0.05 of cosine
    (0.94 against 0.91 here)."""
    v = blurred_scene()
    want = jbd.estimate_kernel_blind(v, 15, "si")
    got = tbd.estimate_kernel_blind(v, 15, "si", device=CPU)
    assert got.shape == want.shape == (15, 15)
    assert truth_cosine(got) >= truth_cosine(want) - 0.05, (
        truth_cosine(got), truth_cosine(want))


def _sessions(tmp_path, data):
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.context import Session as TSession

    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)
    js.set_image(JImage(data=data.copy()), "x")
    ts.set_image(TImage(data=data.copy()), "x")
    return js, ts


def test_deconvolution_commands_vs_jax(tmp_path):
    """The makepsf forms (manual, save, load, stars, clear) and rl,
    wiener, sb through both command tables; rl with no flag keeps the
    star PSF, and any flag makes a new Gaussian (the reference
    behaviour that the JAX package has)."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    d = star_field(26, 160, 30)
    js, ts = _sessions(tmp_path, d)
    script = [
        (["makepsf", "manual", "-moffat", "-fwhm=3", "-beta=2.5", "-ks=15",
          "-savepsf=mpsf.fit"], "psf"),
        (["makepsf", "save", "saved_psf.fit"], None),
        (["makepsf", "clear"], None),
        (["makepsf", "load", "saved_psf.fit"], "psf"),
        (["wiener"], "image"),
        (["makepsf", "stars"], "psf"),
        (["rl"], "image"),
        (["rl", "-iters=5", "-alpha=0.01"], "image"),
        (["rl", "-gdstep=0.0002", "-iters=5"], "image"),
        (["sb", "-iters=3"], "image"),
        (["wiener", "-alpha=100", "-fwhm=3"], "image"),
        (["rl", "-loadpsf=mpsf.fit", "-iters=3"], "image"),
    ]
    for words, what in script:
        JCMD[words[0]].fn(js, words[1:])
        TCMD[words[0]].fn(ts, words[1:])
        if what == "psf":
            close(ts.psf, js.psf, 1e-6)
        elif what == "image":
            close(ts.image.data, np.asarray(js.image.data), 1e-5)
    assert ts.psf is not None


def test_makepsf_blind_command_vs_jax(tmp_path):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    js, ts = _sessions(tmp_path, blurred_scene()[None])
    JCMD["makepsf"].fn(js, ["blind", "-ks=11"])
    TCMD["makepsf"].fn(ts, ["blind", "-ks=11"])
    assert cosine(ts.psf, js.psf) >= 0.99
    # the spectral engine by its effect (test_blind_si_vs_jax)
    JCMD["makepsf"].fn(js, ["blind", "-si", "-ks=11", "-comp=0.5"])
    TCMD["makepsf"].fn(ts, ["blind", "-si", "-ks=11", "-comp=0.5"])
    assert ts.psf.shape == js.psf.shape == (11, 11)
    assert truth_cosine(ts.psf) >= truth_cosine(js.psf) - 0.05
