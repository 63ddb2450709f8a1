"""The port's NL-Bayes and DA3D denoisers (siril_tpu_torch/ops/nlbayes.py,
da3d.py) and the ``denoise`` command against the JAX package on the CPU,
on the same seeded noisy scenes.

Bounds:
- one NL-Bayes pass at a fixed candidate selection: the second pass's
  form (A = C + σ²I) 1e-5; the first pass's (A = C + 1e-8·I, where C,
  the covariance of 24 patches of 25 pixels, has rank ≤ 23) is an
  ill-conditioned float32 solve that puts both packages ~1e-2 from a
  float64 evaluation of the same pass (8.6e-3 the JAX package, 3.7e-3
  the port; 1.1e-2 between them, 6.4e-4 on average): held to at most
  twice the JAX package's distance from the float64 pass, and 1e-3 on
  average between them;
- the DA3D patch step: 1e-5; the whole refinement of a layer: 1e-5 on
  average and 1e-3 at most (a pixel whose summed weight k² is near the
  1e-6 floor divides two tiny sums: 1.6e-4 there, 1.7e-6 on average);
- the whole ``nlbayes_denoise`` (plain, VST, SOS) and ``denoise
  -da3d``: the error against the clean scene within 5 % of the JAX
  package's, and the mean |Δ| between the packages at most 5e-3 (the
  first pass's solve, above: 4.0e-4 plain, 7.7e-4 with the VST, 1.5e-3
  with SOS, 3.7e-3 with DA3D on these scenes of noise σ 0.03);
- ``denoise -mod=``: the blend of each package's result within 1e-6 of
  the blend computed from it.
"""

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import da3d as jda
from siril_tpu.ops import nlbayes as jnl
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import da3d as tda
from siril_tpu_torch.ops import nlbayes as tnl

torch.set_num_threads(1)

CPU = "cpu"


def clean_scene(seed=41, size=64, nch=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    base = 0.2 + 0.3 * xx / size + 0.1 * np.sin(yy / 7.0)
    base[size // 2:, size // 3:] += 0.15                  # an edge
    for _ in range(10):
        x0, y0 = rng.uniform(6, size - 6, 2)
        base += rng.uniform(0.1, 0.4) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / 5.0)
    return np.clip(np.repeat(base[None], nch, 0), 0, 1).astype(np.float32)


def noisy(clean, sigma=0.03, seed=42):
    rng = np.random.default_rng(seed)
    return np.clip(clean + rng.normal(0, sigma, clean.shape), 0,
                   1).astype(np.float32)


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err


def fixed_selection(guide, k=5, M=24, search=13, stride=3):
    """Each reference's M nearest candidates by float64 distances, ties
    to the lower index — [Nr, M] indices into the search window."""
    g = torch.from_numpy(guide).double()
    H, W = g.shape
    hp, wp = H - k + 1, W - k + 1
    P = tnl._unfold(g, k)
    ry = torch.arange(0, hp, stride)
    rx = torch.arange(0, wp, stride)
    ref_y = ry.repeat_interleave(rx.numel())
    ref_x = rx.repeat(ry.numel())
    oy, ox = tnl.candidate_offsets(search, "cpu")
    cy = torch.clamp(ref_y[:, None] + oy, 0, hp - 1)
    cx = torch.clamp(ref_x[:, None] + ox, 0, wp - 1)
    d2 = ((P[cy * wp + cx] - P[ref_y * wp + ref_x][:, None]) ** 2).sum(-1)
    return torch.sort(d2, dim=1, stable=True).indices[:, :M]


@pytest.mark.parametrize("guide_is_noisy", [True, False])
def test_nlb_pass_fixed_selection_vs_jax(monkeypatch, guide_is_noisy):
    import jax
    import jax.numpy as jnp

    c = clean_scene(43, 48)[0]
    x = noisy(c[None], 0.03, 44)[0]
    guide = x if guide_is_noisy else np.clip(
        c + 0.003 * np.random.default_rng(45).standard_normal(c.shape),
        0, 1).astype(np.float32)
    top = fixed_selection(guide)
    monkeypatch.setattr(jax.lax, "top_k",
                        lambda a, m: (None, jnp.asarray(top.numpy())))
    want = np.asarray(jnl._nlb_pass(jnp.asarray(x), jnp.asarray(guide), 0.03,
                                    5, 24, 13, 3, guide_is_noisy))
    got = tnl._nlb_pass(torch.from_numpy(x), torch.from_numpy(guide), 0.03,
                        5, 24, 13, 3, guide_is_noisy, top=top).numpy()
    if not guide_is_noisy:
        close(got, want, 1e-5)
        return
    exact = tnl._nlb_pass(torch.from_numpy(x).double(),
                          torch.from_numpy(guide).double(), 0.03, 5, 24, 13,
                          3, True, top=top).numpy()
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max()
    assert np.abs(got.astype(np.float64) - want).mean() <= 1e-3


def test_nlb_pass_blocks(monkeypatch):
    """Blocks of one reference row give the whole grid's result (the
    aggregation adds in another order: 1e-6)."""
    x = noisy(clean_scene(46, 40), 0.03, 47)[0]
    xt = torch.from_numpy(x)
    whole = tnl._nlb_pass(xt, xt, 0.03, 5, 24, 13, 3, True)
    monkeypatch.setattr(tnl, "REF_BLOCK", 1)
    close(tnl._nlb_pass(xt, xt, 0.03, 5, 24, 13, 3, True), whole, 1e-6)


def _held_by_effect(got, want, clean):
    err_p = float(np.sqrt(np.mean((got.astype(np.float64) - clean) ** 2)))
    err_j = float(np.sqrt(np.mean((want.astype(np.float64) - clean) ** 2)))
    assert err_p <= 1.05 * err_j, (err_p, err_j)
    assert float(np.mean(np.abs(got.astype(np.float64) - want))) <= 5e-3


@pytest.mark.parametrize("kw", [dict(), dict(use_vst=True),
                                dict(sos_iters=1)])
def test_nlbayes_denoise_vs_jax(kw):
    c = clean_scene(48, 64)
    x = noisy(c, 0.03, 49)
    got = tnl.nlbayes_denoise(TImage(data=x), device=CPU, **kw).data
    want = jnl.nlbayes_denoise(JImage(data=x), **kw).data
    _held_by_effect(got, want, c)
    assert np.sqrt(np.mean((got - c) ** 2)) < np.sqrt(np.mean((x - c) ** 2))


def test_estimate_noise_sigma_bit_equal():
    x = noisy(clean_scene(50, 64), 0.02, 51)[0]
    assert tnl.estimate_noise_sigma(x) == jnl.estimate_noise_sigma(x)


def test_da3d_patch_step_vs_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(52)
    c = clean_scene(53, 160)[0]
    x = noisy(c[None], 0.03, 54)[0]
    g = np.clip(c + 0.005 * rng.standard_normal(c.shape), 0, 1).astype(
        np.float32)
    ys, xs = rng.integers(0, 96, 6), rng.integers(0, 96, 6)
    py = np.stack([x[a:a + 64, b:b + 64] for a, b in zip(ys, xs)])
    pg = np.stack([g[a:a + 64, b:b + 64] for a, b in zip(ys, xs)])
    wc, ww = jda._da3d_fn(64, 31, 0.7, 14.0)(jnp.asarray(py), jnp.asarray(pg),
                                             jnp.float32(0.03))
    tc, tw = tda.da3d_patches(torch.from_numpy(py), torch.from_numpy(pg),
                              0.03, 31, 0.7, 14.0)
    close(tc, wc, 1e-5)
    close(tw, ww, 1e-5)


def test_da3d_vs_jax():
    """The whole refinement of one layer on the same guide: the
    on-device unfold / fold against the host loops."""
    c = clean_scene(55, 100)[0]
    x = noisy(c[None], 0.03, 56)[0]
    g = np.clip(c + 0.005 * np.random.default_rng(57).standard_normal(
        c.shape), 0, 1).astype(np.float32)
    diff = np.abs(tda.da3d(x, g, 0.03, device=CPU).numpy().astype(
        np.float64) - jda.da3d(x, g, 0.03))
    assert diff.mean() <= 1e-5, diff.mean()
    assert diff.max() <= 1e-3, diff.max()


def _sessions(tmp_path, data):
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.context import Session as TSession

    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)
    js.set_image(JImage(data=data.copy()), "x")
    ts.set_image(TImage(data=data.copy()), "x")
    return js, ts


def test_denoise_da3d_command_vs_jax(tmp_path):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    c = clean_scene(58, 72)
    x = noisy(c, 0.03, 59)
    js, ts = _sessions(tmp_path, x)
    JCMD["denoise"].fn(js, ["-da3d"])
    TCMD["denoise"].fn(ts, ["-da3d"])
    _held_by_effect(ts.image.data, np.asarray(js.image.data), c)
    assert set(ts.stages) == {"search", "solve", "aggregate", "da3d"}


def test_denoise_mod_blend_vs_jax(tmp_path):
    """-mod=0.4 blends 40 % of the denoised image into the input: the
    blend of each package's own result agrees with the JAX package's
    within 1e-6 beyond 0.4 × the denoisers' difference; -mod=0 reads as
    1."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    x = noisy(clean_scene(60, 64), 0.03, 61)
    js, ts = _sessions(tmp_path, x)
    JCMD["denoise"].fn(js, ["-mod=0.4"])
    TCMD["denoise"].fn(ts, ["-mod=0.4"])
    full = tnl.nlbayes_denoise(TImage(data=x), device=CPU).data
    close(ts.image.data, (0.4 * full + 0.6 * x).astype(np.float32), 1e-6)
    jfull = jnl.nlbayes_denoise(JImage(data=x)).data
    close(np.asarray(js.image.data), (0.4 * jfull + 0.6 * x).astype(
        np.float32), 1e-6)
    js, ts = _sessions(tmp_path, x)
    TCMD["denoise"].fn(ts, ["-mod=0"])
    close(ts.image.data, full, 1e-6)
