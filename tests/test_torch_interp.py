"""Parity: the port's warps (``ops/interp.py``) against
``siril_tpu.ops.interp`` on the same numpy frames made from a seed.

- The pure-translation warp: atol 1e-5 (both filter in float32, but the
  filter weights come from two sin implementations and XLA fuses the tap
  sums into multiply-adds, so values differ by a few ulp).
- The gather warp: 2e-6 inside the frame, the same black border.
- The FFT ladder's gates: the same float64 values (a few ulps) and None
  in the same cases.
- The ladder's rungs: max |Δ| ≤ 2e-5 except where the ringing clamp or
  the validity mask decided otherwise, on at most 1e-3 of the pixels,
  and there one package's value is 0 or its clamp substituted the guide.
  torch.fft (pocketfft) and XLA's FFT (DUCC) agree to a few 1e-7, not bit
  for bit, so a comparison against 0.98·guide or a frame edge can flip;
  measured on these frames: max |Δ| 1.8e-6, no decision flipped.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from siril_tpu.ops import interp as jinterp
from siril_tpu_torch.ops import interp

torch.set_num_threads(1)


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("clamp", [True, False])
def test_translation_warp_vs_jax(method, clamp):
    rng = np.random.default_rng(21 + method)
    frames = (0.1 + rng.random((4, 1, 40, 52)) ** 4).astype(np.float32)
    frames[:, :, 10, 10] = 0.95                      # sharp peaks ring
    shifts = np.array([[0.0, 0.0], [3.25, -1.5], [-7.8, 2.1],
                       [40.4, -0.3]], np.float32)
    ref = np.asarray(jinterp.warp_translation_batch(
        jnp.asarray(frames), shifts, method, clamp))
    got = interp.warp_translation_batch(torch.from_numpy(frames), shifts,
                                        method, clamp).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_translations_from_Hs():
    Hs = np.tile(np.eye(3), (3, 1, 1))
    Hs[1, :2, 2] = (2.5, -1.0)
    np.testing.assert_array_equal(interp.translations_from_Hs(Hs),
                                  jinterp.translations_from_Hs(Hs))
    Hs[2, 0, 1] = 0.01
    assert interp.translations_from_Hs(Hs) is None


#: a homography with rotation, scale and perspective (frame → target)
_TH = np.deg2rad(2.5)
HOMOGRAPHY = np.array([[1.015 * np.cos(_TH), -1.015 * np.sin(_TH), 3.3],
                       [1.015 * np.sin(_TH), 1.015 * np.cos(_TH), -2.1],
                       [2e-5, -3e-5, 1.0]])


@pytest.mark.parametrize("method", range(6))
@pytest.mark.parametrize("clamp", [True, False])
def test_gather_warp_vs_jax(method, clamp):
    """The gather warp (``warp_homography``, used by register and
    seqapplyreg) on a non-square frame, every interpolation, clamp on and
    off: within 2e-6 inside the frame (the taps' float32 sums and the
    weights' sin differ by a few ulp), and the same pixels left black at
    the border."""
    rng = np.random.default_rng(50 + method)
    img = (0.1 + rng.random((2, 44, 58)) ** 4).astype(np.float32)
    img[:, 20, 30] = 0.95                            # a peak that rings
    ref = np.asarray(jinterp.warp_homography(img, HOMOGRAPHY, (44, 72),
                                             method, clamp))
    got = interp.warp_homography(torch.from_numpy(img), HOMOGRAPHY,
                                 (44, 72), method, clamp).numpy()
    assert got.shape == ref.shape == (2, 44, 72)
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (ref == 0).any() and (ref != 0).any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_gather_warp_row_blocks_and_batch(monkeypatch):
    """Row blocks of any height give the same warp, and the batch form
    warps each frame by its own H."""
    rng = np.random.default_rng(57)
    frames = rng.random((3, 1, 30, 34)).astype(np.float32)
    Hs = np.stack([np.eye(3), HOMOGRAPHY, np.linalg.inv(HOMOGRAPHY)])
    whole = interp.warp_homography_batch(torch.from_numpy(frames), Hs,
                                         (30, 34))
    monkeypatch.setattr(interp, "WARP_BLOCK_PIXELS", 34 * 7)
    blocks = interp.warp_homography_batch(torch.from_numpy(frames), Hs,
                                          (30, 34))
    np.testing.assert_array_equal(blocks.numpy(), whole.numpy())
    ref = np.asarray(jinterp.warp_homography_batch(
        jnp.asarray(frames), Hs, (30, 34)))
    np.testing.assert_allclose(whole.numpy(), ref, rtol=0, atol=2e-6)
    assert interp.INTERP_NAMES == jinterp.INTERP_NAMES


# ---------------------------------------------------------------------------
# the FFT warp ladder
# ---------------------------------------------------------------------------


def _maps(*params, size=(96, 128)):
    """Frame → reference maps (chip_smoke.similar_map) of a frame of
    ``size``."""
    return np.stack([chip_smoke.similar_map(*p, size=size) for p in params])


#: gate cases: (gate, maps, size, None expected); each set has the
#: reference frame, and the flip sets a frame turned by ~180°
GATES = {
    "rotation": ("rotations_from_Hs",
                 _maps((1, 0, 0, 0), (1, 0.6, 2.3, -1.2), (1, -0.4, 0.7, 0.3)),
                 (96, 128), False),
    "rotation_flip": ("rotations_from_Hs",
                      _maps((1, 0, 0, 0), (1, 179.6, -1.5, 2.2),
                            (1, -179.2, 3.0, 1.0)), (96, 128), False),
    "rotation_reflection": ("rotations_from_Hs",
                            np.stack([np.eye(3), np.diag([-1.0, 1.0, 1.0])]),
                            (96, 128), True),
    "rotation_scaled": ("rotations_from_Hs",
                        _maps((1, 0, 0, 0), (1.02, 0.5, 1, 1)), (96, 128),
                        True),
    "rotation_past_15deg": ("rotations_from_Hs",
                            _maps((1, 0, 0, 0), (1, 20.0, 1, 1)), (96, 128),
                            True),
    "rotation_nan": ("rotations_from_Hs",
                     np.stack([np.eye(3), np.full((3, 3), np.nan)]),
                     (96, 128), True),
    "affine": ("affines_from_Hs",
               _maps((1, 0, 0, 0), (1.01, 0.6, 2.3, -1.2),
                     (0.99, -0.4, 0.7, 0.3)), (96, 128), False),
    "affine_flip": ("affines_from_Hs",
                    _maps((1, 0, 0, 0), (0.99, 179.6, -1.5, 2.2)),
                    (96, 128), False),
    "affine_out_of_band": ("affines_from_Hs",
                           _maps((1, 0, 0, 0), (1.4, 0.5, 1, 1)), (96, 128),
                           True),
    "affine_projective": ("affines_from_Hs",
                          _maps((1, 0, 0, 0), (1, 0, 0, 0, 2e-4, 0)),
                          (96, 128), True),
    "perspective_D2": ("perspective_split_from_Hs",
                       _maps((1, 0, 0, 0), (1.004, 0.5, 2, -1, 2e-4, -1.2e-4),
                             (0.997, 179.3, -2, 2, -1.5e-4, 1e-4)),
                       (96, 128), False),
    "perspective_D8": ("perspective_split_from_Hs",
                       _maps((1, 0, 0, 0), (1, 0.2, 1, 1, 1e-6, -1e-6),
                             size=(4096, 4096)), (4096, 4096), False),
    "perspective_D16": ("perspective_split_from_Hs",
                        _maps((1, 0, 0, 0), (1, 0.2, 1, 1, 2e-6, -2e-6),
                              size=(4096, 4096)), (4096, 4096), False),
    "perspective_past_16": ("perspective_split_from_Hs",
                            _maps((1, 0, 0, 0), (1, 0.2, 1, 1, 3e-6, -3e-6),
                                  size=(4096, 4096)), (4096, 4096), True),
    "perspective_horizon_in_frame": (
        "perspective_split_from_Hs",
        _maps((1, 0, 0, 0), (1, 0, 0, 0, -1.2e-2, 0)), (96, 128), True),
}


def _equal_params(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=4 * np.finfo(g.dtype).eps,
                                       atol=1e-12)


@pytest.mark.parametrize("case", sorted(GATES))
def test_ladder_gates_vs_jax(case):
    name, Hs, size, none = GATES[case]
    ref = getattr(jinterp, name)(Hs, size)
    got = getattr(interp, name)(Hs, size)
    assert (ref is None) == none
    _equal_params(got, ref)
    if ref is not None and name != "rotations_from_Hs":
        M = ref[0]
        for g, r in zip(interp._czt_sigmas(M, *size),
                        jinterp._czt_sigmas(M, *size)):
            _equal_params(g, r)
    if case.startswith("perspective_D"):
        assert ref[4] == int(case[len("perspective_D"):])


def _stars(rng, n, h, w):
    """Gaussian stars on a sky with noise σ 0.01 — the ringing clamp has
    peaks to act on."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((n, 1, h, w), 0.05, np.float32)
    for k in range(n):
        for _ in range(12):
            x0, y0 = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
            out[k, 0] += 0.5 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                      / (2 * 1.5 ** 2))
        out[k, 0] += rng.normal(0, 0.01, (h, w)).astype(np.float32)
    return out


#: rung cases: (gate, warp, maps) — each batch with a frame turned by
#: ~180° (the meridian flip)
RUNGS = {
    "rotation": ("rotations_from_Hs", "warp_rotation_batch",
                 ((1, 0, 0, 0), (1, 0.6, 2.3, -1.2), (1, 179.6, -1.5, 2.2),
                  (1, -0.4, 0.7, 0.3))),
    "affine": ("affines_from_Hs", "warp_affine_batch",
               ((1, 0, 0, 0), (1.01, 0.6, 2.3, -1.2),
                (0.99, 179.6, -1.5, 2.2), (1.005, -0.4, 0.7, 0.3))),
    "perspective": ("perspective_split_from_Hs", "warp_perspective_batch",
                    ((1, 0, 0, 0), (1.004, 0.5, 2, -1, 2e-4, -1.2e-4),
                     (0.997, 179.3, -2, 2, -1.5e-4, 1e-4),
                     (1.002, 0.3, 1, 1, 1.2e-4, 1.8e-4))),
}


def assert_ladder_close(got, ref, got_free=None, ref_free=None):
    """The rungs' tolerance (module docstring); ``*_free`` are the same
    warps without the clamp, which tell where a clamp substituted."""
    d = np.abs(got - ref)
    far = d > 2e-5
    assert far.sum() <= 1e-3 * d.size
    ok = (got == 0) | (ref == 0)
    if got_free is not None:
        ok |= (got != got_free) | (ref != ref_free)
    assert ok[far].all()


@pytest.mark.parametrize("size", [(96, 128), (160, 64)])
@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_ladder_rung_vs_jax(rung, clamp, size):
    gate, warp, params = RUNGS[rung]
    h, w = size
    frames = _stars(np.random.default_rng(hash((rung, size)) % 1000), 4, h,
                    w)
    Hs = _maps(*params, size=size)
    prm = getattr(interp, gate)(Hs, size)
    flip = prm[3 if rung == "rotation" else 2]
    assert flip.any() and not flip.all()

    def both(cl):
        ref = np.asarray(getattr(jinterp, warp)(jnp.asarray(frames), prm,
                                                clamp=cl))
        got = getattr(interp, warp)(torch.from_numpy(frames), prm,
                                    clamp=cl).numpy()
        return got, ref

    got, ref = both(clamp)
    assert got.shape == ref.shape == frames.shape
    assert (ref == 0).any() and (ref != 0).any()
    free = both(False) if clamp else (None, None)
    assert_ladder_close(got, ref, *free)


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_ladder_rung_chunks(rung, monkeypatch):
    """Warping a frame at a time (the chunk budgets at 4096²) gives the
    batch's result, up to the FFT's rounding, which depends on the batch
    (atol 1e-6; measured 1.8e-7)."""
    gate, warp, params = RUNGS[rung]
    frames = torch.from_numpy(_stars(np.random.default_rng(3), 4, 48, 64))
    prm = getattr(interp, gate)(_maps(*params, size=(48, 64)), (48, 64))
    whole = getattr(interp, warp)(frames, prm)
    real = interp._run_chunked
    monkeypatch.setattr(interp, "_run_chunked",
                        lambda run, fr, budget, *a: real(run, fr, 1, *a))
    np.testing.assert_allclose(getattr(interp, warp)(frames, prm).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)


def test_mod2_exact_vs_jax():
    """The chirp phase reduction on the same float32 pairs and indices:
    equal but for the last bits XLA's fused multiply-adds move."""
    rng = np.random.default_rng(9)
    sig = rng.uniform(0.7, 1.3, 5) / 4096.0
    hi, lo = interp._sig_pair(sig)
    i = np.arange(4096, dtype=np.int32) ** 2
    ref = np.asarray(jinterp._mod2_exact(jnp.asarray(hi)[:, None],
                                         jnp.asarray(lo)[:, None],
                                         jnp.asarray(i)[None]))
    got = interp._mod2_exact(torch.from_numpy(hi)[:, None],
                             torch.from_numpy(lo)[:, None],
                             torch.from_numpy(i)[None]).numpy()
    d = np.abs(got - ref)
    d = np.minimum(d, 2.0 - d)                 # the phase is mod 2
    assert d.max() <= 4e-6
    exact = np.mod(sig[:, None] * i.astype(np.float64)[None], 2.0)
    e = np.abs(got - exact)
    assert np.minimum(e, 2.0 - e).max() <= 4e-6


@pytest.mark.parametrize("i", range(3))
def test_rung_vs_gather_bound(i):
    """chip_smoke.py's warps phase at 768² on the CPU (its frames, maps
    and interior): the gate picks the family's rung, and the rung lies
    within chip_smoke.WARP_GATHER_BOUND of the gather warp in interior
    mean |Δ|, the bound the card is held to at 4096².  Measured here:
    rotation 9.9e-4 (its clamp guide went through three bilinear shears,
    the gather warp's through one, and sky noise σ 0.01 trips the clamp
    often), affine and perspective 3.6e-5 and 3.8e-5."""
    family, maps = chip_smoke.WARP_FAMILIES[i]
    frames, Hs = chip_smoke.warp_family_frames(20 + i, 768, maps, 140)
    name, prm, out, ref, err = chip_smoke.rung_vs_gather(
        torch.from_numpy(frames), Hs, family, 40)
    assert name == family
    assert err <= chip_smoke.WARP_GATHER_BOUND
