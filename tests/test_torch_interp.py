"""Parity: the port's pure-translation warp (``ops/interp.py``) against
``siril_tpu.ops.interp.warp_translation_batch`` on the same numpy frames
made from a seed.  Tolerance atol 1e-5: both filter in float32, but the
filter weights come from two sin implementations and XLA fuses the tap
sums into multiply-adds, so values differ by a few ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siril_tpu.ops import interp as jinterp
from siril_tpu_torch.ops import interp

torch.set_num_threads(1)


@pytest.mark.parametrize("method", [interp.INTERP_LANCZOS4,
                                    interp.INTERP_BICUBIC,
                                    interp.INTERP_BILINEAR])
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
    with pytest.raises(NotImplementedError):
        interp.warp_translation_batch(torch.zeros(1, 1, 8, 8),
                                      np.zeros((1, 2)),
                                      interp.INTERP_NEAREST)


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
