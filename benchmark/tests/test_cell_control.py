"""The check fails what it must: the control (the reference computed in
bfloat16 in the program's place) and a run with the timed path broken
underneath, once for each fault a deep-sky cell can have.  At the tiny
size on the CPU; the control's readings at the cells' own size come from
``benchmark/control.py`` on the card."""

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.reference import check_deepsky, check_planetary
from benchmark.tests.conftest import run_tiny, tiny_cell

LIGHTS = "deepsky_mono_imx571.lights24"
FLATS = "deepsky_mono_imx571.flats32_noreg"
JUPITER = "planetary_mono_640x480.jupiter1000"
CHECKS = {LIGHTS: check_deepsky, FLATS: check_deepsky,
          JUPITER: check_planetary}


@pytest.mark.parametrize("cell", [LIGHTS, FLATS, JUPITER])
def test_control_fails(cell, tmp_path):
    import torch

    torch.set_num_threads(2)
    c = tiny_cell(cell)
    truth = gen.make(c.traffic["generator"], c.config, c.traffic, 97531,
                     str(tmp_path), torch.device("cpu"))
    nums = CHECKS[cell].control(c.config, c.traffic, truth, str(tmp_path),
                                 torch.device("cpu"))
    failed = [k for k, v in nums.items() if v > c.traffic["limits"][k]]
    assert failed, nums


def _half_batch(monkeypatch):
    """The stack over half of the frames, the mean taken over the rest."""
    import siril_tpu_torch.pipeline as pl

    orig = pl.make_block_kernel

    def make(rtype, norm, lo, hi, n, *rest):
        half = orig(rtype, norm, lo, hi, n // 2, *rest)

        def kernel(block, sc, off, mu):
            k = block.shape[0] // 2
            return half(block[:k], sc[:k], off[:k], mu[:k])
        return kernel
    monkeypatch.setattr(pl, "make_block_kernel", make)


def _row_altered(monkeypatch):
    """One row of the stacked image raised by 0.01 (five times the stack's
    noise) where it is made."""
    import siril_tpu_torch.pipeline as pl

    orig = pl.finalize_metadata

    def fin(seq, indices, result):
        result = np.array(result)
        result[:, result.shape[1] // 2] += 1e-2
        return orig(seq, indices, result)
    monkeypatch.setattr(pl, "finalize_metadata", fin)


def _warp_unchanged(monkeypatch):
    """The warp returns the frames as they came."""
    import siril_tpu_torch.pipeline as pl

    monkeypatch.setattr(pl, "_warp_frames", lambda frames, Hs, size, a:
                        None)


def _calibration_unchanged(monkeypatch):
    """Calibration returns each chunk as it came."""
    import siril_tpu_torch.pipeline as pl

    monkeypatch.setattr(pl, "_calibrate_chunk", lambda *a: None)


def _shift_altered(monkeypatch):
    """Each frame's registration moved by 0.3 px where it is made."""
    import siril_tpu_torch.pipeline as pl

    orig = pl.match_stars

    def match(*a, **kw):
        m = orig(*a, **kw)
        if m is not None:
            m.H = np.array(m.H, np.float64)
            m.H[0, 2] += 0.3
        return m
    monkeypatch.setattr(pl, "match_stars", match)


def _mpp_half_batch(monkeypatch):
    """Each alignment point's stack over half of its chosen frames of a
    chunk, the mean taken over the rest (their sum doubled)."""
    import siril_tpu_torch.planetary.mpp as mpp

    orig = mpp.stack_stage

    def stage(acc_ap, frames, gsh, iy, ix, resid, selmask):
        m = selmask.clone()
        m[m.shape[0] // 2:] = 0
        part = orig(torch.zeros_like(acc_ap), frames, gsh, iy, ix, resid,
                    m)
        return acc_ap + 2 * part
    monkeypatch.setattr(mpp, "stack_stage", stage)


def _mpp_row_altered(monkeypatch):
    """One row of the stacked image raised by 0.01 where it is made."""
    import siril_tpu_torch.planetary.mpp as mpp

    orig = mpp.mpp_stack

    def stack(*a, **kw):
        img = orig(*a, **kw)
        img.data[:, img.data.shape[1] // 2] += 1e-2
        return img
    monkeypatch.setattr(mpp, "mpp_stack", stack)


def _mpp_shift_unchanged(monkeypatch):
    """The global Fourier shift returns the frames as they came."""
    import siril_tpu_torch.planetary.mpp as mpp

    orig = mpp._shift_core
    monkeypatch.setattr(mpp, "_shift_core", lambda f, s: f if f.shape[-1]
                        > 100 else orig(f, s))


def _mpp_ap_shifts_altered(monkeypatch):
    """Every alignment point's shift moved by 1 px where it is made."""
    import siril_tpu_torch.planetary.mpp as mpp

    orig = mpp.mpp_compute_shifts

    def shifts(*a, **kw):
        st = orig(*a, **kw)
        st.ap_shifts = st.ap_shifts + np.where(st.ap_shifts != 0, 1.0, 0.0)
        return st
    monkeypatch.setattr(mpp, "mpp_compute_shifts", shifts)


FAULTS = [(LIGHTS, _half_batch), (LIGHTS, _row_altered),
          (LIGHTS, _warp_unchanged), (LIGHTS, _shift_altered),
          (FLATS, _half_batch), (FLATS, _row_altered),
          (FLATS, _calibration_unchanged),
          (JUPITER, _mpp_half_batch), (JUPITER, _mpp_row_altered),
          (JUPITER, _mpp_shift_unchanged),
          (JUPITER, _mpp_ap_shifts_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c.split('.')[1]}-{f.__name__[1:]}"
                              for c, f in FAULTS])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = run_tiny(cell, tmp=tmp_path)
    assert not res["correct"], res["checks"]
