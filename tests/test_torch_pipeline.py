"""The port's slice end to end against the JAX package: ``fusedstack`` at
its defaults (star registration with shifts, lanczos4 warp with clamp,
IKSS additive+scaling normalization, winsorized rejection 3/3) on the
5-frame 160×192 sequence of tests/test_pipeline.py, on the CPU.

Tolerances, each with its reason:
- registration shifts within 0.01 px: the same star lists up to the
  float32 LM fit (tests/test_torch_registration.py);
- interior max |Δ| ≤ 1e-3: shifts that differ by ~1e-5 px move lanczos
  weights by ~1e-5, and a star peak can flip one rejection decision at
  kσ; on this sequence no such flip moves a mean by more;
- rejection totals within 0.5 %: the same flips, counted.
Except where the JAX package's winsorized σ loop leaves the C iteration:
there a ray the JAX package keeps moves a 5-frame mean by ~0.2.  Those
pixels are found on the block the port stacked, where the port must equal
the C-control-flow oracle and the JAX package must not
(tests/test_torch_rejection.winsorized_vs_jax); the totals are compared
without their counts.
"""

import os

import numpy as np
import pytest
import torch

from siril_tpu.ops import rejection as jrj
from siril_tpu.ops.normalization import ADDITIVE_SCALING
from siril_tpu.ops.stacking import StackArgs
from siril_tpu.pipeline import FusedArgs, fused_preprocess_stack
from siril_tpu.registration.starfinder import StarFinderParams
from siril_tpu_torch import cli, convert
from siril_tpu_torch import pipeline as tpipe
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.io.fits_io import read_fits
from siril_tpu_torch.kernels import reject_stack as k1
from tests.test_pipeline import make_seq
from tests.test_torch_stacking import spy_k1, winsorized_block_vs_jax

torch.set_num_threads(1)

SHIFTS = [(0, 0), (4, 2), (-3, 5), (6, -4), (2, 2)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused")
    seq, base = make_seq(d, np.random.default_rng(3), SHIFTS)
    args = FusedArgs(stack=StackArgs(method="rej", rejection=jrj.WINSORIZED,
                                     normalize=ADDITIVE_SCALING),
                     starfinder=StarFinderParams(radius=6))
    ref = fused_preprocess_stack(seq, args)
    import dataclasses

    targs = convert.fused_args(dataclasses.asdict(args))
    tseq = Sequence.scan("fl_", str(d))
    with pytest.MonkeyPatch.context() as mp:
        calls = spy_k1(mp)
        got = tpipe.fused_preprocess_stack(tseq, targs, device="cpu")
    return d, base, seq, ref, tseq, got, calls


def test_fused_vs_jax(both):
    _, base, seq, ref, tseq, got, calls = both
    np.testing.assert_allclose(tseq.reg(0).H[:, :2, 2],
                               seq.reg(0).H[:, :2, 2], atol=0.01)
    assert tseq.reg(0).valid.sum() == 5
    a = ref.image.host()[0]
    b = got.image.host()[0]
    idx, _, pcount, jcount = winsorized_block_vs_jax(calls)
    same = np.ones(a.size, bool)
    same[idx] = False
    same = same.reshape(a.shape)
    inner = np.zeros(a.shape, bool)
    inner[20:-20, 20:-20] = True
    assert np.abs(a - b)[inner & same].max() <= 1e-3
    for r, g, pc, jc in zip(ref.total_rejected, got.total_rejected, pcount,
                            jcount):
        assert abs((r - jc) - (g - pc)) <= 0.005 * r
    # and the result is right: aligned, cosmic rays rejected
    assert np.abs(b[inner] - base[inner]).mean() < 0.01
    assert b[inner].max() < 0.9
    assert got.image.keywords.stackcnt == 5
    assert got.image.keywords.livetime == pytest.approx(50.0)
    assert set(got.stage_s) >= {"read", "upload", "detect", "match",
                                "normalize", "warp", "stack", "fetch"}


def test_cli_fusedstack_writes_fits(both):
    d = both[0]
    before = sum(k1.launches.values())
    session = cli.run(["-d", str(d), "--device", "cpu", "fusedstack", "fl_",
                       "-out=final"])
    assert sum(k1.launches.values()) == before   # plain version on the CPU
    out = os.path.join(d, "final.fit")
    assert os.path.exists(out)
    img = read_fits(out)
    np.testing.assert_array_equal(img.host(), session.result.image.host())
    assert session.sequence.reg(0).valid.sum() == 5
    assert img.keywords.stackcnt == 5
    assert cli.main(["-d", str(d), "--device", "cpu", "register",
                     "fl_"]) == 1


def test_unported_options_raise(both):
    d, _, _, _, tseq, _, _ = both
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.fused_preprocess_stack(
            tseq, tpipe.FusedArgs(calib=object()), device="cpu")
    with pytest.raises(NotImplementedError, match="frame weights"):
        tpipe.fused_preprocess_stack(
            tseq, tpipe.FusedArgs(stack=tpipe.StackArgs(
                weighting=3)), device="cpu")
    with pytest.raises(NotImplementedError, match="calibration"):
        cli.run(["-d", str(d), "--device", "cpu", "fusedstack", "fl_",
                 "-dark=master"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.run(["-d", str(d), "--device", "cpu", "fusedstack", "fl_",
                 "-transf=homography"])


@pytest.fixture(scope="module")
def cli_plain(both):
    """fusedstack through the CLI with no -transf= flag."""
    return cli.run(["-d", str(both[0]), "--device", "cpu", "fusedstack",
                    "fl_", "-out=plain"])


@pytest.mark.parametrize("transf", ["shift", "similarity"])
def test_cli_fusedstack_transf_runs_shift(both, cli_plain, transf):
    """Any -transf= but homography runs shift registration, as the JAX
    command does (siril_tpu/cli/commands2.py:877-878): the same result as
    without the flag."""
    d, plain = both[0], cli_plain
    flag = cli.run(["-d", str(d), "--device", "cpu", "fusedstack", "fl_",
                    f"-transf={transf}", f"-out={transf}"])
    np.testing.assert_array_equal(flag.result.image.host(),
                                  plain.result.image.host())
    np.testing.assert_array_equal(flag.sequence.reg(0).H,
                                  plain.sequence.reg(0).H)
    assert tuple(flag.result.total_rejected) == \
        tuple(plain.result.total_rejected)
