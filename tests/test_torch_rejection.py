"""Parity: the port's kernel K1 (every rejection mode, K1a-K1d, and the
weighted mean, K1e) against the JAX package, on the same numpy inputs made
from a seed.

- the plain PyTorch version (``ops/stacking.reject_stack_plain``, the CPU
  path of ``kernels/reject_stack.reject_mean``) against the JAX
  normalize+reject+mean block kernel (``siril_tpu.ops.stacking.
  make_block_kernel``: ``_norm_apply`` + ``rejection.rejection_mean`` under
  one jit), for every mode × normalization × {float32, int16}, with and
  without per-frame and per-pixel weights: rejection counts equal, means
  within atol 2e-6 (the reference's parity contract,
  tests/test_pallas_reject.py);
- against the Pallas kernel itself, run in interpret mode on the CPU as
  tests/test_pallas_reject.py runs it — same tolerance;
- against the frozen goldens (tests/golden/rejection_golden.npz) exactly as
  tests/test_rejection_golden.py checks the JAX kernels: counts exact
  (SIGMEDIAN's within 4, its counts depend on the iteration path), means
  within rtol 2e-5 / atol 2e-6;
- winsorized against the C-control-flow oracle (tests/reference_impl.py)
  on random stacks with cosmic rays: counts equal, means within 2e-6.  The
  port iterates σ as the C loop does; the JAX package takes an Aitken jump
  every third step and stops at 48, and so keeps some rays the C loop
  rejects.  Where the port and the JAX package differ in winsorized, the
  comparison (``winsorized_vs_jax``) checks that the JAX package differs
  from the oracle there and the port does not;
- the CUDA kernel against the plain version on the card: see
  tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siril_tpu.ops import rejection as jrj
from siril_tpu.ops.stacking import make_block_kernel
from siril_tpu.pallas.reject_stack import pallas_reject_mean
from siril_tpu_torch.kernels import reject_stack as k1
from siril_tpu_torch.ops import rejection as rj
from siril_tpu_torch.ops.normalization import (
    ADDITIVE_SCALING,
    MULTIPLICATIVE,
    NO_NORM,
)
from siril_tpu_torch.ops.stacking import normalize_block, reject_stack_plain
from tests import reference_impl as oracle

torch.set_num_threads(1)

ATOL = 2e-6

WINDOW = [(rj.NO_REJEC, 3.0, 3.0), (rj.PERCENTILE, 0.2, 0.1),
          (rj.SIGMA, 3.0, 3.0), (rj.MAD, 3.0, 3.0),
          (rj.WINSORIZED, 3.0, 3.0)]
MASKED = [(rj.SIGMEDIAN, 3.0, 3.0), (rj.LINEARFIT, 3.0, 3.0),
          (rj.GESDT, 0.3, 0.05)]
NORMS = [NO_NORM, ADDITIVE_SCALING, MULTIPLICATIVE]


def _mkstack(rng, n=12, p=400):
    base = 0.2 + 0.5 * rng.random(p).astype(np.float32)
    stack = base[None, :] + rng.normal(0, 0.02, (n, p)).astype(np.float32)
    idx = rng.integers(0, p, p // 6)
    stack[rng.integers(0, n, p // 6), idx] = 0.95
    idx = rng.integers(0, p, p // 8)
    stack[rng.integers(0, n, p // 8), idx] = 0.001
    stack[rng.random((n, p)) < 0.05] = 0.0
    return np.clip(stack, 0.0, 1.0).astype(np.float32)


def _coeffs(rng, n):
    scale = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    offset = (0.01 * rng.standard_normal(n)).astype(np.float32)
    mul = (1.0 + 0.03 * rng.standard_normal(n)).astype(np.float32)
    return scale, offset, mul


def _port(stack, scale, offset, mul, rtype, mode, sl, sh):
    out = k1.reject_mean(torch.from_numpy(stack), torch.from_numpy(scale),
                         torch.from_numpy(offset), torch.from_numpy(mul),
                         rtype=rtype, mode=mode, siglow=sl, sighigh=sh)
    return [o.numpy() for o in out]


def _assert_parity(got, ref):
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0,
                               atol=ATOL)


def oracle_winsorized(col, siglow, sighigh, w=None):
    """(rej_low, rej_high, mean) of the C-control-flow oracle on one
    normalized column; with weights ``w`` (N,) the mean is the reference's
    weighted mean over the oracle's kept range (median_and_mean.c:
    1041-1095)."""
    kept, rl, rh, mean = oracle.reject_pixel(col, "winsorized", siglow,
                                             sighigh)
    if w is not None and kept.size:
        x = np.asarray(col, np.float64)
        w = np.asarray(w, np.float64)
        inr = (x >= kept.min()) & (x <= kept.max()) & (x != 0.0)
        wsum, wnorm = (x * w)[inr].sum(), w[inr].sum()
        mean = wsum / wnorm if wnorm != 0 and wsum != 0 else \
            x[inr & (x > 0)].sum() / kept.size
    return int(rl), int(rh), float(mean)


def winsorized_vs_jax(got, ref, xnorm, siglow, sighigh, w=None):
    """The port's winsorized result ``got`` against the JAX package's
    ``ref`` on the same normalized (N, P) block ``xnorm``, each a tuple
    (mean, rej_low, rej_high) of (P,) arrays.  Every pixel keeps the
    parity check (counts equal, means within ATOL) except where the JAX
    package differs from the oracle: there the oracle, run on the column,
    must give the port's counts and mean and not the JAX package's.
    Returns the differing pixels' indices and the (low, high) rejection
    counts of the port and of the JAX package summed over them."""
    gm, gl, gh = (np.asarray(v) for v in got)
    rm, rl, rh = (np.asarray(v) for v in ref)
    idx = np.nonzero((gl != rl) | (gh != rh) | (np.abs(gm - rm) > ATOL))[0]
    wfull = None if w is None else np.broadcast_to(np.asarray(w),
                                                   xnorm.shape)
    for p in idx:
        ol, oh, om = oracle_winsorized(
            xnorm[:, p], siglow, sighigh,
            None if wfull is None else wfull[:, p])
        assert (gl[p], gh[p]) == (ol, oh), (p, "port counts != oracle")
        assert abs(float(gm[p]) - om) <= ATOL, (p, "port mean != oracle")
        assert (rl[p], rh[p]) != (ol, oh) or abs(float(rm[p]) - om) > ATOL, \
            (p, "the JAX package agrees with the oracle here")
    return (idx, (int(gl[idx].sum()), int(gh[idx].sum())),
            (int(rl[idx].sum()), int(rh[idx].sum())))


def jax_winsorized(xnorm, siglow, sighigh, w=None):
    """The JAX package's winsorized rejection (its jnp path, which its
    stack commands run off the TPU) on a normalized (N, P) block."""
    n, p = xnorm.shape
    wj = None if w is None else jnp.asarray(
        np.broadcast_to(np.asarray(w), (n, p)).copy())
    out = jrj.rejection_mean(jnp.asarray(xnorm), jrj.WINSORIZED, siglow,
                             sighigh, weights=wj, n_full=n,
                             with_weights=w is not None)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("mode", NORMS)
@pytest.mark.parametrize("rtype,sl,sh", WINDOW)
def test_plain_vs_jax_block_kernel(rtype, sl, sh, mode, dtype):
    rng = np.random.default_rng(1000 + 10 * rtype + mode)
    n = 24 if rtype == rj.WINSORIZED else 12
    stack = _mkstack(rng, n=n, p=600)
    if dtype == "i16":
        stack = (np.round(stack * 65535.0).astype(np.int64)
                 - 32768).astype(np.int16)
    scale, offset, mul = _coeffs(rng, n)
    kern = make_block_kernel(rtype, mode, sl, sh, n, 0, False,
                             want_maps=True)
    ref = kern(jnp.asarray(stack), jnp.asarray(scale), jnp.asarray(offset),
               jnp.asarray(mul), jnp.zeros((1, 1), jnp.float32),
               jnp.zeros(1, jnp.float32))
    got = _port(stack, scale, offset, mul, rtype, mode, sl, sh)
    if rtype == rj.WINSORIZED:
        xn = normalize_block(*(torch.from_numpy(v) for v in
                               (stack, scale, offset, mul)), mode).numpy()
        winsorized_vs_jax(got, ref, xn, sl, sh)
    else:
        _assert_parity(got, ref)
    assert got[1].sum() + got[2].sum() > 0 or rtype == rj.NO_REJEC


@pytest.mark.parametrize("rtype,mode,dtype", [
    (rj.WINSORIZED, ADDITIVE_SCALING, "f32"),
    (rj.WINSORIZED, ADDITIVE_SCALING, "i16"),
    (rj.SIGMA, NO_NORM, "f32"),
    (rj.MAD, MULTIPLICATIVE, "f32"),
])
def test_plain_vs_pallas_interpret(rtype, mode, dtype):
    """The JAX package's Pallas kernel (interpret mode on the CPU)."""
    rng = np.random.default_rng(7 + rtype)
    n = 10
    stack = _mkstack(rng, n=n, p=300)
    if dtype == "i16":
        stack = (np.round(stack * 65535.0).astype(np.int64)
                 - 32768).astype(np.int16)
    scale, offset, mul = _coeffs(rng, n)
    ref = pallas_reject_mean(
        jnp.asarray(stack), jnp.asarray(scale), jnp.asarray(offset),
        jnp.asarray(mul), rtype=rtype, mode=mode, siglow=3.0, sighigh=3.0)
    got = _port(stack, scale, offset, mul, rtype, mode, 3.0, 3.0)
    _assert_parity(got, ref)


def _gesdt_kw(rtype, n, sl, sh):
    """GESDT's outlier budget and λ table, as stack_sequence builds them."""
    if rtype != rj.GESDT:
        return 0, np.zeros(1, np.float32)
    mo = int(np.floor(n * sl))
    return mo, jrj.gesdt_critical_values(n, sh, mo)


def _weights(rng, kind, n, p):
    if kind == "frame":
        return (0.5 + rng.random((n, 1))).astype(np.float32)
    if kind == "pixel":
        return (0.5 + rng.random((n, p))).astype(np.float32)
    return None


def _jax_block(stack, scale, offset, mul, rtype, mode, sl, sh, w):
    n, p = stack.shape
    mo, crit = _gesdt_kw(rtype, n, sl, sh)
    kern = make_block_kernel(rtype, mode, sl, sh, n, mo, w is not None,
                             want_maps=True)
    wj = jnp.zeros((1, 1), jnp.float32) if w is None else \
        jnp.asarray(np.broadcast_to(w, (n, p)).copy())
    return kern(jnp.asarray(stack), jnp.asarray(scale), jnp.asarray(offset),
                jnp.asarray(mul), wj, jnp.asarray(crit))


def _port_full(stack, scale, offset, mul, rtype, mode, sl, sh, w):
    n = stack.shape[0]
    mo, crit = _gesdt_kw(rtype, n, sl, sh)
    out = k1.reject_mean(
        torch.from_numpy(stack), torch.from_numpy(scale),
        torch.from_numpy(offset), torch.from_numpy(mul), rtype=rtype,
        mode=mode, siglow=sl, sighigh=sh,
        weights=None if w is None else torch.from_numpy(w),
        critical=crit, max_outliers=mo)
    return [o.numpy() for o in out]


def _case_stack(seed, n, p, dtype):
    rng = np.random.default_rng(seed)
    stack = _mkstack(rng, n=n, p=p)
    if dtype == "i16":
        stack = (np.round(stack * 65535.0).astype(np.int64)
                 - 32768).astype(np.int16)
    return rng, stack


@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("mode", NORMS)
@pytest.mark.parametrize("rtype,sl,sh", MASKED)
def test_plain_k1bcd_vs_jax_block_kernel(rtype, sl, sh, mode, dtype):
    """K1b SIGMEDIAN, K1c LINEARFIT, K1d GESDT against the jnp path."""
    rng, stack = _case_stack(2000 + 10 * rtype + mode, 12, 600, dtype)
    scale, offset, mul = _coeffs(rng, 12)
    ref = _jax_block(stack, scale, offset, mul, rtype, mode, sl, sh, None)
    got = _port_full(stack, scale, offset, mul, rtype, mode, sl, sh, None)
    _assert_parity(got, ref)
    assert got[1].sum() + got[2].sum() > 0


@pytest.mark.parametrize("wkind", ["frame", "pixel"])
@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("rtype,sl,sh", [(rj.WINSORIZED, 3.0, 3.0),
                                         (rj.SIGMA, 3.0, 3.0),
                                         (rj.LINEARFIT, 3.0, 3.0),
                                         (rj.GESDT, 0.3, 0.05),
                                         (rj.SIGMEDIAN, 3.0, 3.0),
                                         (rj.NO_REJEC, 3.0, 3.0)])
def test_plain_k1e_weights_vs_jax_block_kernel(rtype, sl, sh, dtype, wkind):
    """K1e: the weighted mean over the kept values' [pmin, pmax] range."""
    rng, stack = _case_stack(3000 + rtype, 12, 500, dtype)
    scale, offset, mul = _coeffs(rng, 12)
    w = _weights(rng, wkind, 12, 500)
    ref = _jax_block(stack, scale, offset, mul, rtype, ADDITIVE_SCALING, sl,
                     sh, w)
    got = _port_full(stack, scale, offset, mul, rtype, ADDITIVE_SCALING, sl,
                     sh, w)
    _assert_parity(got, ref)
    plain = _port_full(stack, scale, offset, mul, rtype, ADDITIVE_SCALING,
                       sl, sh, None)
    assert np.abs(got[0] - plain[0]).max() > 1e-6   # the weights act


@pytest.mark.parametrize("rtype,sl,sh,mode,dtype,wkind", [
    (rj.SIGMEDIAN, 3.0, 3.0, ADDITIVE_SCALING, "i16", None),
    (rj.LINEARFIT, 3.0, 3.0, NO_NORM, "f32", None),
    (rj.LINEARFIT, 2.0, 2.0, MULTIPLICATIVE, "i16", "pixel"),
    (rj.GESDT, 0.3, 0.05, ADDITIVE_SCALING, "f32", "frame"),
    (rj.GESDT, 0.2, 0.01, NO_NORM, "i16", None),
    (rj.WINSORIZED, 3.0, 3.0, ADDITIVE_SCALING, "i16", "pixel"),
])
def test_plain_k1bcde_vs_pallas_interpret(rtype, sl, sh, mode, dtype,
                                          wkind):
    """The JAX package's Pallas kernel (interpret mode on the CPU)."""
    rng, stack = _case_stack(70 + rtype, 10, 300, dtype)
    scale, offset, mul = _coeffs(rng, 10)
    w = _weights(rng, wkind, 10, 300)
    mo, crit = _gesdt_kw(rtype, 10, sl, sh)
    ref = pallas_reject_mean(
        jnp.asarray(stack), jnp.asarray(scale), jnp.asarray(offset),
        jnp.asarray(mul),
        None if w is None else jnp.asarray(np.broadcast_to(w, (10, 300))
                                           .copy()),
        jnp.asarray(crit), rtype=rtype, mode=mode, siglow=sl, sighigh=sh,
        with_weights=w is not None, n_full=10, max_outliers=mo)
    got = _port_full(stack, scale, offset, mul, rtype, mode, sl, sh, w)
    _assert_parity(got, ref)


def test_edge_cases_and_guard_truncation():
    """All-zero, single-valid and extreme-spread columns; and stacks whose
    N−r≤4 guard truncates the high side (kept-top segment), against the
    jnp path (same fixtures as tests/test_pallas_reject.py)."""
    rng = np.random.default_rng(12345)
    n, p = 8, 256
    stack = _mkstack(rng, n=n, p=p)
    stack[:, 0] = 0.0
    stack[1:, 1] = 0.0
    stack[:, 2] = np.linspace(0.01, 0.99, n)
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    ref = jrj.rejection_mean(jnp.asarray(stack), jrj.SIGMA, 1.0, 1.0,
                             n_full=n)
    _assert_parity(_port(stack, one, zero, one, rj.SIGMA, NO_NORM, 1.0, 1.0),
                   ref)

    n, p = 12, 192
    stack = (0.2 + 0.01 * rng.random((n, p))).astype(np.float32)
    stack[-6:, :] += rng.uniform(0.3, 0.7, (6, p)).astype(np.float32)
    stack[:2, :] -= 0.15
    stack = np.clip(stack, 0.001, 1.0)
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    for rt in (rj.SIGMA, rj.MAD, rj.WINSORIZED):
        ref = jrj.rejection_mean(jnp.asarray(stack), rt, 1.0, 1.0, n_full=n)
        got = _port(stack, one, zero, one, rt, NO_NORM, 1.0, 1.0)
        _assert_parity(got, ref)
        assert (got[2] > 0).any()


def test_fma_sensitive_column():
    """A column whose second winsorized round has a value within 1e-7 of
    kσ: the one-pass variance must be evaluated with the reference's fused
    multiply-add (XLA contracts it) to reject what the reference and the
    C-control-flow oracle reject (ROADMAP §3)."""
    from tests import reference_impl as ref

    col = np.array([0.6624216, 0.6672656, 0.6910594, 0.69310594,
                    0.69649863, 0.69768906, 0.6997459, 0.7015396,
                    0.7075381, 0.71219915, 0.71345496, 0.7392269],
                   np.float32)
    mean, rl, rh = rj.rejection_mean(torch.from_numpy(col[:, None]),
                                     rj.WINSORIZED, 1.0, 1.0)
    jm, jl, jh = jrj.rejection_mean(jnp.asarray(col[:, None]),
                                    jrj.WINSORIZED, 1.0, 1.0, n_full=12)
    _, orl, orh, om = ref.reject_pixel(col, "winsorized", 1.0, 1.0,
                                       n_full=12)
    assert (int(rl[0]), int(rh[0])) == (int(jl[0]), int(jh[0])) == (orl, orh)
    assert abs(float(mean[0]) - float(jm[0])) <= ATOL


GOLDEN_MODES = [("percentile", rj.PERCENTILE, 0.5, 0.5),
                ("sigma", rj.SIGMA, 3.0, 3.0),
                ("sigma_asym", rj.SIGMA, 1.5, 2.0),
                ("mad", rj.MAD, 3.0, 3.0),
                ("winsorized", rj.WINSORIZED, 3.0, 3.0),
                ("sigmedian", rj.SIGMEDIAN, 2.0, 2.0),
                ("linearfit", rj.LINEARFIT, 2.0, 2.0),
                ("gesdt", rj.GESDT, 0.3, 0.05)]


@pytest.mark.parametrize("mname,rtype,sl,sh", GOLDEN_MODES)
def test_window_goldens(mname, rtype, sl, sh):
    """Every mode against the frozen goldens, checked as
    tests/test_rejection_golden.py checks the JAX kernels (the GESDT
    budget there is max(N // 3, 1) with a λ table at α 0.05)."""
    from tests.test_rejection_golden import GOLDEN, _stacks

    exp = np.load(GOLDEN)
    for cname, stack in _stacks().items():
        tag = f"{cname}.{mname}"
        N = stack.shape[0]
        kw = {}
        if mname == "gesdt":
            mo = max(N // 3, 1)
            kw = dict(critical=rj.gesdt_critical_values(N, 0.05, mo),
                      max_outliers=mo)
        mean, rl, rh = rj.rejection_mean(torch.from_numpy(stack), rtype,
                                         sl, sh, n_full=N, **kw)
        np.testing.assert_allclose(mean.numpy(), exp[f"{tag}.mean"],
                                   rtol=2e-5, atol=2e-6, err_msg=tag)
        if mname == "sigmedian":
            assert (np.abs(rl.numpy() - exp[f"{tag}.rl"]) <= 4).all(), tag
            assert (np.abs(rh.numpy() - exp[f"{tag}.rh"]) <= 4).all(), tag
            continue
        np.testing.assert_array_equal(rl.numpy().astype(np.int64),
                                      exp[f"{tag}.rl"], err_msg=tag)
        np.testing.assert_array_equal(rh.numpy().astype(np.int64),
                                      exp[f"{tag}.rh"], err_msg=tag)


def test_wrapper_checks():
    """The wrapper validates its inputs: types, shapes, an unknown mode,
    weights of the wrong shape, GESDT without its λ table."""
    st = torch.rand(6, 50)
    one, zero = torch.ones(6), torch.zeros(6)
    with pytest.raises(TypeError):
        k1.reject_mean(st.double(), one, zero, one, rtype=rj.SIGMA,
                       mode=NO_NORM, siglow=3, sighigh=3)
    with pytest.raises(ValueError):
        k1.reject_mean(st, one[:5], zero, one, rtype=rj.SIGMA,
                       mode=NO_NORM, siglow=3, sighigh=3)
    with pytest.raises(ValueError, match="unknown rejection"):
        k1.reject_mean(st, one, zero, one, rtype=8, mode=NO_NORM,
                       siglow=3, sighigh=3)
    with pytest.raises(ValueError, match="weights"):
        k1.reject_mean(st, one, zero, one, rtype=rj.SIGMA, mode=NO_NORM,
                       siglow=3, sighigh=3, weights=torch.ones(6, 7))
    with pytest.raises(ValueError, match="λ table"):
        k1.reject_mean(st, one, zero, one, rtype=rj.GESDT, mode=NO_NORM,
                       siglow=0.3, sighigh=0.05, max_outliers=2)
    before = sum(k1.launches.values())
    got = k1.reject_mean(st, one, zero, one, rtype=rj.WINSORIZED,
                         mode=ADDITIVE_SCALING, siglow=3, sighigh=3)
    ref = reject_stack_plain(st, one, zero, one, rtype=rj.WINSORIZED,
                             mode=ADDITIVE_SCALING, siglow=3, sighigh=3)
    assert sum(k1.launches.values()) == before   # CPU: plain version
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_work_count():
    """The plain version counts the operations its data needed: the
    least sort comparisons of each pixel's valid values, and float
    operations that add up pixel by pixel — a pixel whose clipping has
    stopped costs nothing while others go on iterating."""
    rng = np.random.default_rng(3)
    st = torch.from_numpy(_mkstack(rng, n=12, p=200))
    work = {}
    rj.rejection_mean(st, rj.WINSORIZED, 3.0, 3.0, work=work)
    nvalid = ((st != 0) & torch.isfinite(st)).sum(0).tolist()
    assert work["compares"] == sum(
        math.ceil(math.lgamma(v + 1) / math.log(2) - 1e-9) for v in nvalid)
    assert work["flops"] > 200 * 12
    parts = [{}, {}]
    for w, cols in zip(parts, (slice(0, 100), slice(100, 200))):
        rj.rejection_mean(st[:, cols].contiguous(), rj.WINSORIZED, 3.0, 3.0,
                          work=w)
    assert parts[0]["flops"] != parts[1]["flops"]
    assert work["flops"] == parts[0]["flops"] + parts[1]["flops"]
    # the winsorized σ steps: their sum adds up, the most is the parts'
    # most, and 7 groups of 32 pixels take at least their share each
    assert work["winsor_steps"] == sum(w["winsor_steps"] for w in parts)
    assert work["winsor_steps_max"] == max(w["winsor_steps_max"]
                                           for w in parts) > 1
    assert work["winsor_warps"] == 7
    assert work["winsor_steps"] / 32 <= work["winsor_warp_steps"] <= \
        7 * work["winsor_steps_max"]


def test_frame_limit():
    """There is no frame limit: a stack of 1000 frames (the column
    kernel's size of 16-column tiles; with a weighted mean its tiles move
    to global scratch memory) goes through the wrapper and matches the JAX
    package."""
    rng = np.random.default_rng(0)
    n = 1000
    stack = _mkstack(rng, n=n, p=8)
    one, zero = np.ones(n, np.float32), np.zeros(n, np.float32)
    for rtype, sl, sh in ((rj.NO_REJEC, 3.0, 3.0), (rj.WINSORIZED, 3.0, 3.0),
                          (rj.GESDT, 0.3, 0.05)):
        got = _port_full(stack, one, zero, one, rtype, NO_NORM, sl, sh,
                         None)
        ref = _jax_block(stack, one, zero, one, rtype, NO_NORM, sl, sh,
                         None)
        _assert_parity(got, ref)
        assert got[1].sum() + got[2].sum() > 0 or rtype == rj.NO_REJEC


def _serial_rounds(col, rtype, siglow, sighigh, n_full):
    """One column's SIGMEDIAN or LINEARFIT rejection as the kernel's
    serial loop runs it (rejection_float.c:210-221, 259-300), in float32
    scalars: (rounds run, rej_low, rej_high)."""
    f32 = np.float32
    xs = sorted(f32(v) for v in col if v != 0 and np.isfinite(v))
    nv = len(xs)
    sl, sh = f32(siglow), f32(sighigh)

    def total(vals):
        t = f32(0)
        for v in vals:
            t = f32(t + v)
        return t

    def fma(a, b, c):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))

    rounds = rl = rh = 0
    active = nv > 1
    if rtype == rj.SIGMEDIAN:
        while active:
            rounds += 1
            med = f32(0.5) * f32(xs[(nv - 1) // 2] + xs[nv // 2])
            mean = total(xs) / f32(max(nv, 1))
            var = total(f32(v - mean) * f32(v - mean) for v in xs) / \
                f32(max(nv - 1, 1))
            sd = np.sqrt(max(var, f32(0)))
            lo = [(med - v) > sd * sl for v in xs]
            hi = [(v - med) > sd * sh for v in xs]
            xs = sorted(med if a or b else v for v, a, b in zip(xs, lo, hi))
            rl, rh = rl + sum(lo), rh + sum(hi)
            active = any(lo) or any(hi)
        return rounds, rl, rh
    m_x, inv_mdx2 = (f32(v) for v in rj.linearfit_constants(n_full))
    keep, r = [True] * nv, 0
    while active:
        rounds += 1
        kept = [xs[i] for i in range(nv) if keep[i]]
        nk = len(kept)
        nks = f32(max(nk, 1))
        m_y = total(kept) / nks
        sxy = total(f32(f32(c) - m_x) * f32(v - m_y)
                    for c, v in enumerate(kept))
        a = f32(sxy / nks) * inv_mdx2
        b = fma(-m_x, a, m_y)
        resid = [f32(v - fma(a, f32(c), b)) for c, v in enumerate(kept)]
        sigma = total(abs(e) for e in resid) / nks
        max_acc, rank, nl, nh = max(nk - r - 4, 0), 0, 0, 0
        rows = [i for i in range(nv) if keep[i]]
        for i, e in zip(rows, resid):
            lo, hi = -e > sigma * sl, e > sigma * sh
            if lo or hi:
                rank += 1
                if rank <= max_acc:
                    keep[i] = False
                    nl, nh = nl + lo, nh + hi
        r, rl, rh = r + nl + nh, rl + nl, rh + nh
        active = nl + nh > 0 and nk - nl - nh > 3
    return rounds, rl, rh


@pytest.mark.parametrize("rtype,sl,sh", MASKED)
def test_work_count_masked_modes(rtype, sl, sh):
    """SIGMEDIAN, LINEARFIT and GESDT count the work their data needed,
    pixel by pixel; SIGMEDIAN and LINEARFIT count the rounds each pixel
    ran, as a per-pixel serial loop runs them: their sum, the most for one
    pixel, and the sum over warps of 32 pixels of each warp's slowest."""
    rng = np.random.default_rng(9)
    st = torch.from_numpy(_mkstack(rng, n=12, p=200))
    mo, crit = _gesdt_kw(rtype, 12, sl, sh)
    kw = dict(critical=crit, max_outliers=mo)
    work, parts = {}, [{}, {}]
    _, rejl, rejh = rj.rejection_mean(st, rtype, sl, sh, work=work, **kw)
    for w, cols in zip(parts, (slice(0, 100), slice(100, 200))):
        rj.rejection_mean(st[:, cols].contiguous(), rtype, sl, sh, work=w,
                          **kw)
    assert work["flops"] > 200 * 12
    for key in ("flops", "compares"):
        assert work[key] == parts[0][key] + parts[1][key]
    if rtype == rj.GESDT:
        return
    loop = "sigmedian" if rtype == rj.SIGMEDIAN else "linearfit"
    serial = [_serial_rounds(st[:, i].numpy(), rtype, sl, sh, 12)
              for i in range(200)]
    rounds = np.array([r for r, _, _ in serial])
    assert [(l, h) for _, l, h in serial] == list(zip(rejl.tolist(),
                                                      rejh.tolist()))
    warps = np.pad(rounds, (0, 24)).reshape(7, 32).max(1)
    assert work[f"{loop}_rounds"] == rounds.sum() > 200
    assert work[f"{loop}_rounds_max"] == rounds.max() > 2
    assert work[f"{loop}_warp_rounds"] == warps.sum()
    assert work[f"{loop}_warps"] == 7
    assert work[f"{loop}_rounds"] == sum(w[f"{loop}_rounds"] for w in parts)


def test_linearfit_rank_by_count():
    """A kept value's rank among the kept (LINEARFIT's pos), as the
    register kernel counts it over a 32-bit keep mask, by a running count
    or by the popcount of the mask below its row, equals the plain
    version's cumsum of the keep flags."""
    rng = np.random.default_rng(21)
    for n in range(1, 33):
        for _ in range(20):
            keep = rng.random(n) < rng.random()
            mask = sum(1 << k for k in range(n) if keep[k])
            kf = torch.from_numpy(keep.astype(np.float32))
            pos = (torch.cumsum(kf, 0) - 1.0).numpy()
            running = np.float32(0)
            for k in range(n):
                if (mask >> k) & 1:
                    below = bin(mask & ((1 << k) - 1)).count("1")
                    assert pos[k] == running == np.float32(below)
                    running += np.float32(1)


def test_finish_over_keep_mask():
    """The mean of the kept rows over a keep mask, summed row by row as the
    register kernel's finish does, with the weighted mean over the
    original values in the kept range [pmin, pmax], equals the plain
    version's finish over the same keep set (columns with ties, negatives
    and +inf padding, N = 1 to 32)."""
    rng = np.random.default_rng(22)
    f32 = np.float32
    for n in range(1, 33):
        p = 64
        x = rng.normal(0.1, 0.3, (n, p)).astype(f32)
        x[rng.random((n, p)) < 0.2] = f32(0.25)          # ties
        x[rng.random((n, p)) < 0.1] = f32(0)             # not data
        w = (0.5 + rng.random((n, p))).astype(f32)
        xt = torch.from_numpy(x)
        valid = xt != 0
        xs = torch.sort(torch.where(valid, xt, float("inf")), 0).values
        nvalid = valid.sum(0).numpy()
        masks = [int(rng.integers(0, 1 << int(v))) if v else 0
                 for v in nvalid]
        keep = torch.tensor([[(m >> k) & 1 == 1 for m in masks]
                             for k in range(n)])
        values = torch.where(torch.isfinite(xs), xs, 0.0)
        nkept = keep.sum(0).float()
        mean = rj._colsum(values, keep) / torch.clamp_min(nkept, 1.0)
        wmean = rj._weighted_mean(xt, torch.from_numpy(w), keep, values,
                                  nkept)
        for i, m in enumerate(masks):
            col = xs[:, i].numpy()
            s, nk, lo, hi = f32(0), 0, f32(np.inf), f32(-np.inf)
            for k in range(n):
                if (m >> k) & 1:
                    s, nk = f32(s + col[k]), nk + 1
                    lo, hi = min(lo, col[k]), max(hi, col[k])
            assert f32(s / f32(max(nk, 1))) == mean[i].item()
            if nk == 0:
                continue
            ws = wn = fb = f32(0)
            for k in range(n):
                v = x[k, i]
                if lo <= v <= hi and v != 0:
                    ws, wn = f32(ws + f32(v * w[k, i])), f32(wn + w[k, i])
                    fb = f32(fb + v) if v > 0 else fb
            want = ws / wn if wn != 0 and ws != 0 else fb / f32(nk)
            assert f32(want) == wmean[i].item()


def test_sigmedian_resort_closed_form():
    """After a SIGMEDIAN round on a sorted column, the low candidates are
    a prefix and the high ones a suffix of its valid rows, and the sorted
    replaced column is the untouched middle with the median's copies
    merged in at its rank (the closed-form re-sort of scripts/
    k1_variants.py's resort_merge variant of the register kernel), bit
    for bit equal to torch.sort — over several rounds of columns with
    ties and negatives, N = 1 to 32, and thresholds for which the prefix
    and the suffix meet."""
    rng = np.random.default_rng(23)
    for n in range(1, 33):
        p = 256
        x = rng.normal(0.0, 0.2, (n, p)).astype(np.float32)
        x[rng.random((n, p)) < 0.25] = np.float32(-0.125)     # ties
        x[rng.random((n, p)) < 0.05] = np.float32(3.0)        # outliers
        x[rng.random((n, p)) < 0.05] = np.float32(0)          # not data
        xt = torch.from_numpy(x)
        valid = xt != 0
        nvalid = valid.sum(0, dtype=torch.int32)
        v = torch.sort(torch.where(valid, xt, float("inf")), 0).values
        rows = rj._rows(v)
        vmask = rows < nvalid
        zero = torch.zeros_like(nvalid)
        nv = nvalid.float()
        for sig in (3.0, 1.0, 0.5, -0.3):
            for _ in range(3):
                med = rj._window_median(v, zero, nvalid)
                mean = rj._colsum(v, vmask) / torch.clamp_min(nv, 1.0)
                d = v - mean
                var = rj._colsum(d * d, vmask) / torch.clamp_min(nv - 1, 1)
                sd = torch.sqrt(torch.clamp_min(var, 0.0))
                low = vmask & ((med - v) > sd * sig)
                high = vmask & ((v - med) > sd * sig)
                nl = low.sum(0, dtype=torch.int32)
                nh = high.sum(0, dtype=torch.int32)
                assert torch.equal(low, rows < nl)
                assert torch.equal(high, vmask & (rows >= nvalid - nh))
                want = torch.sort(torch.where(low | high, med, v), 0).values
                u = torch.minimum(nl + nh, nvalid)
                mid = (rows >= nl) & (rows < nvalid - nh)
                j = (mid & (v < med)).sum(0, dtype=torch.int32)
                head = v.gather(0, torch.clamp(rows + nl, max=n - 1).long())
                tail = v.gather(0, torch.clamp(rows - (u - nl), min=0).long())
                got = torch.where(rows < j, head, torch.where(
                    rows < j + u, med, torch.where(vmask, tail, v)))
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
                v = want


def test_kernel_source_constants_match():
    """The CUDA source repeats the mode numbers, the normalization modes,
    the SIGMEDIAN round bound and the winsorized step bound of the Python
    side; they must agree."""
    import re

    from siril_tpu_torch.kernels import build
    from siril_tpu_torch.ops import normalization as nm

    src = open(f"{build.CSRC}/reject_stack.cu").read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    for name in ("NO_REJEC", "PERCENTILE", "SIGMA", "MAD", "SIGMEDIAN",
                 "WINSORIZED", "LINEARFIT", "GESDT",
                 "SIGMEDIAN_MAX_ROUNDS", "WINSOR_MAX_STEPS"):
        assert consts[name] == getattr(rj, name), name
    for name in ("NO_NORM", "ADDITIVE", "ADDITIVE_SCALING"):
        assert consts[name] == getattr(nm, name), name


def test_k1_variants_apply():
    """Every design variant of scripts/k1_variants.py is an edit that
    applies to the current CUDA source, for every mode it takes (the
    script runs only on a card, where a stale edit would stop it)."""
    import importlib.util

    from siril_tpu_torch.kernels import build

    spec = importlib.util.spec_from_file_location(
        "k1_variants", f"{build.CSRC}/../../scripts/k1_variants.py")
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    src = open(f"{build.CSRC}/reject_stack.cu").read()
    assert kv.float_only(src) != src
    for mode, (rtype, _, _) in kv.MODES.items():
        assert rj.REJECTION_NAMES[mode] == rtype
        for columns in (False, True):
            table = kv.variants(mode, columns)
            assert table["base"][1](src) == src
            for name, (_, edit) in table.items():
                assert name == "base" or edit(src) != src or \
                    name.startswith("ready"), name
    assert "vote16" in kv.variants("gesdt")
    assert "columns64" in kv.variants("sigma", True)


def test_sigmedian_cap_counted(monkeypatch):
    """A pixel whose SIGMEDIAN loop stops at SIGMEDIAN_MAX_ROUNDS while it
    is still replacing values is counted (the reference would run it on);
    a pixel that converged is not."""
    rng = np.random.default_rng(77)
    n = 12
    stack = _mkstack(rng, n=n, p=400)
    scale, offset, mul = _coeffs(rng, n)
    k1.reset_counts()
    full = _port(stack, scale, offset, mul, rj.SIGMEDIAN, NO_NORM, 2.0, 2.0)
    assert k1.capped_pixels() == 0
    monkeypatch.setattr(rj, "SIGMEDIAN_MAX_ROUNDS", 1)
    k1.reset_counts()
    one = _port(stack, scale, offset, mul, rj.SIGMEDIAN, NO_NORM, 2.0, 2.0)
    replaced = (one[1] + one[2]) > 0        # still replacing at round 1
    assert k1.capped_pixels() == int(replaced.sum()) > 0
    differs = (one[0] != full[0]) | (one[1] != full[1]) | \
        (one[2] != full[2])
    assert differs.any() and not (differs & ~replaced).any()
    k1.reset_counts()
    assert k1.capped_pixels() == 0


PINNED = np.array([0.04703686, 0.04947018, 0.04986295, 0.05015909,
                   0.05094436, 0.05327371, 0.9499962], np.float32)


def test_winsorized_pinned_column():
    """A column on which the JAX package's Aitken-accelerated σ loop
    undershoots and keeps the 0.95 ray (mean 0.2749, 1 low / 2 high):
    the port rejects what the C loop rejects."""
    _, orl, orh, om = oracle.reject_pixel(PINNED, "winsorized", 3.0, 3.0)
    assert (orl, orh) == (0, 1)
    mean, rl, rh = rj.rejection_mean(torch.from_numpy(PINNED[:, None]),
                                     rj.WINSORIZED, 3.0, 3.0)
    assert (int(rl[0]), int(rh[0])) == (0, 1)
    assert abs(float(mean[0]) - 0.0501245) <= 2e-6
    assert abs(float(mean[0]) - om) <= 2e-6


@pytest.mark.parametrize("n,p", [(5, 1500), (7, 1500), (12, 1200),
                                 (24, 800)])
def test_winsorized_vs_oracle(n, p):
    """Background 0.1 with noise σ 0.01 and cosmic rays at 1.0 in 1 % of
    the values: every pixel's counts equal the oracle's and its mean is
    within 2e-6."""
    rng = np.random.default_rng(500 + n)
    x = (0.1 + 0.01 * rng.standard_normal((n, p))).astype(np.float32)
    x[rng.random((n, p)) < 0.01] = 1.0
    mean, rl, rh = rj.rejection_mean(torch.from_numpy(x), rj.WINSORIZED,
                                     3.0, 3.0)
    mismatch, dmax = 0, 0.0
    for i in range(p):
        _, orl, orh, om = oracle.reject_pixel(x[:, i], "winsorized", 3.0,
                                              3.0)
        mismatch += (int(rl[i]), int(rh[i])) != (orl, orh)
        dmax = max(dmax, abs(float(mean[i]) - om))
    assert mismatch == 0
    assert dmax <= 2e-6
    assert int(rh.sum()) > 0


def test_winsor_bounds_equal_accumulated_clip():
    """On sorted columns, the accumulated winsorized values w (each step
    clamps the previous w) equal clamp(xs, L, H) with (L, H) clamped each
    step, bit for bit: the form the plain version and the kernel keep."""
    rng = np.random.default_rng(11)
    n, p = 24, 20000
    xs = torch.from_numpy(np.sort(rng.normal(0.3, 0.1, (n, p)).astype(
        np.float32), axis=0))
    w = xs
    low = torch.full((p,), -float("inf"))
    high = torch.full((p,), float("inf"))
    for _ in range(12):
        c = torch.from_numpy(rng.normal(0.3, 0.05, p).astype(np.float32))
        h = torch.from_numpy(np.abs(rng.normal(0, 0.1, p)).astype(
            np.float32))
        m0, m1 = c - h, c + h
        w = torch.minimum(torch.maximum(w, m0), m1)
        low = torch.minimum(torch.maximum(low, m0), m1)
        high = torch.minimum(torch.maximum(high, m0), m1)
        form = torch.minimum(torch.maximum(xs, low), high)
        assert torch.equal(form.view(torch.int32), w.view(torch.int32))


def test_winsor_cap_counted(monkeypatch):
    """A clipping round whose σ iteration stops at WINSOR_MAX_STEPS before
    σ settled is counted (the reference would run it on); a round that
    settled is not."""
    rng = np.random.default_rng(78)
    n = 12
    stack = _mkstack(rng, n=n, p=400)
    stack[:, :5] = 0.5                 # σ0 = 0: settles at its first step
    scale, offset, mul = _coeffs(rng, n)
    k1.reset_counts()
    full = _port(stack, scale, offset, mul, rj.WINSORIZED, NO_NORM, 3.0,
                 3.0)
    assert k1.capped_pixels() == 0
    monkeypatch.setattr(rj, "WINSOR_MAX_STEPS", 1)
    k1.reset_counts()
    work = {}
    one = reject_stack_plain(*(torch.from_numpy(v) for v in
                               (stack, scale, offset, mul)),
                             rtype=rj.WINSORIZED, mode=NO_NORM, siglow=3.0,
                             sighigh=3.0, work=work,
                             capped=k1._capped_counter(torch.device("cpu")))
    rounds = work["winsor_steps"]      # one step a round at this bound
    assert 0 < k1.capped_pixels() <= rounds - 5
    differs = (one[0].numpy() != full[0])
    assert differs.any() and not differs[:5].any()
    k1.reset_counts()
    assert k1.capped_pixels() == 0


#: modes of the register path's classes with weights (K1e over them)
K1E_MODES = [(rj.WINSORIZED, 3.0, 3.0), (rj.SIGMA, 3.0, 3.0),
             (rj.LINEARFIT, 3.0, 3.0), (rj.GESDT, 0.3, 0.05),
             (rj.SIGMEDIAN, 3.0, 3.0), (rj.NO_REJEC, 3.0, 3.0)]


def _past32_case(rtype, sl, sh, n, dtype, wkind):
    rng, stack = _case_stack(4000 + 10 * n + rtype, n, 256, dtype)
    scale, offset, mul = _coeffs(rng, n)
    w = _weights(rng, wkind, n, 256)
    ref = _jax_block(stack, scale, offset, mul, rtype, ADDITIVE_SCALING, sl,
                     sh, w)
    got = _port_full(stack, scale, offset, mul, rtype, ADDITIVE_SCALING, sl,
                     sh, w)
    if rtype == rj.WINSORIZED:
        xn = normalize_block(*(torch.from_numpy(v) for v in
                               (stack, scale, offset, mul)),
                             ADDITIVE_SCALING).numpy()
        winsorized_vs_jax(got, ref, xn, sl, sh, w)
    else:
        _assert_parity(got, ref)
    assert got[1].sum() + got[2].sum() > 0 or rtype == rj.NO_REJEC


@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("n", [33, 48, 64, 100])
@pytest.mark.parametrize("rtype,sl,sh", WINDOW + MASKED)
def test_plain_past_32_frames_vs_jax(rtype, sl, sh, n, dtype):
    """Past 32 frames (the column kernel's range): every mode against the
    JAX package's block kernel, additive+scaling."""
    _past32_case(rtype, sl, sh, n, dtype, None)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
@pytest.mark.parametrize("n", [33, 48, 64, 100])
@pytest.mark.parametrize("rtype,sl,sh", K1E_MODES)
def test_plain_past_32_frames_weights_vs_jax(rtype, sl, sh, n, dtype):
    """Past 32 frames, the weighted mean (per-frame weights) over the K1e
    modes against the JAX package's block kernel."""
    _past32_case(rtype, sl, sh, n, dtype, "frame")


def _gesdt_walk_replay(col, nvalid, crit, max_outliers, n_full):
    """One sorted column's GESDT as the kernel runs it, in float32
    scalars: one walk with the window sums, recording each step's side
    and the last flagged step; then the confirmations replayed from the
    sides alone, with no sums.  Returns (keep mask over the rows, rej_low,
    rej_high)."""
    f32 = np.float32

    def fma(a, b, c):
        return f32(np.float64(a) * np.float64(b) + np.float64(c))

    n = len(col)
    M = max(max_outliers, 1)
    removed = n_full - nvalid
    walk = min(M, max_outliers - removed)
    lo, hi, sides, last_flag = 0, nvalid, [], -1
    while len(sides) < walk and hi - lo > 1:
        j = len(sides)
        t1 = t2 = f32(0)
        for k in range(lo, hi):
            t1 = f32(t1 + col[k])
            t2 = f32(t2 + f32(col[k] * col[k]))
        size = f32(hi - lo)
        mean = f32(t1 / max(size, f32(1)))
        var = f32(fma(-t1, mean, t2) / max(f32(size - f32(1)), f32(1)))
        sd = f32(np.sqrt(max(var, f32(0))))
        dev_low, dev_high = f32(mean - col[lo]), f32(col[hi - 1] - mean)
        take_high = dev_high > dev_low
        g = f32((dev_high if take_high else dev_low) / max(sd, f32(1e-30)))
        if hi - lo > 2 and g > crit[min(removed + j, M - 1)]:
            last_flag = j
        sides.append(take_high)
        hi, lo = (hi - 1, lo) if take_high else (hi, lo + 1)
    med = f32(f32(0.5) * f32(col[(nvalid - 1) // 2] + col[nvalid // 2]))
    keep = [k < nvalid for k in range(n)]
    rl = rh = 0
    lo, hi = 0, nvalid
    for j in range(min(len(sides), max(last_flag, min(1, M - 1)) + 1)):
        th = sides[j]
        if (col[hi - 1] if th else col[lo]) >= med:
            rh += 1
        else:
            rl += 1
        keep[hi - lo - 1 if th else lo] = False
        hi, lo = (hi - 1, lo) if th else (hi, lo + 1)
    return keep, rl, rh


def test_gesdt_walk_then_replay():
    """GESDT's second pass needs nothing of the walk's sums: the walk run
    once, recording each step's side, then the confirmations replayed from
    the sides (the kernel's form) give the plain version's keep mask and
    counts, for N = 5 to 32 frames and outlier budgets 1 to N, with
    invalid values (so that some columns have less budget or none)."""
    rng = np.random.default_rng(31)
    checked = 0
    for n in range(5, 33):
        p = 16
        x = (0.3 + 0.02 * rng.standard_normal((n, p))).astype(np.float32)
        x[rng.random((n, p)) < 0.08] = np.float32(0.95)       # rays
        x[rng.random((n, p)) < 0.04] = np.float32(0.01)       # dead
        x[rng.random((n, p)) < 0.06] = np.float32(0)          # not data
        x[:, 0] = np.float32(0.5)                             # σ = 0
        xt = torch.from_numpy(x)
        valid = xt != 0
        nvalid = valid.sum(0, dtype=torch.int32)
        xs = torch.sort(torch.where(valid, xt, float("inf")), 0).values
        s1 = torch.where(torch.isfinite(xs), xs, 0.0)
        for mo in range(1, n + 1):
            crit = rj.gesdt_critical_values(n, 0.05, mo)
            keep, rl, rh = rj._gesdt(xs, s1, s1 * s1, nvalid, crit, mo, n,
                                     None)
            for i in range(p):
                if int(nvalid[i]) <= 1:
                    continue
                col = xs[:, i].numpy()
                mk, ml, mh = _gesdt_walk_replay(col, int(nvalid[i]), crit,
                                                mo, n)
                assert mk == keep[:, i].tolist(), (n, mo, i)
                assert (ml, mh) == (int(rl[i]), int(rh[i])), (n, mo, i)
                checked += ml + mh
    assert checked > 1000
