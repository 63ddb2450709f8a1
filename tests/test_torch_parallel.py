"""Multi-device stacking of the port (``siril_tpu_torch/parallel``) against
the JAX package's ``siril_tpu/parallel`` on the CPU.

The port runs over ``torch.distributed`` with gloo: each case spawns 1-4
ranks (``torch.multiprocessing.spawn``) in a subprocess with its own time
limit, and every rank destroys its process group.  The JAX package runs
its 8-device virtual CPU mesh (tests/conftest.py).  Held:

- ``survey_stack_sharded`` on 1, 2 and 3 ranks (and a 2 × 2 mesh, whose
  frame groups repeat the work) bit-equal to each other, and to the JAX
  package's ``make_mesh(1, 8)`` run within 2e-6 with equal rejection
  counts for SIGMA and GESDT; WINSORIZED wherever the JAX package's
  Aitken loop agrees with the C oracle (tests/test_torch_rejection.py
  ``winsorized_vs_jax``), and where it does not, the oracle gives the
  port's mean;
- the sharded median: the sorted median's order statistic on any number
  of ranks;
- ``fused_pipeline_step`` on a 2 × 2 mesh bit-equal to 1 × 1, and to the
  JAX package's ``make_mesh(2, 4)`` step within 2e-6 with equal totals,
  for the gather, shift, rotation, affine and perspective routes at
  tests/test_stacking.py's sizes; ``full_stack_step`` likewise;
- ``plan_survey_rows`` and ``coeffs_from_estimators`` equal;
- the config-5 chain (stack, plate solve, PCC) on one rank;
- cancellation between blocks: the survey and the staged stack of both
  packages.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-6
SIGMA, WINSORIZED, GESDT = 2, 5, 7
SURVEY_SHAPE = (6, 1, 64, 67)              # n, L, H, W: 4 blocks of 20 rows
SURVEY_BUDGET = 6 * 67 * 16 * 20           # bytes per device for 1 rank
CHAIN_SHAPE = (5, 3, 256, 257)


# ---------------------------------------------------------------------------
# the rank side: no JAX here
# ---------------------------------------------------------------------------


def survey_reader(n, H, W, seed=11):
    """tests/test_survey_sharded.py's reader with denser outliers: a sky
    gradient, a gain and offset per frame, impulses and dead zeros, seeded
    per (frame, channel, block)."""
    def read_rows(k, c, y0, y1):
        rs = np.random.default_rng([seed, k, c, y0])
        yy = np.arange(y0, y1, dtype=np.float32)[:, None] / H
        xx = np.arange(W, dtype=np.float32)[None, :] / W
        base = 0.2 + 0.05 * xx + 0.03 * yy + 0.01 * (k + 1) / n
        gain = 1.0 + 0.04 * ((k * 7919) % 13 - 6) / 6.0
        block = (base * gain + rs.standard_normal((y1 - y0, W),
                                                  dtype=np.float32) * 0.01)
        block[rs.random((y1 - y0, W)) < 1e-2] = 0.98
        block[rs.random((y1 - y0, W)) < 5e-3] = 0.0
        return np.clip(block, 0.0, 1.0).astype(np.float32)

    return read_rows


def chain_reader(star_field):
    def read_rows(k, c, y0, y1):
        rs = np.random.default_rng([99, k, c, y0])
        gain = [1.0, 0.95, 1.05][c]
        block = (0.05 + star_field[y0:y1] * gain
                 + rs.standard_normal((y1 - y0, star_field.shape[1]),
                                      dtype=np.float32) * 0.002)
        return np.clip(block, 0.0, 1.0).astype(np.float32)

    return read_rows


def _survey(mesh, rtype, budget):
    from siril_tpu_torch.parallel.survey import survey_stack_sharded

    n, L, H, W = SURVEY_SHAPE
    r = survey_stack_sharded(survey_reader(n, H, W), n, L, H, W, mesh,
                             rtype, 3, budget_bytes_per_dev=budget)
    return dict(data=r.data, tot=r.total_rejected, blocks=r.n_blocks,
                rows=r.rows_per_block)


def _median_case(mesh):
    """The sharded median and order statistics of rows with zeros, a
    constant row, an empty row and an even count, on this rank's
    columns."""
    from siril_tpu_torch.parallel import sharding as sh

    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 1001)).astype(np.float32)
    x[:, ::7] = 0.0
    x[2] = 0.0
    x[3] = 0.25
    x[4, :] = np.where(np.arange(1001) < 500, x[4], 0.0)
    lo, hi = sh.local_pixels(mesh, 1001)
    xt = torch.from_numpy(x[:, lo:hi].copy())
    med = sh.sharded_median(xt, xt != 0, mesh.get_group("pix"))
    est = sh.sharded_lite_estimators(xt, mesh.get_group("pix"))
    return dict(median=med.numpy(), scale=est["scale"].numpy())


def _fused(mesh, inputs):
    from siril_tpu_torch.parallel import sharding as sh

    out = {}
    for route, d in inputs.items():
        n, H, W = d["raw"].shape
        a, b = sh.local_frames(mesh, n)
        step = sh.fused_pipeline_step(
            mesh, SIGMA, int(d["mode"]), 3.0, 3.0, n, H, W,
            shift_warp=route == "shift", rot_warp=route == "rotation",
            aff_warp=route == "affine",
            persp_warp=int(d["D"]) if route == "perspective" else 0)
        mean, rl, rh = step(torch.from_numpy(d["raw"][a:b].copy()),
                            torch.from_numpy(d["params"][a:b].copy()),
                            torch.from_numpy(d["dark"]),
                            torch.from_numpy(d["flat"]), 0)
        out[route] = dict(mean=mean.numpy(), tot=(int(rl), int(rh)),
                          pix=sh.local_pixels(mesh, H * W))
    d = inputs["shift"]
    n, H, W = d["raw"].shape
    x = ((d["raw"].astype(np.float32) + 32768.0)
         * np.float32(1 / 65535.0)).reshape(n, H * W)
    F = mesh.size(0)
    fa = mesh.get_local_rank("frame") * (n // F)
    lo, hi = sh.local_pixels(mesh, H * W)
    step = sh.full_stack_step(mesh, SIGMA, 3, 3.0, 3.0, n)
    m, rl, rh = step(torch.from_numpy(x[fa:fa + n // F, lo:hi].copy()), 0)
    out["full_stack_step"] = dict(mean=m.numpy(), rl=rl.numpy(),
                                  rh=rh.numpy(), pix=(lo, hi))
    step = sh.sharded_rejection_kernel(mesh, SIGMA, 3.0, 3.0, n)
    m, rl, rh = step(torch.from_numpy(x[:, lo:hi].copy()))
    out["rejection"] = dict(mean=m.numpy(), rl=rl.numpy(), rh=rh.numpy(),
                            pix=(lo, hi))
    return out


def _chain(mesh, d):
    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.solver import SolveArgs
    from siril_tpu_torch.parallel.survey import survey_platesolve_pcc_stack

    n, L, H, W = CHAIN_SHAPE
    cat = Catalog(ra=d["ra"], dec=d["dec"], mag=d["mag"], bv=d["bv"])
    img, solve, sres = survey_platesolve_pcc_stack(
        chain_reader(d["star_field"]), n, L, H, W, mesh, cat,
        SolveArgs(ra=150.2, dec=39.8, pixel_scale=3.1, mag_limit=13.0),
        rtype=SIGMA, budget_bytes_per_dev=64 << 20)
    return dict(image=img.host(), stack=sres.data, history=img.history,
                scale=solve.scale_arcsec, crval=np.asarray(solve.wcs.crval),
                blocks=sres.n_blocks)


def _cancel(mesh):
    """A stop requested while the second row block is read (after the
    estimator pass's n × 4 reads and the first block's n): the survey
    stops before the third block with ProcessingCancelled."""
    from siril_tpu_torch.core import processing
    from siril_tpu_torch.parallel.survey import survey_stack_sharded

    n, L, H, W = SURVEY_SHAPE
    inner = survey_reader(n, H, W)
    calls = []

    def read_rows(k, c, y0, y1):
        calls.append(y0)
        if len(calls) == 4 * n + n + 1:
            processing.request_stop()
        return inner(k, c, y0, y1)

    try:
        survey_stack_sharded(read_rows, n, L, H, W, mesh, SIGMA, 3,
                             budget_bytes_per_dev=SURVEY_BUDGET,
                             prefetch=False)
    except processing.ProcessingCancelled as e:
        return dict(cancelled=str(e), calls=calls)
    finally:
        processing.clear_stop()
    return dict(cancelled=None)


def _rank_main(rank, world, store, out_dir, job, inputs_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from siril_tpu_torch.parallel.sharding import make_mesh

        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        out = {}
        mesh = make_mesh(1, world)
        out["median"] = _median_case(mesh)
        for rtype in (SIGMA, WINSORIZED, GESDT):
            out[f"survey {rtype}"] = _survey(mesh, rtype,
                                             SURVEY_BUDGET // world)
        if job.get("fused"):
            grid = make_mesh(*job["fused"])
            out["fused"] = _fused(grid, inputs["fused"])
            if job["fused"][0] > 1:
                out["survey grid"] = _survey(grid, SIGMA,
                                             SURVEY_BUDGET // world)
        if job.get("chain"):
            out["chain"] = _chain(mesh, inputs["chain"])
            out["cancel"] = _cancel(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_main(world, store, out_dir, job, inputs_path):
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world, store, out_dir, json.loads(job),
                               inputs_path), nprocs=world)


def run_ranks(jobs, inputs, timeout=240):
    """Spawn the gloo ranks of each (world, job) of ``jobs``, every world
    in a subprocess of its own, all at once; {world: [rank results]}."""
    d = tempfile.mkdtemp(prefix="torch_ranks_")
    path = os.path.join(d, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    code = ("import sys; from tests.test_torch_parallel import spawn_main; "
            "spawn_main(int(sys.argv[1]), *sys.argv[2:])")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world, job in jobs:
        out = os.path.join(d, f"world{world}")
        os.makedirs(out)
        procs[world] = (out, subprocess.Popen(
            [sys.executable, "-c", code, str(world),
             os.path.join(out, "store"), out, json.dumps(job), path],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    res = {}
    try:
        for world, (out, p) in procs.items():
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            res[world] = []
            for r in range(world):
                with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                    res[world].append(pickle.load(f))
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# inputs (made with the JAX package's helpers where they exist)
# ---------------------------------------------------------------------------


def _rotation_inputs():
    rng = np.random.default_rng(17)
    N, H, W = 6, 32, 40
    raw = rng.integers(-20000, 20000, (N, H, W)).astype(np.int16)
    th = rng.uniform(-0.02, 0.02, N)
    rot = np.zeros((N, 5), np.float32)
    rot[:, 0] = np.cos(th)
    rot[:, 1] = np.sin(th)
    rot[:, 2:4] = rng.uniform(-2, 2, (N, 2))
    rot[2, 4] = 1.0
    return raw, rot


def _czt_inputs(seed, flipped, persp):
    from siril_tpu.ops.interp import (_sig_pair, affines_from_Hs,
                                      perspective_split_from_Hs)

    rng = np.random.default_rng(seed)
    N, H, W = 6, 32, 40
    raw = rng.integers(-20000, 20000, (N, H, W)).astype(np.int16)
    Hs = np.tile(np.eye(3), (N, 1, 1))
    c = np.array([(W - 1) / 2, (H - 1) / 2])
    for i in range(N):
        th = rng.uniform(-0.02, 0.02)
        band = 0.015 if persp else 0.02
        sx = 1.0 + rng.uniform(-band, band)
        sy = 1.0 + rng.uniform(-band, band)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        if i == flipped:
            R = -R
        A = R @ np.diag([sx, sy])
        Hs[i, :2, :2] = A
        Hs[i, :2, 2] = c - A @ c + rng.uniform(-1.5, 1.5, 2)
        if persp:
            Hs[i, 2, :2] = rng.uniform(-1.0, 1.0, 2) * 4e-4
    D = 0
    if persp:
        M, b, flip, K, D = perspective_split_from_Hs(Hs, (H, W))
        extra = [K.reshape(N, 9)]
    else:
        M, b, flip = affines_from_Hs(Hs, (H, W))
        extra = []
    sx_hi, sx_lo = _sig_pair((M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1]
                              * M[:, 1, 0]) / M[:, 1, 1] / W)
    sy_hi, sy_lo = _sig_pair(M[:, 1, 1] / H)
    packed = np.concatenate(
        [M.reshape(N, 4), b] + extra
        + [np.asarray(flip)[:, None].astype(np.float64), sx_hi[:, None],
           sx_lo[:, None], sy_hi[:, None], sy_lo[:, None]],
        axis=1).astype(np.float32)
    return raw, packed, int(D)


@pytest.fixture(scope="module")
def fused_inputs():
    N, H, W = 8, 32, 32
    rng = np.random.default_rng(7)
    raw = rng.integers(-20000, 20000, (N, H, W)).astype(np.int16)
    dark32 = np.zeros((H, W), np.float32)
    flat32 = np.ones((H, W), np.float32)
    Hinv = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    Hinv[:, :2, 2] = rng.uniform(-2, 2, (N, 2))
    shifts = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    out = {"gather": dict(raw=raw, params=Hinv, dark=dark32, flat=flat32,
                          mode=3, D=0),
           "shift": dict(raw=raw, params=shifts, dark=dark32, flat=flat32,
                         mode=3, D=0)}
    dark = np.full((32, 40), 0.005, np.float32)
    flat = np.ones((32, 40), np.float32)
    raw, rot = _rotation_inputs()
    out["rotation"] = dict(raw=raw, params=rot, dark=dark, flat=flat,
                           mode=0, D=0)
    raw, packed, _ = _czt_inputs(23, 2, False)
    out["affine"] = dict(raw=raw, params=packed, dark=dark, flat=flat,
                         mode=0, D=0)
    raw, packed, D = _czt_inputs(29, 3, True)
    out["perspective"] = dict(raw=raw, params=packed, dark=dark, flat=flat,
                              mode=0, D=D)
    return out


@pytest.fixture(scope="module")
def chain_inputs():
    from tests.test_astrometry import make_wcs

    rng = np.random.default_rng(12345)
    Hs, Ws = CHAIN_SHAPE[2:]
    true = make_wcs(ra=150.0, dec=40.0, scale=3.0, rot=5.0, h=Hs, w=Ws)
    nstars = 600
    ra = 150.0 + rng.uniform(-0.6, 0.6, nstars)
    dec = 40.0 + rng.uniform(-0.6, 0.6, nstars)
    mag = rng.uniform(6, 12, nstars)
    bv = rng.uniform(0.2, 1.2, nstars)
    x, y = true.world2pix(ra, dec)
    yy, xx = np.mgrid[0:Hs, 0:Ws]
    star_field = np.zeros((Hs, Ws), np.float32)
    for xi, yi, mi in zip(x, y, mag):
        if 10 < xi < Ws - 10 and 10 < yi < Hs - 10:
            A = min(10 ** (-0.4 * (mi - 12.0)) * 0.1, 0.8)
            if A >= 0.02:
                star_field += (A * np.exp(-(((xx - xi) ** 2
                                             + (yy - yi) ** 2) / 4.0))
                               ).astype(np.float32)
    return dict(ra=ra, dec=dec, mag=mag, bv=bv, star_field=star_field)


@pytest.fixture(scope="module")
def ranks(fused_inputs, chain_inputs):
    """Every world size's rank results: {world: [rank results]}."""
    inputs = dict(fused=fused_inputs, chain=chain_inputs)
    return run_ranks([(1, dict(fused=[1, 1], chain=True)), (2, {}), (3, {}),
                      (4, dict(fused=[2, 2]))], inputs)


@pytest.fixture(scope="module")
def jax_survey():
    from siril_tpu.parallel.sharding import make_mesh
    from siril_tpu.parallel.survey import survey_stack_sharded

    n, L, H, W = SURVEY_SHAPE
    out = {}
    for rtype in (SIGMA, WINSORIZED, GESDT):
        r = survey_stack_sharded(survey_reader(n, H, W), n, L, H, W,
                                 make_mesh(1, 8), rtype, 3,
                                 budget_bytes_per_dev=SURVEY_BUDGET // 8)
        out[rtype] = dict(data=r.data, tot=r.total_rejected,
                          blocks=r.n_blocks, rows=r.rows_per_block)
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("rtype", [SIGMA, WINSORIZED, GESDT])
def test_survey_ranks_bit_equal(ranks, world, rtype):
    """k ranks give the 1-rank stack bit for bit, on every rank."""
    one = ranks[1][0][f"survey {rtype}"]
    assert one["blocks"] == 4
    for r in ranks[world]:
        got = r[f"survey {rtype}"]
        assert (got["blocks"], got["rows"]) == (one["blocks"], one["rows"])
        np.testing.assert_array_equal(got["data"], one["data"])
        assert got["tot"] == one["tot"]


def test_survey_grid_bit_equal(ranks):
    """On a 2 × 2 mesh the frame groups repeat the pixel shards' work:
    the same stack."""
    one = ranks[1][0][f"survey {SIGMA}"]
    for r in ranks[4]:
        np.testing.assert_array_equal(r["survey grid"]["data"], one["data"])
        assert r["survey grid"]["tot"] == one["tot"]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_median_order_statistic(ranks, world):
    """The sharded median is the port's sorted median (``median_rows``) on
    any number of ranks, and the lite scale 1.5·MAD of it."""
    from siril_tpu_torch.ops.statistics import median_rows, norm_estimators

    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 1001)).astype(np.float32)
    x[:, ::7] = 0.0
    x[2] = 0.0
    x[3] = 0.25
    x[4, :] = np.where(np.arange(1001) < 500, x[4], 0.0)
    xt = torch.from_numpy(x)
    want = median_rows(xt, xt != 0).numpy()
    est = norm_estimators(xt, lite=True)
    for r in ranks[world]:
        np.testing.assert_array_equal(r["median"]["median"], want)
        np.testing.assert_array_equal(r["median"]["scale"],
                                      est["scale"].numpy())


@pytest.mark.parametrize("rtype", [SIGMA, GESDT])
def test_survey_vs_jax(ranks, jax_survey, rtype):
    got = ranks[1][0][f"survey {rtype}"]
    ref = jax_survey[rtype]
    assert (got["blocks"], got["rows"]) == (ref["blocks"], ref["rows"])
    assert got["tot"] == ref["tot"]
    assert ref["tot"][1] > 0 or rtype == SIGMA
    np.testing.assert_allclose(got["data"], ref["data"], rtol=0, atol=ATOL)


def test_survey_winsorized_vs_jax(ranks, jax_survey):
    """Winsorized: equal where the JAX package's loop agrees with the C
    oracle; where it does not, the oracle on the normalized column gives
    the port's mean, and the totals differ by exactly those columns."""
    import jax.numpy as jnp

    from siril_tpu.ops import rejection as jrj
    from siril_tpu.ops.normalization import ADDITIVE_SCALING
    from siril_tpu.ops.statistics import norm_estimators_hist_jax
    from siril_tpu.parallel.survey import coeffs_from_estimators
    from tests.test_torch_rejection import oracle_winsorized

    got = ranks[1][0][f"survey {WINSORIZED}"]
    ref = jax_survey[WINSORIZED]
    n, L, H, W = SURVEY_SHAPE
    rows = ref["rows"]
    reader = survey_reader(n, H, W)
    frames = np.stack([np.concatenate(
        [reader(k, 0, y0, min(y0 + rows, H)) for y0 in range(0, H, rows)])
        for k in range(n)]).reshape(n, H * W)
    e = norm_estimators_hist_jax(jnp.asarray(frames), lite=True)
    off, sc, _ = coeffs_from_estimators(np.asarray(e["location"])[None],
                                        np.asarray(e["scale"])[None],
                                        ADDITIVE_SCALING, 0)
    xnorm = np.where(frames != 0, frames * sc[0][:, None]
                     - off[0][:, None], 0.0).astype(np.float32)
    gm, rm = got["data"].reshape(-1), ref["data"].reshape(-1)
    idx = np.nonzero(np.abs(gm - rm) > ATOL)[0]
    d_port = d_jax = np.zeros(2, np.int64)
    for p in idx:
        ol, oh, om = oracle_winsorized(xnorm[:, p], 3.0, 3.0)
        assert abs(float(gm[p]) - om) <= 1e-5, p
        assert abs(float(rm[p]) - om) > ATOL, p
        jl, jh = (np.asarray(v)[0] for v in jrj.rejection_mean(
            jnp.asarray(xnorm[:, p:p + 1]), jrj.WINSORIZED, 3.0, 3.0,
            n_full=n)[1:])
        d_port = d_port + (ol, oh)
        d_jax = d_jax + (int(jl), int(jh))
    assert tuple(np.asarray(got["tot"]) - d_port) == \
        tuple(np.asarray(ref["tot"]) - d_jax)


def test_plan_rows_and_coeffs_vs_jax():
    from siril_tpu.parallel import survey as js
    from siril_tpu_torch.parallel import survey as ts

    for args in [(1000, 7800, 8, 2 << 30), (10, 100, 8, 1 << 30),
                 (1000, 6388, 8, 8 << 30), (6, 67, 3, 2000),
                 (24, 9576, 1, 40 << 30)]:
        assert ts.plan_survey_rows(*args) == js.plan_survey_rows(*args)
    rng = np.random.default_rng(3)
    loc = rng.uniform(0.1, 0.3, (3, 7)).astype(np.float32)
    sca = rng.uniform(0.01, 0.02, (3, 7)).astype(np.float32)
    sca[1, 2] = 0.0
    loc[2, 4] = 0.0
    for mode in range(5):
        for eq in (False, True):
            for a, b in zip(ts.coeffs_from_estimators(loc, sca, mode, 1, eq),
                            js.coeffs_from_estimators(loc, sca, mode, 1, eq)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _jax_fused(d, route, mesh_shape):
    import jax
    import jax.numpy as jnp

    from siril_tpu.parallel.sharding import fused_pipeline_step, make_mesh

    n, H, W = d["raw"].shape
    devs = jax.devices()[:mesh_shape[0] * mesh_shape[1]]
    step = fused_pipeline_step(
        make_mesh(*mesh_shape, devices=devs), SIGMA, int(d["mode"]), 3.0,
        3.0, n, H, W, shift_warp=route == "shift",
        rot_warp=route == "rotation", aff_warp=route == "affine",
        persp_warp=int(d["D"]) if route == "perspective" else 0)
    mean, rl, rh = step(jnp.asarray(d["raw"]), jnp.asarray(d["params"]),
                        jnp.asarray(d["dark"]), jnp.asarray(d["flat"]), 0)
    return np.asarray(mean), (int(rl), int(rh))


ROUTES = ["gather", "shift", "rotation", "affine", "perspective"]


@pytest.mark.parametrize("route", ROUTES)
def test_fused_step_vs_jax(ranks, fused_inputs, route):
    """The 2 × 2 mesh's columns assembled equal the 1 × 1 step's bit for
    bit, and the JAX package's make_mesh(2, 4) step within 2e-6, with
    equal rejection totals."""
    one = ranks[1][0]["fused"][route]
    P = one["mean"].size
    grid = np.zeros(P, np.float32)
    for r in ranks[4]:
        g = r["fused"][route]
        lo, hi = g["pix"]
        grid[lo:hi] = g["mean"]
        assert g["tot"] == one["tot"]
    np.testing.assert_array_equal(grid, one["mean"])
    mean, tot = _jax_fused(fused_inputs[route], route, (2, 4))
    assert np.isfinite(one["mean"]).all()
    assert one["tot"] == tot
    np.testing.assert_allclose(one["mean"], mean, rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["full_stack_step", "rejection"])
def test_full_stack_step_vs_jax(ranks, fused_inputs, which):
    """``full_stack_step`` (lite estimators over the pixel shards, frames
    gathered over ``frame``) and ``sharded_rejection_kernel``: the 2 × 2
    mesh's columns equal the 1 × 1 step's, and the JAX package's
    make_mesh(2, 4) step's within 2e-6 with equal counts."""
    import jax
    import jax.numpy as jnp

    from siril_tpu.parallel.sharding import (full_stack_step, make_mesh,
                                             sharded_rejection_kernel)

    d = fused_inputs["shift"]
    n, H, W = d["raw"].shape
    x = ((d["raw"].astype(np.float32) + 32768.0)
         * np.float32(1 / 65535.0)).reshape(n, H * W)
    one = ranks[1][0]["fused"][which]
    parts = {k: np.zeros(H * W, one[k].dtype) for k in ("mean", "rl", "rh")}
    for r in ranks[4]:
        g = r["fused"][which]
        lo, hi = g["pix"]
        for k in parts:
            parts[k][lo:hi] = g[k]
    for k in parts:
        np.testing.assert_array_equal(parts[k], one[k])
    mesh = make_mesh(2, 4, devices=jax.devices()[:8])
    if which == "rejection":
        mean, rl, rh = sharded_rejection_kernel(mesh, SIGMA, 3.0, 3.0, n)(
            jnp.asarray(x))
    else:
        mean, rl, rh = full_stack_step(mesh, SIGMA, 3, 3.0, 3.0, n)(
            jnp.asarray(x), 0)
    np.testing.assert_array_equal(one["rl"], np.asarray(rl))
    np.testing.assert_array_equal(one["rh"], np.asarray(rh))
    np.testing.assert_allclose(one["mean"], np.asarray(mean), rtol=0,
                               atol=ATOL)


def test_config5_chain_vs_jax(ranks, chain_inputs):
    """Stack → plate solve → PCC on one rank against the JAX package's
    8-device chain: the stack within 2e-6, the scale, the solution's
    centre, and the colour-calibrated image."""
    from siril_tpu.astrometry.catalog import Catalog
    from siril_tpu.astrometry.solver import SolveArgs
    from siril_tpu.parallel.sharding import make_mesh
    from siril_tpu.parallel.survey import survey_platesolve_pcc_stack

    got = ranks[1][0]["chain"]
    d = chain_inputs
    n, L, H, W = CHAIN_SHAPE
    img, solve, sres = survey_platesolve_pcc_stack(
        chain_reader(d["star_field"]), n, L, H, W, make_mesh(1, 8),
        Catalog(ra=d["ra"], dec=d["dec"], mag=d["mag"], bv=d["bv"]),
        SolveArgs(ra=150.2, dec=39.8, pixel_scale=3.1, mag_limit=13.0),
        rtype=SIGMA, budget_bytes_per_dev=64 << 20)
    assert got["blocks"] == sres.n_blocks
    np.testing.assert_allclose(got["stack"], sres.data, rtol=0, atol=ATOL)
    assert got["scale"] == pytest.approx(3.0, rel=0.02)
    assert got["scale"] == pytest.approx(solve.scale_arcsec, rel=1e-6)
    np.testing.assert_allclose(got["crval"], solve.wcs.crval, atol=1e-8)
    assert "PCC" in " ".join(got["history"])
    np.testing.assert_allclose(got["image"], img.host(), rtol=0, atol=1e-5)


def test_survey_cancelled_between_blocks(ranks):
    got = ranks[1][0]["cancel"]
    n = SURVEY_SHAPE[0]
    assert got["cancelled"] == "survey stack cancelled"
    assert got["calls"][4 * n:] == [0] * n + [20] * n


def test_make_mesh_needs_a_process_group():
    from siril_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_stack_cancelled_between_blocks(tmp_path, monkeypatch, package):
    """A stop requested while the first row block is read: the streamed
    stack of either package raises ProcessingCancelled at the next block,
    and the flag clears."""
    if package == "jax":
        from siril_tpu.core import processing
        from siril_tpu.core.image import SirilImage
        from siril_tpu.core.sequence import Sequence
        from siril_tpu.io.fits_io import write_fits
        from siril_tpu.ops import stacking as st
        read_name = "_read_block"
        kw = {}
    else:
        from siril_tpu_torch.core import processing
        from siril_tpu_torch.core.image import SirilImage
        from siril_tpu_torch.core.sequence import Sequence
        from siril_tpu_torch.io.fits_io import write_fits
        from siril_tpu_torch.ops import stacking as st
        read_name = "read_block"
        kw = dict(device="cpu")
    rng = np.random.default_rng(4)
    for i in range(4):
        write_fits(SirilImage(data=(0.2 + 0.01 * rng.random((1, 64, 48)))
                              .astype(np.float32)),
                   str(tmp_path / f"c_{i + 1:05d}.fit"), bitdepth=-32)
    seq = Sequence.scan("c_", str(tmp_path))
    inner = getattr(st, read_name)

    def reading(*a, **k):
        processing.request_stop()
        return inner(*a, **k)

    monkeypatch.setattr(st, read_name, reading)
    args = st.StackArgs(method="rej", create_rejmaps=True, block_mb=0)
    try:
        with pytest.raises(processing.ProcessingCancelled,
                           match="stacking cancelled"):
            st.stack_sequence(seq, args, **kw)
    finally:
        processing.clear_stop()
    assert processing.processing_should_continue()


def test_engine_cancelled_between_frames(tmp_path):
    """The sequence engine stops between frames: the frames done are
    written, the input keeps its selection, ProcessingCancelled."""
    from siril_tpu_torch.core import processing
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.fits_io import write_fits

    for i in range(5):
        write_fits(SirilImage(data=np.full((1, 8, 8), 0.1 * (i + 1),
                                           np.float32)),
                   str(tmp_path / f"e_{i + 1:05d}.fit"), bitdepth=-32)
    seq = Sequence.scan("e_", str(tmp_path))
    done = []

    def hook(ctx, idx, img):
        done.append(idx)
        if idx == 1:
            processing.request_stop()
        return img

    try:
        with pytest.raises(processing.ProcessingCancelled):
            run_sequence(SeqArgs(seq=seq, prefix="x_", image=hook,
                                 prefetch=1))
    finally:
        processing.clear_stop()
    assert done == [0, 1]
    assert sorted(os.listdir(tmp_path)).count("x_e_00001.fit") == 1
    assert seq.incl.all()
