"""The port's tools and utilities against the JAX package on the CPU: the
compute probe stage by stage (``tools/compute_probe.py``), the FITS
comparator (``tools/compare_fits.py``), ``utils/devfetch``,
``utils/splot``, ``utils/scriptrepo`` and ``utils/update``, and the
trace (``utils/trace``).

The probe's iteration is held against the same stage built here from the
JAX building blocks that ``siril_tpu/tools/compute_probe.py::_probe_fn``
uses (:69-160), on the same numpy-seeded inputs at n = 3, size 128:
rejection counts exactly equal, the stacked mean within 2e-6, the
calibrated and warped frames within 1e-6, estimators and statistics
within 1e-5 relative; the LM-fit sum of ``detect`` / ``full`` is held
only finite (the probe's frames are uniform noise, and one-pixel LM fits
are chaotic: ROADMAP §3, "Not faults").
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from siril_tpu_torch.tools import compute_probe as tcp

torch.set_num_threads(1)

N, SIZE, ITER = 3, 128, 1


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-32768, 32767, (N, 1, SIZE, SIZE)).astype(np.int16)
    shifts = rng.uniform(-3.0, 3.0, (N, 2)).astype(np.float32)
    yy = np.linspace(0.0, 1.0, SIZE, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, SIZE, dtype=np.float32)[None, :]
    bias = np.full((1, SIZE, SIZE), 0.02, np.float32)
    dark = (np.float32(0.004) + np.float32(0.001) * (yy * xx))[None]
    flat = (np.float32(1.0) - np.float32(0.2) * (
        (yy - np.float32(0.5)) ** 2 + (xx - np.float32(0.5)) ** 2))[None]
    return raw, shifts, bias, dark.astype(np.float32), \
        flat.astype(np.float32)


def _jax_iteration(i, raw, shifts, bias, dark, flat, stage):
    """``one_iter`` of the JAX probe (compute_probe.py:112-160) from its
    building blocks, returning its scalar and intermediates."""
    import jax.numpy as jnp
    from jax import lax

    from siril_tpu.ops import rejection as rj
    from siril_tpu.ops.calibration import make_calibrate_batch_kernel
    from siril_tpu.ops.interp import _shift_batch_fn
    from siril_tpu.ops.normalization import ADDITIVE_SCALING
    from siril_tpu.ops.stacking import make_block_kernel
    from siril_tpu.ops.statistics import (
        hist_median_jax,
        norm_estimators_hist_jax,
    )
    from siril_tpu.registration.starfinder import (
        StarFinderParams,
        _candidate_fn,
        _stats_cand_fit_fn,
        detection_radius,
    )

    feats = tcp.STAGE_FEATURES[stage]
    n = raw.shape[0]
    p = StarFinderParams()
    R = detection_radius(SIZE, SIZE, p)
    parts = {}
    x16 = jnp.asarray(raw) + jnp.int16(i)
    if not feats:
        return x16.astype(jnp.float32).sum() * jnp.float32(1e-9), parts
    xf = (x16.astype(jnp.float32) + 32768.0) * (1.0 / 65535.0)
    calib = make_calibrate_batch_kernel(True, True, True, False, False)
    xf = calib(xf, jnp.asarray(bias), jnp.asarray(dark), jnp.float32(1.0),
               jnp.asarray(flat), jnp.float32(1.0),
               jnp.zeros((0, 2), jnp.int32), jnp.zeros((0, 2), jnp.int32))
    parts["calib"] = xf
    acc = jnp.float32(0.0)
    if "fit" in feats:
        stats, vals, idx, fits = _stats_cand_fit_fn(
            R, tcp.MAX_CANDIDATES, float(p.sigma), int(p.profile))(xf[:, 0])
        parts["fit"] = (stats, fits)
        acc = acc + stats.sum() + fits.sum()
    elif "stats" in feats:
        flat2 = xf[:, 0].reshape(n, -1)
        valid = jnp.isfinite(flat2)
        med = hist_median_jax(flat2, valid)
        mad = hist_median_jax(jnp.abs(flat2 - med[:, None]), valid)
        parts["stats"] = jnp.stack([med, mad])
        acc = acc + med.sum() + mad.sum()
        if "cand" in feats:
            thrs = med + jnp.float32(p.sigma) * jnp.maximum(
                1.4826 * mad, 1e-7)
            cfn = _candidate_fn(R, tcp.MAX_CANDIDATES)
            v, _ = lax.map(lambda a: cfn(a[0], a[1]),
                           (xf[:, 0], thrs.astype(jnp.float32)))
            parts["cand"] = v
            acc = acc + jnp.where(jnp.isfinite(v), v, 0.0).sum()
    if "stack" in feats and "warp" not in feats:
        scale = jnp.ones(n, jnp.float32)
        offset = jnp.zeros(n, jnp.float32)
        warped = xf
    elif "warp" in feats:
        warped = _shift_batch_fn(3, True, 32, False)(
            xf, jnp.asarray(shifts) + 1e-3 * jnp.float32(i))
        parts["warped"] = warped
        if "est" in feats:
            est = norm_estimators_hist_jax(warped[:, 0].reshape(n, -1))
            scale = est["scale"][0] / jnp.where(est["scale"] == 0, 1.0,
                                                est["scale"])
            offset = scale * est["location"] - est["location"][0]
            parts["scale"], parts["offset"] = scale, offset
            if "stack" not in feats:
                return acc + scale.sum() + offset.sum(), parts
        else:
            return acc + warped.sum() * jnp.float32(1e-9), parts
    else:
        if "stats" not in feats:
            acc = acc + xf.sum() * jnp.float32(1e-9)
        return acc, parts
    kernel = make_block_kernel(rj.WINSORIZED, ADDITIVE_SCALING, 3.0, 3.0, n,
                               0, False, want_maps=True)
    mean, rl, rh = kernel(warped.reshape(n, -1), scale, offset,
                          jnp.ones(n, jnp.float32),
                          jnp.zeros((1, 1), jnp.float32),
                          jnp.zeros(1, jnp.float32))
    parts["stack"] = (mean, rl, rh)
    return acc + mean.sum() + rl.sum() + rh.sum(), parts


@pytest.fixture(scope="module")
def probe_runs():
    inputs = _inputs()
    out = {}
    for stage in tcp.STAGE_FEATURES:
        tp = {}
        tacc = tcp.probe_iteration(ITER, *inputs, stage, device="cpu",
                                   parts=tp)
        jacc, jp = _jax_iteration(ITER, *inputs, stage)
        out[stage] = (float(tacc), tp, float(jacc), jp)
    return out


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-30)), \
        (a, b)


@pytest.mark.parametrize("stage", list(tcp.STAGE_FEATURES))
def test_probe_stage_vs_jax(probe_runs, stage):
    tacc, tp, jacc, jp = probe_runs[stage]
    feats = tcp.STAGE_FEATURES[stage]
    assert np.isfinite(tacc) and np.isfinite(jacc)
    if "calib" in feats:
        np.testing.assert_allclose(_np(tp["calib"]), _np(jp["calib"]),
                                   rtol=0, atol=1e-6)
    if "fit" in feats:
        _rel(_np(tp["fit"][0]), _np(jp["fit"][0]), 1e-5)
        assert np.isfinite(_np(tp["fit"][1]).sum())
    elif "stats" in feats:
        _rel(_np(tp["stats"]), _np(jp["stats"]), 1e-5)
        if "cand" in feats:
            tv, jv = _np(tp["cand"]), _np(jp["cand"])
            assert (np.isfinite(tv).sum(1) == np.isfinite(jv).sum(1)).all()
            _rel(np.where(np.isfinite(tv), tv, 0).sum(),
                 np.where(np.isfinite(jv), jv, 0).sum(), 1e-5)
    if "warp" in feats:
        np.testing.assert_allclose(_np(tp["warped"]), _np(jp["warped"]),
                                   rtol=0, atol=1e-6)
    if "est" in feats:
        _rel(_np(tp["scale"]), _np(jp["scale"]), 1e-5)
        np.testing.assert_allclose(_np(tp["offset"]), _np(jp["offset"]),
                                   rtol=0, atol=1e-5)
    if "stack" in feats:
        tm, trl, trh = (_np(v) for v in tp["stack"])
        jm, jrl, jrh = (_np(v) for v in jp["stack"])
        assert np.array_equal(trl, jrl) and np.array_equal(trh, jrh)
        assert np.abs(tm - jm).max() <= 2e-6
    if "fit" not in feats:
        # the iteration's scalar, as the JAX probe sums it
        _rel(tacc, jacc, 1e-5)


def test_probe_ladder_keys_and_seed(monkeypatch):
    """``device_stage_probe`` returns the JAX probe's keys, is
    deterministic per seed, records a failed stage as its error, and
    stops at its deadline; without a card the probe raises."""
    r = tcp.device_stage_probe(("sum", "calib", "stack"), n=2, size=32,
                               iters=2, device="cpu")
    assert set(r) == {"stages_mpix_s", "details", "t_rtt_s", "n", "size",
                      "iters"}
    assert set(r["stages_mpix_s"]) == {"sum", "calib", "stack"}
    d = r["details"]["stack"]
    assert set(d) == {"compute_mpix_s", "t_loop_s", "t_rtt_s", "n", "size",
                      "iters", "stage", "checksum"}
    again = tcp.device_compute_probe(n=2, size=32, iters=2, stage="stack",
                                     device="cpu")
    assert again["checksum"] == d["checksum"]
    real = tcp.probe_iteration

    def fail(i, *a, **k):
        if a[5] == "calib":
            raise RuntimeError("boom")
        return real(i, *a, **k)

    monkeypatch.setattr(tcp, "probe_iteration", fail)
    r = tcp.device_stage_probe(("calib", "sum"), n=2, size=32, iters=1,
                               device="cpu")
    assert r["details"]["calib"] == {"error": "boom"}
    assert "sum" in r["stages_mpix_s"]
    r = tcp.device_stage_probe(("sum", "calib"), n=2, size=32, iters=1,
                               device="cpu", deadline_s=-1.0)
    assert r["truncated_at"] == "sum" and not r["stages_mpix_s"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcp.device_compute_probe(n=2, size=32, iters=1, stage="sum")


def test_probe_main_prints_json(capsys):
    tcp.main(["--stages", "sum,calib", "--n", "2", "--size", "32",
              "--iters", "1", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r["stages_mpix_s"]) == {"sum", "calib"}


def test_compare_fits_exit_codes(tmp_path, capsys):
    from siril_tpu.tools import compare_fits as jcf
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.tools import compare_fits as tcf

    rng = np.random.default_rng(0)
    a = rng.random((1, 12, 10)).astype(np.float32)
    b = a.copy()
    b[0, 3, 4] += 0.01
    for name, d in (("a", a), ("b", b), ("c", a[:, :8])):
        write_fits(SirilImage(data=d), str(tmp_path / f"{name}.fit"),
                   bitdepth=-32)
    p = {k: str(tmp_path / f"{k}.fit") for k in "abc"}
    cases = [[p["a"], p["a"]], [p["a"], p["b"]], [p["a"], p["b"], "0.02"],
             [p["a"], p["c"]], [p["a"]]]
    for args in cases:
        rt = tcf.main(args)
        t_out = capsys.readouterr().out
        rj = jcf.main(args)
        j_out = capsys.readouterr().out
        assert rt == rj, args
        if len(args) > 1:               # (else each prints its usage)
            assert t_out == j_out, args
    assert [tcf.main(c) for c in cases] == [0, 1, 0, 2, 2]


def test_device_collector_bit_equal():
    """One fetch at the end equals the per-chunk fetches; the normalization
    estimators through it equal the JAX package's on the same frames."""
    from siril_tpu_torch.utils.devfetch import DeviceCollector

    rng = np.random.default_rng(2)
    chunks = [torch.from_numpy(rng.random((k, 4)).astype(np.float32))
              for k in (3, 1, 5)]
    col = DeviceCollector()
    for c in chunks:
        col.append(c * 2.0)
    np.testing.assert_array_equal(
        col.concat(), np.concatenate([(c * 2.0).numpy() for c in chunks]))
    one = DeviceCollector()
    one.append(chunks[0])
    np.testing.assert_array_equal(one.concat(), chunks[0].numpy())
    assert DeviceCollector().concat().shape == (0,)


def test_normalization_through_the_collector(tmp_path):
    """The estimator pass of ``compute_normalization`` (one fetch) gives
    the JAX package's coefficients on the same sequence."""
    from siril_tpu.core.image import SirilImage as JI
    from siril_tpu.core.sequence import Sequence as JSeq
    from siril_tpu.io.fits_io import write_fits
    from siril_tpu.ops import normalization as jn
    from siril_tpu_torch.core.sequence import Sequence as TSeq
    from siril_tpu_torch.ops import normalization as tn

    rng = np.random.default_rng(7)
    for i in range(5):
        d = (0.1 + 0.02 * i + 0.05 * rng.random((1, 24, 20))).astype(
            np.float32)
        write_fits(JI(data=d), str(tmp_path / f"n_{i + 1:05d}.fit"),
                   bitdepth=-32)
    idx = np.arange(5)
    jc = jn.compute_normalization(JSeq.scan("n_", str(tmp_path)), idx,
                                  jn.ADDITIVE_SCALING)
    tc = tn.compute_normalization(TSeq.scan("n_", str(tmp_path)), idx,
                                  tn.ADDITIVE_SCALING, device="cpu")
    for k in ("offset", "scale", "mul"):
        np.testing.assert_allclose(getattr(tc, k), getattr(jc, k),
                                   rtol=1e-5, atol=1e-7)


def _plot(mod):
    p = mod.SirilPlot(title="Light curve", xlabel="JD", ylabel="mag",
                      revertY=True)
    x = np.linspace(2460000.0, 2460000.5, 30)
    y = 12.0 + 0.1 * np.sin(x * 40)
    p.add_xyerrdata("V-C", x[::-1], y[::-1], np.full(30, 0.02))
    p.add_xydata("model", x, 12.0 + 0.1 * np.sin(x * 40), kind="line")
    p.add_xydata("short", x[:5], y[:5], kind="points")
    p.sort_x()
    return p


def test_splot_vs_jax(tmp_path):
    """SirilPlot: the ``.dat`` equal and the PNG pixel-equal to the JAX
    package's; an empty plot too."""
    from PIL import Image

    from siril_tpu.utils import splot as js
    from siril_tpu_torch.utils import splot as ts

    for who, mod in (("jax", js), ("port", ts)):
        p = _plot(mod)
        p.save_png(str(tmp_path / f"{who}.png"))
        p.save_dat(str(tmp_path / f"{who}.dat"))
        mod.SirilPlot(title="empty").save_png(str(tmp_path / f"{who}_e.png"))
    assert (tmp_path / "port.dat").read_text() == \
        (tmp_path / "jax.dat").read_text()
    for name in ("", "_e"):
        a = np.asarray(Image.open(tmp_path / f"port{name}.png"))
        b = np.asarray(Image.open(tmp_path / f"jax{name}.png"))
        assert a.shape == b.shape and np.array_equal(a, b)
        assert (a < 200).any()


def test_light_curve_plot_failure_is_logged(tmp_path, monkeypatch, caplog):
    """Where the plot fails (no PIL, as on the card machine) the light
    curve logs the error and keeps its ``.dat``."""
    import sys

    from siril_tpu_torch.ops import photometry as ph

    monkeypatch.setitem(sys.modules, "PIL", None)
    rows = [(0, "2024-01-01T00:00:00", 0.1, 0.01),
            (1, "2024-01-01T01:00:00", 0.2, 0.01)]
    monkeypatch.setattr(ph, "seq_photometry_stars", lambda *a, **k: [
        [(r[0], dict(phot=_Phot(r[2] + 10), date_obs=r[1])) for r in rows],
        [(r[0], dict(phot=_Phot(10.0), date_obs=r[1])) for r in rows]])
    out = str(tmp_path / "lc.dat")
    caplog.set_level("INFO", logger="siril_tpu_torch")
    got = ph.light_curve(None, (1, 1), [(2, 2)], out_path=out,
                         device="cpu")
    assert len(got) == 2 and os.path.exists(out)
    assert not os.path.exists(str(tmp_path / "lc.png"))
    assert any(r.getMessage().startswith("light curve plot failed")
               for r in caplog.records)
    monkeypatch.delitem(sys.modules, "PIL")
    ph.light_curve(None, (1, 1), [(2, 2)], out_path=out, device="cpu")
    assert os.path.exists(str(tmp_path / "lc.png"))


class _Phot:
    def __init__(self, mag):
        self.valid, self.mag, self.s_mag = True, mag, 0.01


def _have_git():
    try:
        subprocess.run(["git", "--version"], capture_output=True,
                       check=True)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _git_env():
    return dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
                GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")


@pytest.fixture
def fixture_repo(tmp_path):
    if not _have_git():
        pytest.skip("git not available")
    src = tmp_path / "upstream"
    src.mkdir()
    (src / "preprocessing.ssf").write_text("# a script\nrequires 1.2.0\n")
    (src / "tools").mkdir()
    (src / "tools" / "helper.py").write_text("print('hi')\n")
    (src / "README.md").write_text("not a script\n")
    for args in (["init", "-q", "-b", "main"], ["add", "-A"],
                 ["commit", "-qm", "initial scripts"]):
        subprocess.run(["git", *args], cwd=src, check=True, env=_git_env(),
                       capture_output=True)
    return "file://" + str(src)


def test_scriptrepo_vs_jax(fixture_repo, tmp_path, monkeypatch):
    """Clone, list, fetch + reset over local edits, a refused remote, a
    stale lock, and ``reloadscripts`` through both packages, against a
    ``file://`` repository."""
    from siril_tpu.utils import scriptrepo as jr
    from siril_tpu_torch.utils import scriptrepo as tr

    src = fixture_repo[len("file://"):]
    listed = {}
    for who, mod in (("jax", jr), ("port", tr)):
        local = str(tmp_path / f"{who}_local")
        assert mod.sync_repository(fixture_repo, local)
        listed[who] = [os.path.relpath(s, local)
                       for s in mod.list_scripts(local)]
        with open(os.path.join(local, "preprocessing.ssf"), "w") as f:
            f.write("local damage\n")
        open(os.path.join(local, ".git", "index.lock"), "w").close()
    (tmp_path / "upstream" / "new_script.ssf").write_text("stack l sum\n")
    for args in (["add", "-A"], ["commit", "-qm", "add"]):
        subprocess.run(["git", *args], cwd=src, check=True, env=_git_env(),
                       capture_output=True)
    for who, mod in (("jax", jr), ("port", tr)):
        local = str(tmp_path / f"{who}_local")
        assert mod.sync_repository(fixture_repo, local)
        assert "local damage" not in open(
            os.path.join(local, "preprocessing.ssf")).read()
        assert not os.path.exists(os.path.join(local, ".git",
                                               "index.lock"))
        listed[who + "2"] = [os.path.relpath(s, local)
                             for s in mod.list_scripts(local)]
        assert not mod.sync_repository("file:///somewhere/else", local)
    assert listed["port"] == listed["jax"] == [
        "preprocessing.ssf", "tools/helper.py"]
    assert listed["port2"] == listed["jax2"]
    assert "new_script.ssf" in listed["port2"]
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    assert tr.repo_path() == jr.repo_path()
    # reloadscripts: gated by use_scripts_repository
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.cli.parser import process_command_line

    monkeypatch.setenv("SIRIL_TPU_SCRIPT_REPO", fixture_repo)
    monkeypatch.setenv("SIRIL_TPU_SCRIPT_REPO_DIR",
                       str(tmp_path / "cmdrepo"))
    s = Session(cwd=str(tmp_path), device="cpu")
    assert process_command_line(s, "reloadscripts") == 0
    assert not (tmp_path / "cmdrepo").exists()
    assert process_command_line(s, "set use_scripts_repository=1") == 0
    assert process_command_line(s, "reloadscripts") == 0
    assert (tmp_path / "cmdrepo" / "preprocessing.ssf").is_file()
    assert tr.script_search_paths(s.prefs) == jr.script_search_paths(
        s.prefs)


@pytest.mark.parametrize("a,b", [
    ("1.0.0", "1.0.1"), ("1.2.0", "1.1.9"), ("1.2.3", "1.2.3"),
    ("1.4.0-beta1", "1.4.0-rc1"), ("1.4.0-rc1", "1.4.0"),
    ("1.4.0", "1.4.0-rc2"), ("1.2.3-1", "1.2.3-2"), ("siril-1.4.0-rc1",
                                                     "1.4.0-beta2")])
def test_version_compare_vs_jax(a, b):
    from siril_tpu.utils import update as ju
    from siril_tpu_torch.utils import update as tu

    assert vars(tu.parse_version(a)) == vars(ju.parse_version(a))
    assert tu.compare_version(tu.parse_version(a), tu.parse_version(b)) == \
        ju.compare_version(ju.parse_version(a), ju.parse_version(b))


def test_update_check_with_fixture_transport(tmp_path):
    """The update check through the port's FixtureTransport (a recorded
    reply, no network) and the JAX package's with the same bytes."""
    from siril_tpu.utils import update as ju
    from siril_tpu_torch.astrometry.remote import FixtureTransport
    from siril_tpu_torch.utils import update as tu

    doc = json.dumps({"siril": {"stable": "1.4.5", "beta": "1.6.0-beta1"}})
    fx = FixtureTransport(str(tmp_path / "fx"))
    fx.record(tu.SIRIL_VERSIONS_URL, doc)

    class Bytes:
        def get(self, url):
            return doc.encode()

    for cur in ("1.2.0", "1.9.0", "1.4.5"):
        assert tu.check_for_updates(fx, current=cur) == \
            ju.check_for_updates(Bytes(), current=cur)
    assert tu.newest_release(doc.encode(), True) == \
        (lambda r: (r[0], r[1]))(tu.newest_release(doc, True))
    assert tu.newest_release(doc.encode(), True)[0] == "1.6.0-beta1"

    class Down:
        def get(self, url):
            raise OSError("offline")

    assert tu.check_for_updates(Down()) == ju.check_for_updates(Down())
    assert "no fixture" in tu.check_for_updates(
        FixtureTransport(str(tmp_path / "empty")))


def test_trace_stages_and_profiler_trace(tmp_path):
    """``stage`` accumulates bounded totals and reports; a device trace
    (CPU activities here) is written as a Chrome trace that names the
    stages, and ``busy_share`` reads one: kernels, copies and sets within
    the ``cli.command`` spans, or the whole trace where none ran."""
    from siril_tpu_torch.utils import trace

    trace.reset()
    assert trace.report() == "no stage timings recorded"
    assert trace.start_device_trace(str(tmp_path))
    assert not trace.start_device_trace(str(tmp_path))
    with trace.stage("probe.a"):
        torch.ones(64, 64).sum()
    with trace.stage("probe.a"):
        pass
    with trace.stage("probe.b"):
        pass
    path = trace.stop_device_trace()
    assert trace.stop_device_trace() is None
    t = trace.timings()
    assert t["probe.a"][0] == 2 and t["probe.b"][0] == 1
    assert t["probe.a"][2] == t["probe.a"][1] / 2
    assert trace._acc["probe.a"][0] == 2            # a count, not a list
    assert "probe.a" in trace.report()
    doc = json.load(open(path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"probe.a", "probe.b"} <= names
    events = [
        dict(ph="X", cat="cpu_op", name="x", ts=0.0, dur=100.0),
        dict(ph="X", cat="kernel", name="k1", ts=10.0, dur=20.0),
        dict(ph="X", cat="kernel", name="k1", ts=20.0, dur=20.0),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=50.0,
             dur=10.0),
        dict(ph="X", cat="gpu_memset", name="Memset", ts=62.0, dur=3.0),
        dict(ph="X", cat="kernel", name="k2", ts=85.0, dur=10.0)]
    fake = tmp_path / "fake.json"
    fake.write_text(json.dumps({"traceEvents": events}))
    b = trace.busy_share(str(fake))
    assert b["kernels"] == {"k1": 2, "k2": 1}
    # 10-40, 50-60, 62-65, 85-95 of the whole trace, 0-100
    assert abs(b["share"] - 0.53) < 1e-12 and abs(b["window_s"] - 1e-4) < 1e-12
    fake.write_text(json.dumps({"traceEvents": events + [
        dict(ph="X", cat="user_annotation", name="cli.command", ts=5.0,
             dur=85.0)]}))
    b = trace.busy_share(str(fake))
    # within the command's 5-90: 30 + 10 + 3 + 5 of 85
    assert abs(b["share"] - 48 / 85) < 1e-12
    assert abs(b["busy_s"] - 48e-6) < 1e-15
    trace.reset()


def test_trace_env_through_the_cli(tmp_path, monkeypatch):
    """``SIRIL_TPU_TRACE=<dir>``: the CLI's run is traced and the trace
    written when it ends."""
    from siril_tpu_torch import cli

    monkeypatch.setenv("SIRIL_TPU_TRACE", str(tmp_path / "tr"))
    assert cli.main(["-d", str(tmp_path), "--device", "cpu", "pwd"]) == 0
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].startswith("trace_")
