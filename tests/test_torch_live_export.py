"""Live stacking, sequence export and the sequence / header commands of the
port against the JAX package on the CPU.

- ``LiveStacker.process_frame``: the shift route, the star route, with
  calibration masters, and a CFA frame debayered — the running mean
  within 1e-6 of the JAX package's;
- the watcher end to end, with a short poll: frames dropped into the
  directory are stacked, ``stop`` writes the result;
- ``seqexport`` to every format with shifts, ``-normalize`` and
  ``-crop``: FITS and FITS cube files byte-equal, SER and AVI bytes
  equal, TIFF samples equal (the JAX package writes through PIL); MP4 and
  WebM through OpenCV by frame count and size, and a clear error without
  OpenCV; a sequence with more than shifts refused with the same message;
- the 24 commands through both command tables, each package in its own
  copy of one directory.
"""

import json
import logging
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = "cpu"
SIZE = 160


def star_frame(seed, dx=0.0, dy=0.0, size=SIZE, n=60, sky=0.1,
               noise=0.004):
    """A sky with ``n`` Gaussian stars moved by (dx, dy) and noise."""
    rng = np.random.default_rng(1000)
    sx = rng.uniform(12, size - 12, n)
    sy = rng.uniform(12, size - 12, n)
    amp = rng.uniform(0.05, 0.5, n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), sky, np.float32)
    for x, y, a in zip(sx + dx, sy + dy, amp):
        img += (a * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 3.0)
                ).astype(np.float32)
    img += np.random.default_rng(seed).normal(0, noise, img.shape
                                              ).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


SHIFTS = [(0.0, 0.0), (2.3, -1.6), (-3.1, 0.8), (1.2, 2.7)]


def _images(pkg, datas, bayer=""):
    if pkg == "jax":
        from siril_tpu.core.image import SirilImage
    else:
        from siril_tpu_torch.core.image import SirilImage
    out = []
    for d in datas:
        img = SirilImage(data=d[None].copy())
        img.keywords.bayer_pattern = bayer
        out.append(img)
    return out


def _stack_both(datas, cfg_kw, masters=None, bayer=""):
    from siril_tpu.livestacking.livestack import (
        LiveStackConfig as JCfg,
        LiveStacker as JLS,
    )
    from siril_tpu_torch.livestacking.livestack import (
        LiveStackConfig as TCfg,
        LiveStacker as TLS,
    )

    out = {}
    for pkg, Cfg, LS in (("jax", JCfg, JLS), ("torch", TCfg, TLS)):
        kw = dict(cfg_kw)
        if masters:
            for k, v in masters.items():
                kw[k] = _images(pkg, [v])[0]
        cfg = Cfg(**kw)
        import tempfile

        d = tempfile.mkdtemp(prefix="ls_")
        ls = JLS(d, cfg) if pkg == "jax" else TLS(d, cfg, device=CPU)
        for i, img in enumerate(_images(pkg, datas, bayer)):
            ls.process_frame(img, f"f{i}")
        out[pkg] = (ls.result(), ls.count, ls.failed)
        shutil.rmtree(d, ignore_errors=True)
    return out


@pytest.fixture
def jax_star_list(monkeypatch):
    """Both packages' star finders return the JAX package's star list of
    the layer they are given (the float32 PSF fits of the two packages
    part by ~1e-6 px, which the lanczos4 warp carries into the stack)."""
    import siril_tpu.registration.starfinder as jsf
    import siril_tpu_torch.registration.starfinder as tsf

    orig = jsf.detect_stars
    monkeypatch.setattr(jsf, "detect_stars",
                        lambda lay, *a, **k: orig(np.asarray(lay)))
    monkeypatch.setattr(tsf, "detect_stars",
                        lambda lay, *a, **k: orig(lay.cpu().numpy()))


@pytest.mark.parametrize("route", ["shift", "stars", "none"])
def test_livestack_routes_vs_jax(route, jax_star_list):
    datas = [star_frame(i, *s) for i, s in enumerate(SHIFTS)]
    cfg = dict(shift_only=route == "shift",
               use_registration=route != "none")
    out = _stack_both(datas, cfg)
    (j, jn, jf), (t, tn, tf) = out["jax"], out["torch"]
    assert (tn, tf) == (jn, jf) == (len(datas), 0)
    assert t.keywords.stackcnt == j.keywords.stackcnt
    assert t.history == j.history
    np.testing.assert_allclose(t.data, j.data, rtol=0, atol=1e-6)


def test_livestack_calibrated_vs_jax():
    rng = np.random.default_rng(3)
    dark = np.full((SIZE, SIZE), 0.01, np.float32)
    dark[rng.integers(0, SIZE, 20), rng.integers(0, SIZE, 20)] = 0.3
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    flat = (0.5 - 0.1 * ((xx - 80) ** 2 + (yy - 80) ** 2) / 12800.0
            ).astype(np.float32)
    datas = [star_frame(i, *s) * (flat / flat.mean()) + dark
             for i, s in enumerate(SHIFTS)]
    out = _stack_both(datas, dict(calibrate=True),
                      masters=dict(dark=dark, flat=flat))
    (j, jn, _), (t, tn, _) = out["jax"], out["torch"]
    assert tn == jn == 4
    np.testing.assert_allclose(t.data, j.data, rtol=0, atol=1e-6)


def test_livestack_cfa_debayer_vs_jax():
    """RGGB frames debayered (RCD) then aligned on the green layer."""
    datas = [star_frame(i, 2 * round(s[0]), 2 * round(s[1]))
             for i, s in enumerate(SHIFTS[:3])]
    out = _stack_both(datas, dict(debayer=True), bayer="RGGB")
    (j, jn, _), (t, tn, _) = out["jax"], out["torch"]
    assert t.data.shape == j.data.shape == (3, SIZE, SIZE)
    assert tn == jn == 3
    np.testing.assert_allclose(t.data, j.data, rtol=0, atol=1e-6)


def _write(path, data, **kw):
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import write_fits

    img = SirilImage(data=data[None] if data.ndim == 2 else data)
    for k, v in kw.items():
        setattr(img.keywords, k, v)
    tmp = path + ".part"
    write_fits(img, tmp, bitdepth=-32)
    os.replace(tmp, path)


def test_livestack_watcher_end_to_end(tmp_path):
    """start_ls with a short poll: files dropped by another thread are
    stacked by the worker; stop_ls writes the mean."""
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.io.fits_io import read_fits

    _write(str(tmp_path / "old.fit"), star_frame(99))
    ctx = Session(cwd=str(tmp_path), device=CPU)
    COMMANDS["start_ls"].fn(ctx, [])
    ls = ctx.livestacker
    ls.cfg.poll_s = 0.02
    datas = [star_frame(i, *s) for i, s in enumerate(SHIFTS)]

    def drop():
        for i, d in enumerate(datas):
            _write(str(tmp_path / f"live_{i:03d}.fit"), d)
            time.sleep(0.05)

    t = threading.Thread(target=drop)
    t.start()
    t.join(timeout=30)
    deadline = time.monotonic() + 60
    while ls.count + ls.failed < len(datas) and time.monotonic() < deadline:
        time.sleep(0.02)
    COMMANDS["stop_ls"].fn(ctx, [])
    assert ctx.livestacker is None
    assert (ls.count, ls.failed) == (len(datas), 0)
    assert len(ls.frame_ms) == len(datas)
    res = read_fits(str(tmp_path / "live_stack_result.fit"))
    assert res.keywords.stackcnt == len(datas)
    np.testing.assert_allclose(res.data, ls.result().data, atol=0)
    # the reference frame's stars stay where they were
    ref = datas[0]
    inner = np.s_[20:-20, 20:-20]
    assert float(np.abs(res.data[0][inner] - ref[inner]).mean()) < 0.01
    with pytest.raises(Exception, match="not started"):
        COMMANDS["livestack"].fn(ctx, [])


# ---------------------------------------------------------------------------
# seqexport
# ---------------------------------------------------------------------------


@pytest.fixture
def seqdir(tmp_path):
    """5 frames of a shifted star field with gains and offsets, and a
    .seq with shift-only registration (whole and half pixels)."""
    from siril_tpu.core.sequence import Sequence as JSeq

    src = tmp_path / "src"
    src.mkdir()
    shifts = [(0, 0), (3, -2), (-2.4, 1.6), (1.5, 4), (-4, -3)]
    for i, (dx, dy) in enumerate(shifts):
        d = star_frame(i, dx, dy, size=96, n=25) * (1 + 0.05 * i) \
            + 0.01 * i
        d[5:8, 5:8] = 0.0
        _write(str(src / f"frm_{i + 1:05d}.fit"), d.astype(np.float32),
               exposure=30.0, object="M42")
    seq = JSeq.scan("frm_", str(src))
    reg = seq.reg(0)
    for i, (dx, dy) in enumerate(shifts):
        reg.H[i] = np.eye(3)
        reg.H[i, :2, 2] = (-dx, -dy)
    reg.valid[:] = True
    seq.reference_image = 1
    seq.save()
    return tmp_path, src


def _copies(tmp_path, src):
    out = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        shutil.copytree(src, d)
        out[who] = d
    return out


def _run(pkg, d, line):
    if pkg == "jax":
        from siril_tpu.cli.commands import COMMANDS
        from siril_tpu.cli.context import Session

        ctx = Session(cwd=str(d))
    else:
        from siril_tpu_torch.cli.commands import COMMANDS
        from siril_tpu_torch.cli.context import Session

        ctx = Session(cwd=str(d), device=CPU)
    words = line.split()
    COMMANDS[words[0]].fn(ctx, words[1:])
    return ctx


EXPORTS = [("fits", ""), ("fits", "-normalize -crop=10,6,64,70"),
           ("fits", "-32b -normalize"), ("fitseq", "-normalize"),
           ("fitseq", "-32b -crop=4,4,50,60"), ("ser", "-normalize"),
           ("ser", "-crop=0,0,80,90"), ("tiff", "-normalize"),
           ("avi", "-normalize -crop=2,2,81,61"),
           ("avi", "-resize=60x50")]


def _decode(path):
    """The frames of an exported file as [0, 1] float arrays, through the
    port's readers (PIL for the JAX package's TIFF)."""
    from siril_tpu_torch.io.avi import AviReader
    from siril_tpu_torch.io.fits_io import image_hdus, read_fits
    from siril_tpu_torch.io.ser import SerFile

    p = str(path)
    if p.endswith(".fit"):
        return [read_fits(p, i).data for i in range(len(image_hdus(p)))]
    if p.endswith(".ser"):
        f = SerFile(p)
        return [f.read_frame(i).data for i in range(f.frame_count)]
    if p.endswith(".avi"):
        r = AviReader(p)
        return [r.read_frame(i).data for i in range(r.nframes)]
    from PIL import Image

    return [np.asarray(Image.open(p)).astype(np.float64)[None] / 65535.0]


@pytest.mark.parametrize("fmt,flags", EXPORTS)
def test_seqexport_vs_jax(seqdir, fmt, flags):
    """The same files; byte-equal where nothing depends on the estimators
    (TIFF: the same samples), and with ``-normalize`` the frames within
    one step of their format (the stack's estimators part by float
    rounding, ops/normalization)."""
    tmp_path, src = seqdir
    dirs = _copies(tmp_path, src)
    line = f"seqexport frm_ out -format={fmt} {flags}".strip()
    for who, d in dirs.items():
        _run(who, d, line)
    jfiles = sorted(f for f in os.listdir(dirs["jax"])
                    if f.startswith("out"))
    tfiles = sorted(f for f in os.listdir(dirs["port"])
                    if f.startswith("out"))
    assert jfiles == tfiles and jfiles
    step = 2e-6 if "-32b" in flags else \
        1 / 255 + 1e-6 if fmt == "avi" else 1 / 65535 + 1e-6
    for f in jfiles:
        got, want = _decode(dirs["port"] / f), _decode(dirs["jax"] / f)
        assert len(got) == len(want), f
        for a, b in zip(got, want):
            assert a.shape == b.shape, f
            if "-normalize" in flags:
                assert float(np.abs(a - b).max()) <= step, f
            else:
                assert np.array_equal(a, b), f
        if "-normalize" not in flags and fmt != "tiff":
            assert (dirs["port"] / f).read_bytes() == \
                (dirs["jax"] / f).read_bytes(), f


@pytest.mark.parametrize("fmt", ["mp4", "webm"])
def test_seqexport_video_cv2(seqdir, fmt):
    cv2 = pytest.importorskip("cv2")
    tmp_path, src = seqdir
    dirs = _copies(tmp_path, src)
    line = f"seqexport frm_ out -format={fmt} -crop=1,1,81,61"
    for who, d in dirs.items():
        _run(who, d, line)
    name = f"out.{fmt}"
    shapes = []
    for d in dirs.values():
        cap = cv2.VideoCapture(str(d / name))
        n = 0
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            n += 1
            shapes.append(fr.shape)
        cap.release()
        assert n == 5
    assert set(shapes) == {(60, 80, 3)}


def test_seqexport_mp4_without_cv2(seqdir, monkeypatch):
    tmp_path, src = seqdir
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        _run("port", src, "seqexport frm_ out -format=mp4")
    assert not any(f.startswith("out") for f in os.listdir(src))


def test_seqexport_refuses_more_than_shifts(seqdir):
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.seqfile import read_seqfile

    tmp_path, src = seqdir
    seq = read_seqfile(str(src / "frm_.seq"))
    seq.reg(0).H[2, 0, 1] = 0.01
    seq.save()
    dirs = _copies(tmp_path, src)
    msgs = []
    for who, d in dirs.items():
        with pytest.raises(ValueError) as e:
            _run(who, d, "seqexport frm_ out")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "more than simple shifts" in msgs[0]
    assert isinstance(seq, Sequence)


def test_export_on_the_device_default(seqdir, monkeypatch):
    """Without ``device`` the export runs on CUDA, and raises without a
    card."""
    from siril_tpu_torch.io.seqfile import read_seqfile
    from siril_tpu_torch.io.sequence_export import ExportArgs, export_sequence

    _, src = seqdir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_sequence(read_seqfile(str(src / "frm_.seq")), ExportArgs(),
                        str(src))


# ---------------------------------------------------------------------------
# the sequence and header commands through both tables
# ---------------------------------------------------------------------------


SCRIPTS = {
    "select": ["select frm_ 1 2", "unselect frm_ 0 1", "select frm_ 4 4",
               "getref frm_", "setref frm_ 3", "getref frm_"],
    "seqclean": ["seqclean frm_ -sel", "seqclean frm_ -reg",
                 "seqclean frm_"],
    "headers": ["sequpdate_key frm_ OBSERVER someone",
                "sequpdate_key frm_ GPSLAT 48.5",
                "seqheader frm_ OBSERVER EXPTIME OBJECT GPSLAT",
                "load_seq frm_", "sequpdate_key frm_ GPSLAT",
                "seqheader frm_ GPSLAT OBSERVER"],
    "merge": ["merge frm_ frm_ both_", "load_seq both_"],
    "stackall": ["stackall rej s 3 3 -norm=addscale"],
    "single": ["calibrate_single frm_00002.fit -dark=frm_00001",
               "mirrorx_single frm_00003", "jsonmetadata frm_00003.fit",
               "jsonmetadata frm_00002.fit -nostats -out=meta.json"],
}


def _both_lines(dirs, lines, caplog):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.utils.log import get_log_buffer
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    j = JSession(cwd=str(dirs["jax"]))
    t = TSession(cwd=str(dirs["port"]), device=CPU)
    logs = []
    for line in lines:
        words = line.split()
        n0 = len(get_log_buffer())
        JCMD[words[0]].fn(j, words[1:])
        jl = get_log_buffer()[n0:]
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="siril_tpu_torch"):
            TCMD[words[0]].fn(t, words[1:])
        tl = [r.getMessage() for r in caplog.records
              if r.name.startswith("siril_tpu_torch.cli")]
        logs.append((line, jl, tl))
    return j, t, logs


def _seqfile(d, name):
    from siril_tpu_torch.io.seqfile import read_seqfile

    return read_seqfile(str(d / f"{name}.seq"))


#: commands whose log lines are compared (the others log from deeper
#: modules of each package)
LOGGED = ("seqheader", "getref", "load_seq", "sequpdate_key",
          "jsonmetadata")


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_sequence_commands_vs_jax(seqdir, caplog, script):
    from siril_tpu_torch.io.fits_io import read_fits

    tmp_path, src = seqdir
    dirs = _copies(tmp_path, src)
    j, t, logs = _both_lines(dirs, SCRIPTS[script], caplog)
    for line, jl, tl in logs:
        if line.startswith("jsonmetadata") and "-nostats" not in line:
            a, b = json.loads(tl[-1]), json.loads(jl[-1])
            assert a.keys() == b.keys()
            for sa, sb in zip(a["statistics"], b["statistics"]):
                for k in sb:
                    assert sa[k] == pytest.approx(sb[k], abs=1e-9), k
        elif line.startswith(LOGGED):
            assert tl == jl, line
    names = {f for f in os.listdir(dirs["jax"])}
    assert names == {f for f in os.listdir(dirs["port"])}
    for f in sorted(names):
        pj, pt = dirs["jax"] / f, dirs["port"] / f
        if f.endswith(".seq"):
            a, b = _seqfile(dirs["port"], f[:-4]), _seqfile(dirs["jax"],
                                                          f[:-4])
            assert np.array_equal(a.incl, b.incl), f
            assert a.reference_image == b.reference_image, f
            assert sorted(a.regparam) == sorted(b.regparam), f
            assert a.number == b.number, f
        elif f.endswith(".fit"):
            a, b = read_fits(str(pt)), read_fits(str(pj))
            assert a.data.shape == b.data.shape, f
            np.testing.assert_allclose(a.data, b.data, rtol=0,
                                       atol=2e-6, err_msg=f)
            assert a.keywords.extra == b.keywords.extra, f
        elif f.endswith(".json"):
            assert json.loads(pt.read_text()) == json.loads(pj.read_text())


def test_image_commands_vs_jax(seqdir, caplog):
    """dumpheader, update_key, parse, boxselect, gps on a loaded image."""
    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu_torch.io.fits_io import read_fits as tread

    tmp_path, src = seqdir
    dirs = _copies(tmp_path, src)
    lines = ["dumpheader", "update_key OBSERVER someone",
             "update_key GPSLAT 48.5", "update_key -comment a note",
             "gps", "update_key GPSLAT", "gps",
             "parse out_$OBJECT$_$EXPTIME:%d$s", "boxselect 1 2 30 40",
             "boxselect", "boxselect -clear", "boxselect"]
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu.utils.log import get_log_buffer
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    j = JSession(cwd=str(dirs["jax"]))
    t = TSession(cwd=str(dirs["port"]), device=CPU)
    j.set_image(jread(str(dirs["jax"] / "frm_00001.fit")), "frm_00001")
    t.set_image(tread(str(dirs["port"] / "frm_00001.fit")), "frm_00001")
    for line in lines:
        words = line.split()
        n0 = len(get_log_buffer())
        JCMD[words[0]].fn(j, words[1:])
        jl = get_log_buffer()[n0:]
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="siril_tpu_torch"):
            TCMD[words[0]].fn(t, words[1:])
        assert [r.getMessage() for r in caplog.records] == jl, line
    assert t.image.keywords.extra == j.image.keywords.extra
    assert t.image.history == j.image.history
    assert t.selection == j.selection


def test_seqstarnet_raises():
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.context import CommandError, Session

    with pytest.raises(CommandError, match="StarNet"):
        COMMANDS["seqstarnet"].fn(Session(device=CPU), ["x"])


def test_seqgps_departure(seqdir, caplog):
    """The JAX package's ``seqgps`` reads ``.keywords`` of the Keywords
    that ``read_frame_metadata`` returns and raises AttributeError on any
    sequence (commands2.py:816-823; ROADMAP §3); the port counts the
    frames with GPS keywords."""
    tmp_path, src = seqdir
    dirs = _copies(tmp_path, src)
    with pytest.raises(AttributeError):
        _run("jax", dirs["jax"], "seqgps frm_")
    _run("port", dirs["port"], "sequpdate_key frm_ GPSLAT 48.5")
    _run("port", dirs["port"], "unselect frm_ 0 0")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="siril_tpu_torch"):
        _run("port", dirs["port"], "seqgps frm_")
    assert caplog.records[-1].getMessage() == "seqgps: GPS data in 5/5 frames"
