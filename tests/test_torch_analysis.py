"""The port's analysis session, part 1: statistics (``ops/statistics``),
cosmetic detection (``ops/cosmetic``), the fitting helpers, the dates, the
commands over ported modules and the sequence forms, against the JAX
package on the CPU on the same seeded inputs; and the two command tables
held together.

Bounds: the statistics of every option equal to the JAX package's host
numpy (the port's host copy) and within 1e-12 on the device path (its
float64 sums run in another order; the medians are equal); the
histograms equal, values on the bin edges included; the 24-neighbour
median, the masks and the corrections bit-equal, a pixel on the
threshold included; find_hot's list byte-equal; the log lines of
``stat`` (plain, main, -cfa), ``bg``, ``bgnoise`` and ``entropy`` and the
files of ``histo`` and ``seqstat`` equal; the sequence forms within
1e-6 with the same names; the rest within 1e-6 (``cdg``'s centre to
1e-5: numpy sums its weights in float32, pairwise, and the port in
another order).
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import cosmetic as jcos
from siril_tpu.ops import statistics as jst
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import cosmetic as tcos
from siril_tpu_torch.ops import statistics as tst

torch.set_num_threads(1)

CPU = "cpu"

#: the JAX package's commands still to port, by ROADMAP item (§1.7 the
#: surfaces: the session commands; its sequence, header, live-stacking
#: and export commands are ported)
STILL_TO_PORT = {
    7: {"help", "ls", "dir", "pwd", "exit", "log", "capabilities", "get",
        "set", "setmem", "setcpu", "clear", "undo", "redo", "pyscript",
        "reloadscripts", "precompile"},
}


def test_command_tables():
    """Every name of the JAX package's table is ported or listed above
    (17 after the sequence, header, live-stacking and export commands:
    217 of 234 ported); the port has no name of its own."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    todo = set().union(*STILL_TO_PORT.values())
    assert len(todo) == 17
    assert len(TCMD) == 217 and len(JCMD) == 234
    assert not todo & set(TCMD)
    assert set(JCMD) - set(TCMD) == todo
    assert set(TCMD) <= set(JCMD)
    assert TCMD["extract_haoiii_ha"] is TCMD["extract_ha"]
    for alias, name in (("find_cosme_cfa", "find_cosme"),
                        ("cosme_cfa", "cosme"), ("unclipstars", "synthstar"),
                        ("seqtilt", "tilt"), ("seqght", "seqghs"),
                        ("seqcosme", "seqfind_cosme"),
                        ("seqcosme_cfa", "seqfind_cosme"),
                        ("seqfind_cosme_cfa", "seqfind_cosme")):
        assert TCMD[alias] is TCMD[name], alias


def layer(seed=3, h=64, w=80, zeros=True):
    rng = np.random.default_rng(seed)
    x = (0.2 + 0.02 * rng.standard_normal((h, w))).astype(np.float32)
    x[rng.integers(0, h, 25), rng.integers(0, w, 25)] = 0.9
    if zeros:
        x[rng.integers(0, h, 25), rng.integers(0, w, 25)] = 0.0
    return x


OPTIONS = ["SIGMEAN", "BASIC", "MAD", "AVGDEV", "BWMV", "IKSS", "MAIN",
           "EXTRA"]


@pytest.mark.parametrize("opt", OPTIONS)
def test_stats_vs_jax(opt):
    """compute_stats_np of every option equal to the JAX package's, and
    compute_stats_tensor (the device path) within 1e-12 of it, medians
    equal; on a layer with zeros (excluded, and the per-row noise) and
    one without (the dense noise)."""
    o = getattr(jst, "STATS_" + opt)
    assert getattr(tst, "STATS_" + opt) == o
    for x in (layer(3), layer(4, zeros=False)):
        want = jst.compute_stats_np(x, o)
        assert vars(tst.compute_stats_np(x, o)) == vars(want)
        got = tst.compute_stats_tensor(torch.from_numpy(x), o)
        for k, v in vars(want).items():
            tol = 0.0 if k in ("median", "mad", "location", "min", "max",
                               "total", "ngoodpix") else 1e-12
            assert abs(getattr(got, k) - v) <= tol, k


def test_histogram_edges():
    """Values on every bin edge, just below each, 0, 1 and out of range:
    the same counts as np.histogram(…, 256, (0, 1))."""
    e = np.arange(257, dtype=np.float64) / 256
    v = np.concatenate([e, np.nextafter(e.astype(np.float32),
                                        np.float32(-1)),
                        [np.float32(1.0000001), -0.0, np.nan, -0.5, 1.5,
                         np.nextafter(np.float32(1.0), np.float32(0))],
                        layer(5).ravel()]).astype(np.float32)
    want, _ = np.histogram(v, bins=256, range=(0, 1))
    assert np.array_equal(tst.histogram256(torch.from_numpy(v)), want)


def _on_threshold():
    """A layer with one pixel whose deviation from its 24-neighbour
    median (0: a 9 × 9 hole of zeros around it, wide enough for the CFA
    stride) equals its hot threshold in float32: not flagged, the test is
    strict."""
    x = layer(10, 40, 48, zeros=False)
    x[16:25, 20:29] = 0.0
    for _ in range(50):
        st = jst.compute_stats_np(x, jst.STATS_BASIC | jst.STATS_AVGDEV)
        thr = np.float32(3.0 * max(st.avgdev, 1e-7))
        if x[20, 24] == thr:
            break
        x[20, 24] = thr
    assert x[20, 24] == thr
    return x


@pytest.mark.parametrize("cfa", [False, True], ids=["mono", "cfa"])
def test_auto_detect_vs_jax(cfa):
    """find_cosme's detection and correction bit-equal, on a noisy layer
    with hot and cold pixels and on one with a pixel on its threshold."""
    for x in (layer(6), _on_threshold()):
        want = jcos.auto_detect_and_correct(x, sig_hot=3.0, sig_cold=3.0,
                                            is_cfa=cfa)
        got = tcos.auto_detect_and_correct(x, sig_hot=3.0, sig_cold=3.0,
                                           is_cfa=cfa, device=CPU)
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
        assert want[2].sum() + want[1].sum() > 0


def test_cosme_file_vs_jax():
    """Points (every letter taken as hot) bit-equal to the JAX package;
    lines and columns, which the JAX package's read-only array refuses
    (ROADMAP §3), against the mean of their two neighbours in file
    order."""
    x = np.stack([layer(7), layer(8)])
    pts = [("P", 3, 4), ("P", 10, 20), ("P", 0, 0), ("P", 79, 63)]
    want = jcos.apply_cosme_file(JImage(data=x.copy()), pts)
    got = tcos.apply_cosme_file(TImage(data=x.copy()), pts, device=CPU)
    assert np.array_equal(got, np.asarray(want))
    with pytest.raises(ValueError):
        jcos.apply_cosme_file(JImage(data=x.copy()), [("L", 5)])
    ref = np.array(want)
    for y in (5, 0, 6):
        ref[:, y] = 0.5 * (ref[:, max(y - 1, 0)] + ref[:, min(y + 1, 63)])
    for c in (7, 79):
        ref[:, :, c] = 0.5 * (ref[:, :, c - 1] + ref[:, :, min(c + 1, 79)])
    got = tcos.apply_cosme_file(
        TImage(data=x.copy()), pts + [("L", 5), ("L", 0), ("L", 6),
                                      ("C", 7), ("C", 79)], device=CPU)
    assert np.array_equal(got, ref)


class Both:
    """The two packages' sessions in their own directories, a command run
    through both tables, and their log lines."""

    def __init__(self, tmp_path, caplog, src=None):
        from siril_tpu.cli.context import Session as JSession
        from siril_tpu_torch.cli.context import Session as TSession

        self.dirs = {}
        for who in ("jax", "port"):
            d = tmp_path / who
            if src is not None:
                shutil.copytree(src, d)
            else:
                d.mkdir()
            self.dirs[who] = d
        self.j = JSession(cwd=str(self.dirs["jax"]))
        self.t = TSession(cwd=str(self.dirs["port"]), device=CPU)
        self.caplog = caplog

    def run(self, line):
        from siril_tpu.cli.commands import COMMANDS as JCMD
        from siril_tpu.utils.log import get_log_buffer
        from siril_tpu_torch.cli.commands import COMMANDS as TCMD

        words = line.split()
        n0 = len(get_log_buffer())
        rj = JCMD[words[0]].fn(self.j, words[1:])
        jl = get_log_buffer()[n0:]
        self.caplog.clear()
        with self.caplog.at_level(logging.INFO, logger="siril_tpu_torch"):
            rt = TCMD[words[0]].fn(self.t, words[1:])
        tl = [r.getMessage() for r in self.caplog.records]
        return (rj, jl), (rt, tl)

    def load(self, data, name="img", **kw):
        self.j.set_image(JImage(data=data.copy(), **kw), name)
        self.t.set_image(TImage(data=data.copy(), **kw), name)

    def same_image(self, tol=0.0):
        a = np.asarray(self.t.image.data, np.float64)
        b = np.asarray(self.j.image.data, np.float64)
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b))) <= tol

    def same_file(self, name):
        assert (self.dirs["port"] / name).read_bytes() == \
            (self.dirs["jax"] / name).read_bytes(), name


def _rgb(seed=11, size=48):
    rng = np.random.default_rng(seed)
    d = np.clip(0.2 + 0.05 * rng.standard_normal((3, size, size)), 0, 1)
    d[:, 10:14, 20:24] = 0.8
    return d.astype(np.float32)


def test_statistics_commands_vs_jax(tmp_path, caplog):
    b = Both(tmp_path, caplog)
    edges = np.zeros((1, 32, 32), np.float32)
    edges.flat[:257] = np.arange(257) / 256
    for data in (_rgb(), layer(12)[None], edges + layer(13, 32, 32)[None]):
        b.load(data)
        lines = ["stat", "stat main", "bg", "bgnoise", "entropy", "histo 0"]
        if data.shape[0] == 1:
            lines.append("stat -cfa")
        for line in lines:
            (_, jl), (_, tl) = b.run(line)
            assert tl == jl, line
        b.same_file("histo_0.dat")


def _sequence(d, n=4, h=40, w=48, nch=1, bits=-32, seed=31):
    from siril_tpu_torch.io.fits_io import write_fits

    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        f = 0.2 + 0.05 * rng.standard_normal((nch, h, w))
        f[:, 8:12, 10:14] += 0.5
        f[:, rng.integers(0, h, 6), rng.integers(0, w, 6)] = 0.95
        write_fits(TImage(data=np.clip(f, 0, 1).astype(np.float32)),
                   str(d / f"light_{i:05d}.fit"), bitdepth=bits)


def test_seqstat_vs_jax(tmp_path, caplog):
    src = tmp_path / "src"
    src.mkdir()
    _sequence(src, nch=3)
    b = Both(tmp_path, caplog, src)
    (_, jl), (_, tl) = b.run("seqstat light_ stats.csv main")
    assert tl == jl
    b.same_file("stats.csv")


def test_find_hot_and_cosme_vs_jax(tmp_path, caplog):
    """find_hot's list byte-equal; find_cosme (and its CFA alias, which
    corrects as a CFA only on a BAYERPAT image) and cosme with the list
    bit-equal."""
    b = Both(tmp_path, caplog)
    dark = layer(14, 48, 56)
    b.load(dark[None])
    b.run("find_hot hot 3 3")
    b.same_file("hot.lst")
    for line in ("cosme hot", "cosme_cfa hot.lst"):
        b.load(dark[None])
        (_, jl), (_, tl) = b.run(line)
        assert tl == jl
        b.same_image()
    for line in ("find_cosme 3 3", "find_cosme_cfa 2 4"):
        b.load(layer(15)[None])
        (_, jl), (_, tl) = b.run(line)
        assert tl == jl
        b.same_image()
    from siril_tpu_torch.core.image import Keywords as TK
    from siril_tpu.core.image import Keywords as JK

    b.j.set_image(JImage(data=layer(16)[None].copy(),
                         keywords=JK(bayer_pattern="RGGB")), "cfa")
    b.t.set_image(TImage(data=layer(16)[None].copy(),
                         keywords=TK(bayer_pattern="RGGB")), "cfa")
    b.run("find_cosme_cfa 3 3")
    b.same_image()


@pytest.mark.parametrize("line,tol", [
    ("cdg", None), ("limit -clip", 0.0), ("limit -posrescale", 0.0),
    ("limit -rescale", 0.0), ("new 30 20 3", 0.0), ("grey_flat", 0.0),
    ("atrous 3", 1e-6), ("atrous 3 1 -hard -k=0.01", 1e-6),
    ("atrous 2 -anscombe -threshold", 1e-6), ("extract 3", 1e-6),
    ("visu 0 1", 0.0)])
def test_misc_commands_vs_jax(tmp_path, caplog, line, tol):
    b = Both(tmp_path, caplog)
    d = layer(17, 40, 40)[None] * 1.3 - 0.1
    if line.startswith("limit"):
        b.load(d)
    elif line == "grey_flat":
        b.load(layer(18)[None])
    elif line.startswith(("cdg", "atrous", "extract")):
        b.load(np.clip(d, 0, 1) if line != "cdg" else _rgb())
    else:
        b.load(_rgb())
    (rj, jl), (rt, tl) = b.run(line)
    if line == "cdg":
        assert abs(rt[0] - rj[0]) <= 1e-5 and abs(rt[1] - rj[1]) <= 1e-5
        assert tl == jl
        return
    b.same_image(tol)
    if line == "extract 3":
        from siril_tpu_torch.io.fits_io import read_fits

        for i in range(2):
            name = f"layer_{i:02d}.fit"
            a = read_fits(str(b.dirs["port"] / name)).data
            w = read_fits(str(b.dirs["jax"] / name)).data
            assert float(np.abs(a - w).max()) <= tol


def test_set16bits_save(tmp_path, caplog):
    """set16bits makes save write 16 bits, set32bits the image's own
    depth, in both packages."""
    from siril_tpu_torch.io.fits_io import scan_hdus

    b = Both(tmp_path, caplog)
    b.load(_rgb(19))
    for line, bitpix in (("set16bits", 16), ("set32bits", -32)):
        b.run(line)
        b.run(f"save out{bitpix}")
        for who in ("jax", "port"):
            assert scan_hdus(str(b.dirs[who] / f"out{bitpix}.fit"))[0] \
                .bitpix == bitpix


def test_fitting_vs_jax():
    """The port of tests/test_misc_ops.py::test_siegel_and_poly_fit, and
    each function against the JAX package's."""
    from siril_tpu.ops import fitting as jf
    from siril_tpu_torch.ops import fitting as tf

    rng = np.random.default_rng(0)
    x = np.linspace(0, 10, 50)
    y = 2.0 * x + 1.0 + rng.normal(0, 0.1, 50)
    y[::7] += 20.0
    s, i = tf.siegel_fit(x, y)
    assert abs(s - 2.0) < 0.1 and abs(i - 1.0) < 0.5
    c = tf.robust_poly_fit(x, y, 1)
    assert abs(c[1] - 2.0) < 0.05 and abs(c[0] - 1.0) < 0.3
    assert np.allclose(tf.poly_fit(x, 3 * x ** 2 + 1, 2), [1, 0, 3],
                       atol=1e-8)
    assert tf.siegel_fit(x, y) == jf.siegel_fit(x, y)
    assert np.array_equal(tf.robust_poly_fit(x, y, 2),
                          jf.robust_poly_fit(x, y, 2))
    img = rng.random((20, 20)).astype(np.float32)
    assert tf.find_linear_coeff(img, 0.5 * img + 0.1) == \
        jf.find_linear_coeff(img, 0.5 * img + 0.1)


def test_julian_date_roundtrip():
    """The port of tests/test_astro_extras.py::test_julian_date_roundtrip,
    and the JAX package's dates."""
    from siril_tpu.utils import dates as jd
    from siril_tpu_torch.utils import dates as td

    j = td.date_obs_to_julian("2000-01-01T12:00:00")
    assert abs(j - 2451545.0) < 1e-9
    dt = td.julian_to_datetime(j)
    assert td.format_date_obs(dt).startswith("2000-01-01T12:00:00")
    for s in ("2026-03-14T22:10:00.123", "2024-02-29", "2023-07-01 01:02:03",
              "'2025-12-31T23:59:59'", "", "bad"):
        assert td.date_obs_to_julian(s) == jd.date_obs_to_julian(s)


SEQ_FORMS = [
    ("seqmtf light_ 0.05 0.3 0.95", "mtf_"),
    ("seqsubsky light_ 1 -samples=8", "bkg_"),
    ("seqcrop light_ 4 6 30 20", "cropped_"),
    ("seqresample light_ 0.5", "scaled_"),
    ("seqghs light_ -D=2 -B=1", "ghs_"),
    ("seqccm light_ 0.9 0.1 0 0 1 0 0.1 0 0.9 1.1", "ccm_"),
    ("seqinvght light_ -D=1.5", "invght_"),
    ("seqmodasinh light_ -D=2 -human", "modasinh_"),
    ("seqinvmodasinh light_ 1.5 0 0 0 1 -prefix=ima_", "ima_"),
    ("seqlinstretch light_ -BP=0.05", "linstretch_"),
]


@pytest.mark.parametrize("line,prefix", SEQ_FORMS,
                         ids=[f[0].split()[0] for f in SEQ_FORMS])
def test_sequence_forms_vs_jax(tmp_path, caplog, line, prefix):
    """Each form on a 3-frame RGB float32 sequence of 40 × 48: every
    output frame within 1e-6 of the JAX package's, the same names."""
    from siril_tpu_torch.io.fits_io import read_fits

    src = tmp_path / "src"
    src.mkdir()
    _sequence(src, n=3, nch=3)
    b = Both(tmp_path, caplog, src)
    b.run(line)
    names = sorted(f for f in os.listdir(b.dirs["jax"])
                   if f.startswith(prefix) and f.endswith(".fit"))
    assert len(names) == 3
    assert sorted(f for f in os.listdir(b.dirs["port"])
                  if f.startswith(prefix) and f.endswith(".fit")) == names
    for n in names:
        a = read_fits(str(b.dirs["port"] / n)).data
        w = read_fits(str(b.dirs["jax"] / n)).data
        assert a.shape == w.shape
        assert float(np.abs(a.astype(np.float64) - w).max()) <= 1e-6, n


def test_seqfind_cosme_vs_jax(tmp_path, caplog):
    """seqfind_cosme (and an alias) on a 16-bit mono sequence: frames
    bit-equal, the same names."""
    from siril_tpu_torch.io.fits_io import read_fits

    src = tmp_path / "src"
    src.mkdir()
    _sequence(src, n=3, bits=16)
    b = Both(tmp_path, caplog, src)
    b.run("seqfind_cosme light_ 3 3")
    b.run("seqcosme_cfa light_ 3 3 -prefix=c2_")
    for prefix in ("cc_", "c2_"):
        for i in range(1, 4):
            n = f"{prefix}light_{i:05d}.fit"
            assert np.array_equal(read_fits(str(b.dirs["port"] / n)).data,
                                  read_fits(str(b.dirs["jax"] / n)).data)
