"""Parity: the port's ``.seq`` sidecars (``siril_tpu_torch/io/seqfile.py``),
sequence engine (``core/engine.py``) and FITS conversion
(``io/conversion.py``) against the JAX package, on the CPU.

A ``.seq`` written by either package loads in the other with the same
selection, reference, file numbers, registration data (H as written:
``%g``, six significant digits, in both) and statistics; both write the
same text.  Conversion writes the same frames and sidecar; the engine
writes a frame at its own bit depth unless told otherwise.
"""

import os
import re

import numpy as np
import pytest

from siril_tpu.core.image import USHORT_IMG, SirilImage
from siril_tpu.core.sequence import Sequence as JSeq
from siril_tpu.io import conversion as jconv
from siril_tpu.io import seqfile as jsf
from siril_tpu.io.fits_io import write_fits as jwrite
from siril_tpu.ops.statistics import ImStats
from siril_tpu_torch.cli.context import Session
from siril_tpu_torch.core import engine
from siril_tpu_torch.core.sequence import REG_COLS, STAT_COLS, Sequence
from siril_tpu_torch.io import conversion, seqfile
from siril_tpu_torch.io.fits_io import read_fits

N = 4


def _frames(d, prefix="a_", bitdepth=USHORT_IMG, n=N):
    rng = np.random.default_rng(41)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        img = SirilImage(data=rng.random((1, 12, 16)).astype(np.float32))
        jwrite(img, os.path.join(d, f"{prefix}{i + 1:05d}.fit"),
               bitdepth=bitdepth)


def _fill(seq, rng):
    """Selection, reference, registration data and statistics."""
    seq.incl[1] = False
    seq.reference_image = 2
    reg = seq.reg(0)
    for c in REG_COLS:
        getattr(reg, c)[:] = rng.random(seq.number) * 5
    reg.number_of_stars[:] = rng.integers(10, 90, seq.number)
    reg.H[:] = np.eye(3) + rng.normal(0, 0.01, (seq.number, 3, 3))
    reg.H[:, :2, 2] = rng.normal(0, 5, (seq.number, 2))
    reg.valid[:] = True
    reg.valid[3] = False
    for i in (0, 2):
        st = ImStats()
        for c in STAT_COLS:
            setattr(st, c, float(rng.random()))
        st.total, st.ngoodpix = 192, 190
        seq.set_frame_stats(0, i, st)


def _same(a, b):
    for k in ("name", "number", "beg", "fixed_len", "reference_image",
              "nb_layers", "rx", "ry"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.filenum, b.filenum)
    np.testing.assert_array_equal(a.incl, b.incl)
    assert sorted(a.regparam) == sorted(b.regparam)
    for layer in a.regparam:
        ra, rb = a.reg(layer), b.reg(layer)
        for c in REG_COLS + ("H", "valid"):
            np.testing.assert_array_equal(getattr(ra, c), getattr(rb, c), c)
    assert sorted(a.stats) == sorted(b.stats)
    for layer in a.stats:
        np.testing.assert_array_equal(a.stats[layer], b.stats[layer])
    assert [os.path.basename(f) for f in a._file_list] == \
        [os.path.basename(f) for f in b._file_list]


def test_seq_written_by_jax_loads_in_port(tmp_path):
    _frames(tmp_path)
    js = JSeq.scan("a_", str(tmp_path))
    _fill(js, np.random.default_rng(42))
    js.save()
    jtext = open(js.seqfile_path()).read()
    back = jsf.read_seqfile(js.seqfile_path())
    got = seqfile.read_seqfile(js.seqfile_path())
    _same(got, back)
    assert got.selnum == N - 1 and got.get_reference() == 2
    got.save()                                    # the same text back
    assert open(got.seqfile_path()).read() == jtext


def test_seq_written_by_port_loads_in_jax(tmp_path):
    _frames(tmp_path)
    ts = Sequence.scan("a_", str(tmp_path))
    _fill(ts, np.random.default_rng(43))
    ts.save()
    ttext = open(ts.seqfile_path()).read()
    back = seqfile.read_seqfile(ts.seqfile_path())
    js = jsf.read_seqfile(ts.seqfile_path())
    _same(back, js)
    js.save()
    assert open(js.seqfile_path()).read() == ttext
    # and the CLI reads the sidecar, under the bare name too
    s = Session(cwd=str(tmp_path), device="cpu")
    seq = s.load_sequence("a")
    _same(seq, back)
    assert s.sequence is seq


def test_convert_debayer_vs_jax(tmp_path):
    """``convert -debayer``: 16-bit CFA frames (BAYERPAT, an x offset)
    demosaiced with the default method (RCD) before they are written:
    three 16-bit layers and no pattern, within one 16-bit step of the JAX
    package's frames (RCD agrees to 1e-6, tests/test_torch_demosaic.py);
    a frame without a pattern is written as it is."""
    rng = np.random.default_rng(45)
    src = tmp_path / "src"
    os.makedirs(src)
    for i in range(2):
        img = SirilImage(data=rng.random((1, 12, 16)).astype(np.float32))
        img.keywords.bayer_pattern = "GBRG" if i == 0 else ""
        img.keywords.bayer_xoffset = 1
        jwrite(img, str(src / f"IMG{i}.fit"), bitdepth=USHORT_IMG)
    files = sorted(str(src / f) for f in os.listdir(src))
    jconv.convert_to_sequence(files, "c", str(tmp_path / "jax"),
                              debayer=True)
    conversion.convert_to_sequence(files, "c", str(tmp_path / "port"),
                                   debayer=True, device="cpu")
    for k, layers in ((1, 3), (2, 1)):
        a, b = (read_fits(str(tmp_path / d / f"c_{k:05d}.fit"))
                for d in ("jax", "port"))
        assert a.nchans == b.nchans == layers
        assert a.orig_bitdepth == b.orig_bitdepth == USHORT_IMG
        assert a.keywords.bayer_pattern == b.keywords.bayer_pattern
        np.testing.assert_allclose(b.host(), a.host(), rtol=0,
                                   atol=1.0 / 65535 + 1e-7)
    assert open(tmp_path / "port" / "c_.seq").read() == \
        open(tmp_path / "jax" / "c_.seq").read()


def test_unported_sequence_types_raise(tmp_path):
    """A film that no reader can open raises as in the JAX package (films
    are ported: tests/test_torch_avi.py); a ``.ser`` video opens as a SER
    sequence, as the JAX package opens it."""
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.core.sequence import SEQ_SER

    (tmp_path / "film.avi").write_bytes(b"")
    with pytest.raises((ValueError, RuntimeError)) as want:
        JSession(cwd=str(tmp_path)).load_sequence("film")
    with pytest.raises(type(want.value), match=re.escape(str(want.value))):
        Session(cwd=str(tmp_path), device="cpu").load_sequence("film")
    os.unlink(tmp_path / "film.avi")
    _frames(str(tmp_path / "src"))
    files = sorted(str(tmp_path / "src" / f)
                   for f in os.listdir(tmp_path / "src"))
    jconv.convert_to_sequence(files, "video", str(tmp_path), output="ser")
    for name in ("video_", "video_.ser"):
        seq = Session(cwd=str(tmp_path), device="cpu").load_sequence(name)
        jseq = JSession(cwd=str(tmp_path)).load_sequence(name)
        assert seq.seq_type == jseq.seq_type == SEQ_SER
        assert (seq.number, seq.ry, seq.rx) == (jseq.number, jseq.ry,
                                                jseq.rx) == (N, 12, 16)
        np.testing.assert_array_equal(seq.read_frame(2).host(),
                                      jseq.read_frame(2).host())


@pytest.mark.parametrize("symlink", [False, True])
def test_convert_and_link_vs_jax(tmp_path, symlink):
    src = tmp_path / "src"
    _frames(str(src), prefix="IMG")
    files = sorted(str(src / f) for f in os.listdir(src))
    jseq = jconv.convert_to_sequence(files, "light", str(tmp_path / "jax"),
                                     symlink=symlink, start=3)
    tseq = conversion.convert_to_sequence(files, "light",
                                          str(tmp_path / "port"),
                                          symlink=symlink, start=3)
    assert tseq.name == jseq.name == "light_"
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        a, b = tmp_path / "jax" / n, tmp_path / "port" / n
        assert os.path.islink(a) == os.path.islink(b) == (
            symlink and n.endswith(".fit"))
        assert a.read_bytes() == b.read_bytes()
    for load_any in (conversion.load_any, jconv.load_any):
        with pytest.raises(FileNotFoundError):
            load_any(str(tmp_path / "x.png"))
    jconv.convert_to_sequence(files, "l", str(tmp_path / "jax"), "ser")
    conversion.convert_to_sequence(files, "l", str(tmp_path / "port"), "ser")
    assert (tmp_path / "port" / "l_.ser").read_bytes() == \
        (tmp_path / "jax" / "l_.ser").read_bytes()


@pytest.mark.parametrize("bitdepth", [USHORT_IMG, -32])
def test_engine_keeps_bit_depth(tmp_path, bitdepth):
    """run_sequence writes each frame at its own bit depth, drops the
    frames its hook returns None for, and unselects them."""
    _frames(str(tmp_path), bitdepth=bitdepth)
    seq = Sequence.scan("a_", str(tmp_path))

    def image(ctx, idx, img):
        return None if idx == 1 else img.copy(data=img.host() * 0.5)

    res = engine.run_sequence(engine.SeqArgs(seq=seq, prefix="h_",
                                             image=image))
    assert res.processed == N - 1 and res.failed == [1]
    assert not seq.incl[1]
    assert res.new_seq.name == "h_a_" and res.new_seq.number == N - 1
    assert {"read", "write"} <= set(res.stage_s)
    for k in (0, 2, 3):
        a = read_fits(str(tmp_path / f"a_{k + 1:05d}.fit"))
        b = read_fits(str(tmp_path / f"h_a_{k + 1:05d}.fit"))
        assert b.orig_bitdepth == a.orig_bitdepth
        want = a.host() * 0.5
        if bitdepth == USHORT_IMG:
            want = np.rint(want * 65535) / 65535
        np.testing.assert_allclose(b.host(), want, rtol=0, atol=1e-7)
    res = engine.run_sequence(engine.SeqArgs(seq=seq, prefix="f_",
                                             output_bitdepth=-32))
    assert read_fits(str(tmp_path / "f_a_00001.fit")).orig_bitdepth == -32


def test_stack_takes_registration_from_seq(tmp_path):
    """``stack`` on a sequence the JAX package registered: the port reads
    the shifts and the weighted FWHM from the .seq, as the JAX package
    does, and stacks the same image."""
    import shutil

    from siril_tpu.cli.commands import COMMANDS
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch import cli
    from tests.test_torch_registration import _reg_seqs

    src = tmp_path / "src"
    src.mkdir()
    _reg_seqs(src, np.random.default_rng(44))
    js = JSession(cwd=str(src))
    js.prefs.sf_radius = 6
    COMMANDS["register"].fn(js, ["g_", "-noout", "-transf=shift",
                                 "-nostarlist"])
    reg = jsf.read_seqfile(str(src / "g_.seq")).reg(0)
    assert reg.valid.all() and np.abs(reg.H[:, :2, 2]).max() > 1
    assert len(set(reg.weighted_fwhm)) > 1
    words = ["g_", "rej", "s", "2", "2", "-norm=addscale",
             "-weight_from_wfwhm", "-out=out"]
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    js = JSession(cwd=str(tmp_path / "jax"))
    COMMANDS["stack"].fn(js, words)
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu",
                  "stack", *words])
    np.testing.assert_array_equal(ts.sequence.reg(0).H, reg.H)
    np.testing.assert_array_equal(ts.sequence.reg(0).weighted_fwhm,
                                  reg.weighted_fwhm)
    a = read_fits(str(tmp_path / "jax" / "out.fit")).host()
    b = read_fits(str(tmp_path / "port" / "out.fit")).host()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


@pytest.mark.parametrize("card,what", [("TF", "FITS-cube"), ("TS", "SER"),
                                       ("TA", "film")])
def test_unported_seq_cards_raise(tmp_path, card, what):
    """``TA`` (a film) names a film beside the ``.seq`` and raises when
    there is none (films open: tests/test_torch_avi.py); a ``TS`` / ``TF``
    sidecar the JAX package wrote opens the video or the cube it names,
    and a sidecar with the fz flag the ``.fit.fz`` files, as in the JAX
    package."""
    p = tmp_path / "x.seq"
    if card == "TA":
        p.write_text(f"S 'x' 0 2 2 5 -1 7 0 0 0\n{card}\nL 1\nI 0 1\n"
                     "I 1 1\n")
        with pytest.raises(FileNotFoundError, match=what):
            seqfile.read_seqfile(str(p))
        return
    from siril_tpu.io.fits_io import write_fits as jw

    _frames(str(tmp_path / "src"))
    files = sorted(str(tmp_path / "src" / f)
                   for f in os.listdir(tmp_path / "src"))
    jseq = jconv.convert_to_sequence(
        files, "x", str(tmp_path), output="ser" if card == "TS" else
        "fitseq")
    jseq.incl[0] = False
    jseq.save()
    text = (tmp_path / "x_.seq").read_text()
    assert f"\n{card}\n" in text
    seq = seqfile.read_seqfile(str(tmp_path / "x_.seq"))
    assert seq.seq_type == jseq.seq_type
    np.testing.assert_array_equal(seq.incl, jseq.incl)
    for k in range(N):
        np.testing.assert_array_equal(seq.read_frame(k).host(),
                                      jseq.read_frame(k).host())
    # the fz flag: .fit.fz frames beside the sidecar
    for i in range(2):
        jw(SirilImage(data=np.full((1, 4, 6), 0.25 * (i + 1), np.float32)),
           str(tmp_path / f"z{i:05d}.fit.fz"), bitdepth=USHORT_IMG,
           compression="rice")
    (tmp_path / "z.seq").write_text(
        "S 'z' 0 2 2 5 -1 7 0 1 0\nL 1\nI 0 1\nI 1 1\n")
    z = seqfile.read_seqfile(str(tmp_path / "z.seq"))
    assert z.fz and jsf.read_seqfile(str(tmp_path / "z.seq")).fz
    assert [os.path.basename(f) for f in z._file_list] == \
        ["z00000.fit.fz", "z00001.fit.fz"]
    assert (z.nb_layers, z.ry, z.rx) == (1, 4, 6)
    np.testing.assert_allclose(z.read_frame(1).host(), 0.5, rtol=0,
                               atol=0.5 / 65535)


def test_variable_size_seq_round_trip(tmp_path):
    """A sequence of frames of different sizes: the JAX package's .seq
    (``I filenum incl rx,ry`` lines) reads in the port with each frame's
    size, and the port writes it back line for line; the overlap of two
    frames (the overlap normalization's) comes from their own sizes."""
    from siril_tpu.ops.normalization import compute_overlap as joverlap
    from siril_tpu_torch.ops.normalization import compute_overlap

    rng = np.random.default_rng(44)
    sizes = [(16, 12), (20, 9), (11, 14), (16, 12)]
    for i, (w, h) in enumerate(sizes):
        jwrite(SirilImage(data=rng.random((1, h, w)).astype(np.float32)),
               str(tmp_path / f"v_{i + 1:05d}.fit"), bitdepth=USHORT_IMG)
    js = JSeq.scan("v_", str(tmp_path))
    _fill(js, rng)
    js.reg(0).H[:] = np.eye(3)
    js.reg(0).H[:, :2, 2] = [(0, 0), (5, -3), (-4, 6), (12, 2)]
    js.is_variable = True
    js.imgsize = np.array(sizes, dtype=np.int64)
    js.save()
    jtext = open(js.seqfile_path()).read().splitlines()
    got = seqfile.read_seqfile(js.seqfile_path())
    assert got.is_variable
    np.testing.assert_array_equal(got.imgsize, sizes)
    _same(got, jsf.read_seqfile(js.seqfile_path()))
    got.save()
    assert open(got.seqfile_path()).read().splitlines() == jtext
    assert any(line.startswith("I 2 0 20,9") for line in jtext)
    back = jsf.read_seqfile(js.seqfile_path())
    for i in range(4):
        for j in range(4):
            assert compute_overlap(got, 0, i, j) == joverlap(back, 0, i, j)
    # frame 1 is 20 × 9 px, not the sequence's 16 × 12
    assert compute_overlap(got, 0, 0, 1) == ((5, 0, 11, 6), (0, 3, 11, 6))


def test_engine_hook_error_stops_the_run(tmp_path):
    """An exception from a hook is not taken for a frame's fault: it
    propagates, whatever raised it and whatever its text, and no frame is
    unselected (a hook drops a frame by returning None)."""
    _frames(str(tmp_path))
    seq = Sequence.scan("a_", str(tmp_path))

    def image(ctx, idx, img):
        if idx == 1:
            raise ValueError("a library error that does not name the card")
        return img

    with pytest.raises(ValueError, match="does not name the card"):
        engine.run_sequence(engine.SeqArgs(seq=seq, prefix="h_",
                                           image=image))
    assert seq.incl.all()
