"""The port's SER videos and FITS-cube sequences against the JAX package on
the CPU (``siril_tpu_torch/io/ser.py``, ``io/fits_io.FitseqWriter``,
``core/sequence.py``'s SER and FITSEQ sequences, ``io/seqfile.py``'s
``TS`` / ``TF`` cards, ``io/conversion.py``'s ``-ser`` / ``-fitseq``).

Tolerances, each with its reason:
- files written by both packages byte-equal, frames read equal: the same
  numpy conversions;
- the stack of a FITS-cube sequence bit-equal to the stack of the same
  frames as files (the same raw u16 values on the resident path);
- the stacks of a SER and of a cube sequence within 2e-6 of the JAX
  package's (its estimators by bisection or interpolation against the
  port's sort, within one float32 ulp; tests/test_torch_stacking.py).
"""

import dataclasses
import os

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.core.sequence import Sequence as JSequence
from siril_tpu.io import conversion as jconv
from siril_tpu.io import fits_io as jfio
from siril_tpu.io import ser as jser
from siril_tpu.io import seqfile as jsf
from siril_tpu_torch import cli
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import (
    SEQ_FITSEQ,
    SEQ_REGULAR,
    SEQ_SER,
    Sequence,
)
from siril_tpu_torch.io import conversion, seqfile
from siril_tpu_torch.io import fits_io as tfio
from siril_tpu_torch.io import ser as tser


def _frames(rng, n, c, h, w):
    return [rng.random((c, h, w)).astype(np.float32) for _ in range(n)]


def _write_both(tmp_path, frames, color_id, bit_depth, stamps=None,
                **meta):
    """The same frames through both packages' SerWriter; returns the two
    paths."""
    h, w = frames[0].shape[1:]
    out = []
    for mod, Img, name in ((jser, JImage, "j.ser"),
                           (tser, SirilImage, "t.ser")):
        p = str(tmp_path / name)
        wr = mod.SerWriter(p, w, h, color_id, bit_depth, **meta)
        for k, f in enumerate(frames):
            wr.write_frame(Img(data=f), None if stamps is None
                           else stamps[k])
        wr.close()
        out.append(p)
    assert open(out[0], "rb").read() == open(out[1], "rb").read()
    return out


def _read_equal(path, n):
    a, b = jser.SerFile(path), tser.SerFile(path)
    assert (b.frame_count, b.width, b.height, b.nchans) == \
        (a.frame_count, a.width, a.height, a.nchans)
    assert dataclasses.asdict(b.header) == dataclasses.asdict(a.header)
    for i in range(n):
        x, y = a.read_frame(i), b.read_frame(i)
        np.testing.assert_array_equal(y.host(), x.host())
        assert y.orig_bitdepth == x.orig_bitdepth
        for attr in ("bayer_pattern", "date_obs", "instrume", "telescop",
                     "observer", "row_order"):
            assert getattr(y.keywords, attr) == getattr(x.keywords, attr)
    return b


@pytest.mark.parametrize("case", ["mono16", "rgb", "bgr", "bayer", "8bit"])
def test_ser_round_trip_vs_jax(tmp_path, rng, case):
    """The cases of tests/test_ser.py: mono 16-bit, RGB, BGR, a Bayer
    header and 8-bit frames."""
    color, depth, c = {"mono16": (tser.SER_MONO, 16, 1),
                       "rgb": (tser.SER_RGB, 16, 3),
                       "bgr": (tser.SER_BGR, 16, 3),
                       "bayer": (tser.SER_BAYER_RGGB, 16, 1),
                       "8bit": (tser.SER_MONO, 8, 1)}[case]
    frames = _frames(rng, 3, c, 16, 24)
    p, _ = _write_both(tmp_path, frames, color, depth, observer="obs",
                       instrument="cam", telescope="scope")
    r = _read_equal(p, 3)
    step = 1.0 / ((1 << depth) - 1)
    for k, f in enumerate(frames):
        np.testing.assert_allclose(r.read_frame(k).host(), f, rtol=0,
                                   atol=0.5 * step + 1e-7)
    if case == "bayer":
        assert r.read_frame(0).keywords.bayer_pattern == "RGGB"


def test_ser_timestamps_vs_jax(tmp_path, rng):
    t0 = jser.iso_to_ticks("2024-01-15T20:30:00")
    assert tser.iso_to_ticks("2024-01-15T20:30:00") == t0
    stamps = [t0 + i * 10_000_000 for i in range(3)]
    p, _ = _write_both(tmp_path, _frames(rng, 3, 1, 8, 8), tser.SER_MONO,
                       16, stamps)
    r = _read_equal(p, 3)
    assert r.header.timestamps == stamps
    assert r.fps == pytest.approx(1.0, rel=1e-3)
    for t in stamps + [t0 + 1234567]:
        assert tser.ticks_to_iso(t) == jser.ticks_to_iso(t)
    assert r.read_frame(1).keywords.date_obs.startswith("2024-01-15T20:30:01")


def test_ser_region_vs_jax(tmp_path, rng):
    p, _ = _write_both(tmp_path, _frames(rng, 2, 3, 24, 16), tser.SER_RGB,
                       16)
    a, b = jser.SerFile(p), tser.SerFile(p)
    for chan in range(3):
        np.testing.assert_array_equal(b.read_region(chan, 1, 5, 15),
                                      a.read_region(chan, 1, 5, 15))


def test_fitseq_writer_vs_jax(tmp_path, rng):
    """A FITS cube of 16-bit and of float32 frames: byte-equal files;
    every HDU read back through read_fits(hdu_index=) and the region
    reader as the JAX package reads it."""
    frames = _frames(rng, 4, 1, 16, 20)
    for bd in (20, -32):
        paths = []
        for mod, Img, name in ((jfio, JImage, "j.fit"),
                               (tfio, SirilImage, "t.fit")):
            p = str(tmp_path / f"{bd}{name}")
            w = mod.FitseqWriter(p, bitdepth=bd)
            for f in frames:
                img = Img(data=f)
                img.keywords.exposure = 5.0
                w.append(img)
            w.close()
            paths.append(p)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
        assert len(tfio.image_hdus(paths[1])) == 4
        for k in range(4):
            a = jfio.read_fits(paths[0], hdu_index=k)
            b = tfio.read_fits(paths[0], hdu_index=k)
            np.testing.assert_array_equal(b.host(), a.host())
            r = tfio.FitsReader(paths[0], hdu_index=k)
            assert r.is_u16() == (bd == 20)
            np.testing.assert_array_equal(r.read_region(0, 5, 15),
                                          a.host()[0, 5:15])


def _sources(d, rng, n=5, c=1, size=(20, 24)):
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(_frames(rng, n, c, *size)):
        img = SirilImage(data=(0.2 + 0.3 * f).astype(np.float32))
        img.keywords.exposure = 10.0
        tfio.write_fits(img, os.path.join(d, f"IMG{i:03d}.fit"))
    return sorted(os.path.join(d, f) for f in os.listdir(d))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("output", ["ser", "fitseq"])
def test_convert_outputs_vs_jax(tmp_path, rng, output, c):
    """``convert -ser`` / ``-fitseq``: one ``light_.ser`` (16-bit) or one
    FITS cube ``light_.fit``, byte-equal to the JAX package's, opened
    as a sequence of its type; the cube with its .seq."""
    files = _sources(str(tmp_path / "src"), rng, c=c)
    js = jconv.convert_to_sequence(files, "light", str(tmp_path / "jax"),
                                   output=output)
    ts = conversion.convert_to_sequence(files, "light",
                                        str(tmp_path / "port"),
                                        output=output)
    name = "light_." + ("ser" if output == "ser" else "fit")
    assert (tmp_path / "jax" / name).read_bytes() == \
        (tmp_path / "port" / name).read_bytes()
    assert ts.seq_type == (SEQ_SER if output == "ser" else SEQ_FITSEQ)
    assert (ts.number, ts.nb_layers, ts.ry, ts.rx) == \
        (js.number, js.nb_layers, js.ry, js.rx) == (5, c, 20, 24)
    for k in range(5):
        np.testing.assert_array_equal(ts.read_frame(k).host(),
                                      js.read_frame(k).host())
        np.testing.assert_array_equal(ts.read_region(c - 1, k, 3, 11),
                                      js.read_region(c - 1, k, 3, 11))
    # the port writes the cube's .seq (TF), which the JAX package reads;
    # neither writes one for a SER video, which opens by its name
    assert os.path.exists(tmp_path / "port" / "light_.seq") == \
        (output == "fitseq")
    if output == "fitseq":
        back = jsf.read_seqfile(str(tmp_path / "port" / "light_.seq"))
        assert back.seq_type == js.seq_type and back.number == 5


def test_convert_ser_input_vs_jax(tmp_path, rng):
    """A SER video among convert's inputs: its frames expanded into
    files; a SER video of SER inputs takes each one's first frame, as
    the JAX package does; load_any reads a SER's first frame."""
    p, _ = _write_both(tmp_path, _frames(rng, 3, 1, 12, 16),
                       tser.SER_MONO, 16)
    js = jconv.convert_to_sequence([p], "v", str(tmp_path / "jax"))
    ts = conversion.convert_to_sequence([p], "v", str(tmp_path / "port"))
    assert ts.number == js.number == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes()
    for d, mod in (("jax2", jconv), ("port2", conversion)):
        mod.convert_to_sequence([p], "s", str(tmp_path / d), output="ser")
    assert (tmp_path / "jax2" / "s_.ser").read_bytes() == \
        (tmp_path / "port2" / "s_.ser").read_bytes()
    assert tser.SerFile(str(tmp_path / "port2" / "s_.ser")).frame_count == 1
    np.testing.assert_array_equal(conversion.load_any(p).host(),
                                  jconv.load_any(p).host())


@pytest.mark.parametrize("kind", ["TS", "TF"])
def test_seq_type_cards_round_trip(tmp_path, rng, kind):
    """A SER or FITS-cube sequence's .seq (``TS`` / ``TF`` after the S
    card): the port writes the JAX package's text, each package reads the
    other's, and the port's sidecar opens the video or the cube."""
    files = _sources(str(tmp_path / "src"), rng)
    out = "ser" if kind == "TS" else "fitseq"
    js = jconv.convert_to_sequence(files, "c", str(tmp_path / "jax"),
                                   output=out)
    ts = conversion.convert_to_sequence(files, "c", str(tmp_path / "port"),
                                        output=out)
    for seq in (js, ts):
        seq.incl[1] = False
        seq.reference_image = 2
        r = seq.reg(0)
        r.H[:, 0, 2] = np.arange(5) * 0.5
        r.valid[:] = True
    js.save()
    ts.save()
    jt = open(tmp_path / "jax" / "c_.seq").read()
    tt = open(tmp_path / "port" / "c_.seq").read()
    assert f"\n{kind}\n" in tt
    assert tt.replace("L 1\n", "") == jt.replace("L 1\n", "")
    back = seqfile.read_seqfile(str(tmp_path / "jax" / "c_.seq"))
    assert back.seq_type == ts.seq_type
    assert (back.number, back.ry, back.rx) == (5, 20, 24)
    np.testing.assert_array_equal(back.incl, ts.incl)
    np.testing.assert_array_equal(back.reg(0).H, js.reg(0).H)
    np.testing.assert_array_equal(back.read_frame(3).host(),
                                  js.read_frame(3).host())
    cross = jsf.read_seqfile(str(tmp_path / "port" / "c_.seq"))
    assert cross.seq_type == js.seq_type


@pytest.mark.parametrize("card", ["TA"])
def test_film_card_raises(tmp_path, card):
    p = tmp_path / "x.seq"
    p.write_text(f"S 'x' 0 2 2 5 -1 7 0 0 0\n{card}\nL 1\nI 0 1\nI 1 1\n")
    # a film sequence opens its film (tests/test_torch_avi.py); none here
    with pytest.raises(FileNotFoundError, match="no film x"):
        seqfile.read_seqfile(str(p))


def _stack_both(jseq, tseq, paths=None):
    from siril_tpu.ops import rejection as jrj
    from siril_tpu.ops import stacking as jst
    from siril_tpu.ops.normalization import ADDITIVE_SCALING as JADD
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops import stacking as st
    from siril_tpu_torch.ops.normalization import ADDITIVE_SCALING

    a = jst.stack_sequence(jseq, jst.StackArgs(
        method="rej", rejection=jrj.SIGMA, normalize=JADD))
    real = st._resident_stack

    def spy(*a, **k):
        out = real(*a, **k)
        if paths is not None:
            paths.append("resident" if out is not None else "streamed")
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(st, "_resident_stack", spy)
        b = st.stack_sequence(tseq, st.StackArgs(
            method="rej", rejection=rj.SIGMA, normalize=ADDITIVE_SCALING),
            device="cpu")
    assert b.total_rejected == a.total_rejected
    return a.image.host(), b


@pytest.mark.parametrize("output", ["ser", "fitseq"])
def test_stack_video_and_cube_vs_jax(tmp_path, rng, output):
    """``stack`` of a SER and of a FITS-cube sequence against the JAX
    package (rej s 3 3, addscale); the cube takes the resident u16
    path and equals the stack of the same frames as files bit for bit;
    the SER sequence the streamed float32 path."""
    files = _sources(str(tmp_path / "src"), rng, n=6)
    js = jconv.convert_to_sequence(files, "c", str(tmp_path / "jax"),
                                   output=output)
    ts = conversion.convert_to_sequence(files, "c", str(tmp_path / "port"),
                                        output=output)
    paths = []
    a, b = _stack_both(js, ts, paths)
    np.testing.assert_allclose(b.image.host(), a, rtol=0, atol=2e-6)
    assert paths == ["resident" if output == "fitseq" else "streamed"]
    if output == "fitseq":
        plain = conversion.convert_to_sequence(files, "f",
                                               str(tmp_path / "plain"))
        assert plain.seq_type == SEQ_REGULAR
        _, c = _stack_both(JSequence.scan("f_", str(tmp_path / "plain")),
                           plain)
        np.testing.assert_array_equal(b.image.host(), c.image.host())


def test_cli_on_a_ser_sequence(tmp_path, rng):
    """The CLI opens ``name.ser`` as a sequence; a command run on it
    writes per-frame FITS outputs as the JAX package does (``r_c_00000``
    …, the SER frame numbers from 0)."""
    files = _sources(str(tmp_path / "src"), rng, n=3)
    conversion.convert_to_sequence(files, "c", str(tmp_path), output="ser")
    s = cli.run(["-d", str(tmp_path), "--device", "cpu", "stack", "c_",
                 "rej", "s", "3", "3", "-out=st"])
    assert s.sequence.seq_type == SEQ_SER
    assert s.image.data.shape == (1, 20, 24)
    seq = Sequence.from_ser(str(tmp_path / "c_.ser"))
    r = seq.reg(0)
    r.valid[:] = True
    seq.save()
    cli.run(["-d", str(tmp_path), "--device", "cpu", "seqapplyreg", "c_",
             "-prefix=r_"])
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("r_")) \
        == ["r_c_.seq", "r_c_00000.fit", "r_c_00001.fit", "r_c_00002.fit"]
