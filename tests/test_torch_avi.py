"""The port's AVI and film import (``siril_tpu_torch/io/avi.py``,
``io/films.py``, film sequences in ``core/sequence.py``, the ``TA`` card
of ``io/seqfile.py``, ``convert``'s expansion in ``io/conversion.py``)
against the JAX package on the CPU, on frames made from a seed with
numpy.

Tolerances, each with its reason:
- AVI files byte-equal and frames bit-equal, colour and grey (the same
  bytes, the same u8 / 255 in float32);
- ``convert`` of an AVI: the same FITS files, byte for byte;
- a film opened as a sequence (by name, and through a ``.seq`` with the
  ``TA`` card): its frames bit-equal to the JAX package's AVI reader's.
  The JAX package opens every film sequence through OpenCV (its
  ``Sequence.from_film``), the port an uncompressed AVI through its own
  reader, so those are compared with the JAX reader's frames;
- other films through OpenCV (installed here): the same decoded frames
  as the JAX package's ``FilmReader``; without OpenCV a compressed AVI
  and an ``.mp4`` raise the JAX package's ``RuntimeError``.
"""

import os
import re
import sys

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io import avi as javi
from siril_tpu.io import conversion as jconv
from siril_tpu.io import films as jfilms
from siril_tpu_torch.cli.context import Session
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import SEQ_AVI
from siril_tpu_torch.io import avi, conversion, films, seqfile


def _frames(rng, n, c, h=24, w=34):
    return [rng.uniform(0, 1, (c, h, w)).astype(np.float32)
            for _ in range(n)]


def _write_both(tmp_path, frames, color, name="t"):
    c, h, w = frames[0].shape
    pt, pj = str(tmp_path / f"{name}.avi"), str(tmp_path / f"j{name}.avi")
    tw = avi.AviWriter(pt, w, h, fps=10.0, color=color)
    jw = javi.AviWriter(pj, w, h, fps=10.0, color=color)
    for f in frames:
        tw.add_frame(SirilImage(data=f))
        jw.add_frame(JImage(data=f))
    tw.close()
    jw.close()
    return pt, pj


@pytest.mark.parametrize("chans,color", [(3, True), (1, False), (1, True)])
def test_avi_frames_vs_jax(tmp_path, chans, color):
    frames = _frames(np.random.default_rng(100 + chans), 4, chans)
    pt, pj = _write_both(tmp_path, frames, color)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    r, jr = avi.AviReader(pt), javi.AviReader(pt)
    assert (r.nframes, r.w, r.h, r.bpp) == (jr.nframes, jr.w, jr.h, jr.bpp)
    assert r.nchans == (3 if color else 1)
    for k in range(4):
        a, b = r.read_frame(k), jr.read_frame(k)
        np.testing.assert_array_equal(a.host(), b.host())
        assert a.keywords.filename == b.keywords.filename == "t.avi"
    (tmp_path / "x.avi").write_bytes(b"RIFFxxxx")
    with pytest.raises(ValueError, match="not an AVI"):
        avi.AviReader(str(tmp_path / "x.avi"))


def test_convert_avi_vs_jax(tmp_path):
    """convert of an 8-bit grey AVI: the frames expanded into FITS files
    and a .seq, equal to the JAX package's; -fitseq and -ser too."""
    frames = _frames(np.random.default_rng(104), 5, 1, 20, 32)
    pt, _ = _write_both(tmp_path, frames, False, "film")
    for out in ("fits", "fitseq", "ser"):
        jd, td = tmp_path / f"j_{out}", tmp_path / f"t_{out}"
        jconv.convert_to_sequence([pt], "film", str(jd), output=out)
        seq = conversion.convert_to_sequence([pt], "film", str(td),
                                             output=out, device="cpu")
        assert seq.number == 5
        names = sorted(f for f in os.listdir(jd) if not f.endswith(".seq"))
        assert names and sorted(f for f in os.listdir(td)
                                if not f.endswith(".seq")) == names
        for n in names:
            assert (jd / n).read_bytes() == (td / n).read_bytes(), n
    with pytest.raises(ValueError, match="film"):
        conversion.load_any(pt)
    with pytest.raises(ValueError):
        jconv.load_any(pt)


def test_film_sequence_and_ta_card(tmp_path):
    """An AVI opened as a sequence by its name, with or without its
    extension, and again through the .seq it saves (``TA``)."""
    frames = _frames(np.random.default_rng(105), 4, 3)
    pt, _ = _write_both(tmp_path, frames, True, "night")
    jr = javi.AviReader(pt)
    for name in ("night", "night.avi"):
        seq = Session(cwd=str(tmp_path), device="cpu").load_sequence(name)
        assert seq.seq_type == SEQ_AVI
        assert (seq.number, seq.nb_layers, seq.ry, seq.rx) == (4, 3, 24, 34)
        for k in range(4):
            np.testing.assert_array_equal(seq.read_frame(k).host(),
                                          jr.read_frame(k).host())
        np.testing.assert_array_equal(
            seq.read_region(1, 2, 5, 9), jr.read_frame(2).host()[1, 5:9])
    seq.incl[1] = False
    seq.reference_image = 2
    seq.save()
    text = (tmp_path / "night.seq").read_text()
    assert "\nTA\n" in text
    back = seqfile.read_seqfile(str(tmp_path / "night.seq"))
    assert back.seq_type == SEQ_AVI
    np.testing.assert_array_equal(back.incl, [True, False, True, True])
    assert back.reference_image == 2
    np.testing.assert_array_equal(back.read_frame(3).host(),
                                  jr.read_frame(3).host())
    (tmp_path / "lost.seq").write_text(text.replace("'night'", "'lost'"))
    with pytest.raises(FileNotFoundError, match="film"):
        seqfile.read_seqfile(str(tmp_path / "lost.seq"))


def _compressed_avi(path):
    """A RIFF/AVI header whose stream holds no uncompressed frame."""
    strf = b"strf" + (40).to_bytes(4, "little") + bytes(40)
    hdrl = b"LIST" + (4 + len(strf)).to_bytes(4, "little") + b"hdrl" + strf
    body = b"AVI " + hdrl
    with open(path, "wb") as f:
        f.write(b"RIFF" + len(body).to_bytes(4, "little") + body)


def test_films_without_opencv_raise_as_jax(tmp_path, monkeypatch):
    """No OpenCV: a compressed AVI and an .mp4 raise the JAX package's
    RuntimeError, in convert and as sequences."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    _compressed_avi(str(tmp_path / "c.avi"))
    (tmp_path / "m.mp4").write_bytes(b"\0" * 64)
    for p in ("c.avi", "m.mp4"):
        with pytest.raises(RuntimeError, match="OpenCV") as e:
            jconv.convert_to_sequence([str(tmp_path / p)], "x",
                                      str(tmp_path / "j"))
        with pytest.raises(RuntimeError, match=re.escape(str(e.value))):
            conversion.convert_to_sequence([str(tmp_path / p)], "x",
                                           str(tmp_path / "t"),
                                           device="cpu")
        with pytest.raises(RuntimeError, match="OpenCV"):
            Session(cwd=str(tmp_path), device="cpu").load_sequence(
                os.path.splitext(p)[0])
    assert films.FILM_EXTENSIONS == jfilms.FILM_EXTENSIONS
    assert films.is_film("a.MP4") and not films.is_film("a.fit")


def test_film_through_opencv_vs_jax(tmp_path):
    """An .avi written by OpenCV's codec decodes to the same frames in
    both packages' FilmReader, and opens as a film sequence."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(106)
    p = str(tmp_path / "mj.avi")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (32, 24))
    if not vw.isOpened():
        pytest.skip("OpenCV has no MJPG writer here")
    for _ in range(3):
        vw.write(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    vw.release()
    with pytest.raises(ValueError, match="compressed"):
        avi.AviReader(p)
    fr, jfr = films.open_film(p), jfilms.FilmReader(p)
    assert isinstance(fr, films.FilmReader)
    assert (fr.nframes, fr.nchans, fr.w, fr.h) == (jfr.nframes, jfr.nchans,
                                                   jfr.w, jfr.h)
    for k in (0, 2, 1):
        a, b = fr.read_frame(k), jfr.read_frame(k)
        np.testing.assert_array_equal(a.host(), b.host())
        assert a.orig_bitdepth == b.orig_bitdepth == 8
    fr.close()
    seq = Session(cwd=str(tmp_path), device="cpu").load_sequence("mj")
    assert seq.seq_type == SEQ_AVI and seq.number == 3
