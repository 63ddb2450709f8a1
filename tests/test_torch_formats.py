"""The port's image formats for ``convert`` (camera raw, DNG, XISF, IRIS
``.pic``, TIFF / PNG / BMP / PNM and the save commands) against the JAX
package on the CPU, on the same seeded files.

Bounds: every raw container's data bit-equal, with the same CFA pattern
and keywords (the writers of ``tests/test_rawfile.py`` and
``tests/test_dng.py`` feed both readers), and the gated inputs raising
in both; the three native decoders bit-equal to the port's Python
decoders; ``convert`` / ``convertraw`` of raw files the same frames;
XISF and ``.pic`` read across; TIFF, PNG, BMP and PNM: the port's files
read back by PIL (OpenCV where PIL cannot hold 16-bit colour) equal to
``to_u16`` / ``to_u8`` (float32 exactly for ``savetif32``), PIL's files
read by the port as the JAX package reads them, and each departure
shown beside the JAX package's raise or misread.
"""

import os
import struct

import numpy as np
import pytest

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io import conversion as jconv
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.io import conversion as tconv
from siril_tpu_torch.io import dng as tdng
from siril_tpu_torch.io import image_formats as imf
from siril_tpu_torch.io import rawfile as traw
from tests import test_dng as wdng
from tests import test_rawfile as wraw

KW = ("bayer_pattern", "instrume", "exposure", "filename", "binning_x",
      "binning_y")


def _same(t, j):
    assert t.host().shape == j.host().shape
    assert np.array_equal(t.host(), j.host())
    for k in KW:
        if hasattr(j.keywords, k):
            assert getattr(t.keywords, k) == getattr(j.keywords, k), k
    assert t.orig_bitdepth == j.orig_bitdepth


def _lintable_lossless(bits):
    white = (1 << bits) - 1
    vpred = [white // 4] * 4
    return (bytes([0x46, 0x30]) + struct.pack("<4H", *vpred)
            + struct.pack("<H", 1)), vpred


def _raw_cases():
    """(name, file name, writer(path, rng))."""
    def cr2(p, rng):
        wraw.write_cr2(p, rng.integers(1800, 16384, (16, 20)).astype(
            np.uint16))

    def nef(bits):
        def w(p, rng):
            wraw.write_nef(p, rng.integers(0, 1 << bits, (12, 16)).astype(
                np.uint16), bits=bits)
        return w

    def nef_huff(p, rng):
        s = wraw._smooth_sensor(rng, 10, 24, 0, 4095, 900)
        tbl, vpred = _lintable_lossless(12)
        wraw.write_nef_compressed(p, s, 12, tbl, vpred)

    def arw(p, rng):
        s = rng.integers(0, 1 << 14, (6, 8)).astype(np.uint16)
        wraw.write_arw(p, s.astype("<u2").tobytes(), 6, 8, comp=1, bits=14)

    def arw2(p, rng):
        blk = [wraw._encode_arw2_block(
            min(v + 500, 0x7FF), v, 3, 11,
            [int(d) for d in rng.integers(0, 128, 14)])
            for v in (int(v) for v in rng.integers(0, 900, 16))]
        wraw.write_arw(p, b"".join(blk), 4, 64, comp=32767)

    def raf(p, rng):
        from siril_tpu.ops.xtrans import XTRANS_PATTERNS

        s = rng.integers(0, 1 << 14, (12, 18)).astype(np.uint16)
        s[0, 0] = (1 << 14) - 1
        wraw.write_raf(p, s, xtrans36=XTRANS_PATTERNS[0])

    def rw2(p, rng):
        s = rng.integers(140, 4096, (10, 28)).astype(np.uint16)
        wraw.write_rw2(p, s.astype("<u2").tobytes(), 10, 28, cfa=2,
                       blacks=(128, 128, 128))

    def rw2_v4(p, rng):
        blob = rng.integers(0, 256, 200).astype(np.uint8).tobytes()
        wraw.write_rw2(p, blob, 4, 28, byte_count=len(blob))

    def rw2_v5(p, rng):
        s = wraw._natural_sensor(rng, 64, 96, maxv=4095)
        wraw.write_rw2(p, wraw._encode_pana_v5(s, 12), 64, 96, bits=12,
                       raw_format=5)

    def rw2_v6(p, rng):
        yy, xx = np.mgrid[0:64, 0:88].astype(np.float32)
        s = np.clip(420 + 180 * np.sin(xx / 88 * 3.0) + 120 * (yy / 64)
                    + rng.normal(0, 10.0, (64, 88)), 96, 900).astype(
                        np.uint16)
        wraw.write_rw2(p, wraw._encode_pana_v6(s), 64, 88, bits=14,
                       raw_format=6)

    def pef(p, rng):
        wraw._write_tiff_cfa(p, rng.integers(0, 4096, (8, 24)).astype(
            np.uint16), b"II*\x00")

    def orf(p, rng):
        wraw._write_tiff_cfa(p, wraw._natural_sensor(rng, 16, 24), b"IIRO",
                             packed=True, cfa_vals=(1, 0, 2, 1))

    def dng(bits, comp):
        def w(p, rng):
            lo, hi = (2048 - 500, 2048 + 500) if comp == 7 else (
                0, (1 << bits) - 1)
            wdng.write_dng(p, rng.integers(lo, hi, (24, 32)).astype(
                np.uint16), bits=bits, compression=comp)
        return w

    return [("cr2", "a.cr2", cr2), ("nef12", "a.nef", nef(12)),
            ("nef14", "a.nef", nef(14)), ("nef_huffman", "a.nef", nef_huff),
            ("arw", "a.arw", arw), ("arw2", "a.arw", arw2),
            ("raf_xtrans", "a.raf", raf), ("rw2", "a.rw2", rw2),
            ("rw2_v4", "a.rw2", rw2_v4), ("rw2_v5", "a.rw2", rw2_v5),
            ("rw2_v6", "a.rw2", rw2_v6), ("pef", "a.pef", pef),
            ("orf", "a.orf", orf), ("dng16", "a.dng", dng(16, 1)),
            ("dng12", "a.dng", dng(12, 1)), ("dng_ljpeg", "a.dng", dng(16, 7))]


@pytest.mark.parametrize("name,fname,writer", _raw_cases(),
                         ids=[c[0] for c in _raw_cases()])
def test_raw_container_vs_jax(tmp_path, name, fname, writer):
    p = str(tmp_path / fname)
    writer(p, np.random.default_rng(len(name)))
    _same(tconv.load_any(p), jconv.load_any(p))


def _gated():
    def cr3(p):
        with open(p, "wb") as f:
            f.write(b"\x00\x00\x00\x18ftypcrx " + b"\0" * 64)

    def pef_comp(p):
        wraw._write_tiff_cfa(p, np.zeros((4, 8), np.uint16), b"II*\x00",
                             comp=65535)

    def rw2_v7(p):
        wraw.write_rw2(p, b"\x00" * 4096, 16, 16, bits=14, raw_format=7)

    def heif(p):
        with open(p, "wb") as f:
            f.write(b"\x00\x00\x00\x18ftypheic" + b"\0" * 64)

    return [("x.cr3", cr3), ("c.pef", pef_comp), ("v7.rw2", rw2_v7),
            ("x.heic", heif)]


@pytest.mark.parametrize("fname,writer", _gated(),
                         ids=[g[0] for g in _gated()])
def test_gated_inputs_raise_in_both(tmp_path, fname, writer):
    p = str(tmp_path / fname)
    writer(p)
    with pytest.raises(ValueError) as want:
        jconv.load_any(p)
    with pytest.raises(ValueError) as got:
        tconv.load_any(p)
    assert str(got.value) == str(want.value)


def test_native_decoders_vs_python():
    """decode_ljpeg, decode_nikon and decode_panasonic of the port's C++
    bit-equal to its Python decoders (and to the written values); a
    stream that does not decode raises."""
    from siril_tpu_torch import native

    rng = np.random.default_rng(17)
    img = rng.integers(0, 65535, (40, 32)).astype(np.uint16)
    blob = wdng.encode_ljpeg(img)
    out, nc = native.decode_ljpeg(blob)
    ref, rnc = tdng._ljpeg_decode_py(blob)
    assert nc == rnc == 1
    assert np.array_equal(out, ref) and np.array_equal(out, img)
    s = wraw._smooth_sensor(rng, 9, 20, 0, 4095, 800)
    vpred = np.array([512] * 4, np.uint16)
    raw = wraw._nikon_encode(s, 2, vpred, 0)
    a = native.decode_nikon(raw, 20, 9, 2, vpred, 0)
    assert np.array_equal(a, traw._nikon_decode_py(raw, 20, 9, 2, vpred, 0))
    assert np.array_equal(a, s)
    blob = rng.integers(0, 256, 3 * 0x4000).astype(np.uint8).tobytes()
    a = native.decode_panasonic(blob, 140, 288)
    assert np.array_equal(a, traw._pana_bits_decode_py(blob, 140, 288))
    with pytest.raises(ValueError, match="Nikon"):
        native.decode_nikon(raw, 20, 9, 9, vpred, 0)
    with pytest.raises(ValueError, match="lossless JPEG"):
        native.decode_ljpeg(b"\xff\xd8\xff\xc3" + b"\0" * 12)


@pytest.mark.parametrize("line", ["convert raw", "convert raw -debayer",
                                  "convertraw raw -debayer"])
def test_convert_raw_vs_jax(tmp_path, caplog, line):
    from siril_tpu.ops.xtrans import XTRANS_PATTERNS  # noqa: F401
    from tests.test_torch_analysis import Both

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        wdng.write_dng(str(src / f"shot{i}.dng"),
                       rng.integers(1000, 50000, (32, 40)).astype(np.uint16))
        wraw.write_nef(str(src / f"shot{i}.nef"),
                       rng.integers(0, 4096, (32, 40)).astype(np.uint16))
    both = Both(tmp_path, caplog, src)
    both.run(line)
    names = sorted(f for f in os.listdir(both.dirs["jax"])
                   if f.startswith("raw_"))
    assert names == sorted(f for f in os.listdir(both.dirs["port"])
                           if f.startswith("raw_"))
    assert len([n for n in names if n.endswith(".fit")]) == 4
    from siril_tpu.io.fits_io import read_fits as jread
    from siril_tpu_torch.io.fits_io import read_fits as tread

    for n in names:
        if n.endswith(".fit"):
            a = tread(str(both.dirs["port"] / n)).host()
            b = jread(str(both.dirs["jax"] / n)).host()
            assert a.shape == b.shape and a.shape[0] == (
                3 if "debayer" in line else 1)
            assert np.abs(a - b).max() <= (1e-6 if "debayer" in line
                                           else 0.0)


def test_convert_takes_rw2_pef_orf(tmp_path):
    """A departure (ROADMAP §3): the port's ``convert`` takes every
    extension ``load_any`` reads; the JAX package's list lacks RW2, PEF,
    ORF, XISF and PIC, and its ``convert`` finds nothing."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import CommandError as JErr
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession

    rng = np.random.default_rng(2)
    wraw.write_rw2(str(tmp_path / "a.rw2"), rng.integers(
        0, 4096, (8, 28)).astype("<u2").tobytes(), 8, 28)
    wraw._write_tiff_cfa(str(tmp_path / "b.pef"), rng.integers(
        0, 4096, (8, 28)).astype(np.uint16), b"II*\x00")
    with pytest.raises(JErr, match="no convertible"):
        JCMD["convert"].fn(JSession(cwd=str(tmp_path)), ["raw"])
    t = TSession(cwd=str(tmp_path), device="cpu")
    TCMD["convert"].fn(t, ["raw"])
    assert t.sequence.number == 2


def test_xisf_and_pic_read_across(tmp_path):
    from siril_tpu.io import internal_formats as jpic
    from siril_tpu.io import xisf as jxisf
    from siril_tpu_torch.io import internal_formats as tpic
    from siril_tpu_torch.io import xisf as txisf

    rng = np.random.default_rng(9)
    data = rng.random((3, 24, 30)).astype(np.float32)
    for fmt in ("UInt16", "Float32"):
        for comp, sh in ((False, False), (True, False), (True, True)):
            tp = str(tmp_path / f"t{fmt}{comp}{sh}.xisf")
            txisf.write_xisf(TImage(data=data.copy()), tp, fmt, comp, sh)
            _same(tconv.load_any(tp), jconv.load_any(tp))
            jp = str(tmp_path / f"j{fmt}{comp}.xisf")
            jxisf.write_xisf(JImage(data=data.copy()), jp, fmt, comp)
            _same(tconv.load_any(jp), jconv.load_any(jp))
    img = TImage(data=data[:1].copy())
    img.keywords.binning_x = 2
    tpic.write_pic(img, str(tmp_path / "t.pic"))
    jpic.write_pic(JImage(data=data[:1].copy()), str(tmp_path / "j.pic"))
    assert (tmp_path / "t.pic").read_bytes()[290:] == \
        (tmp_path / "j.pic").read_bytes()[290:]
    for n in ("t.pic", "j.pic"):
        _same(tconv.load_any(str(tmp_path / n)),
              jconv.load_any(str(tmp_path / n)))
    assert tconv.load_any(str(tmp_path / "t.pic")).keywords.binning_x == 2


def _rgb(seed=4, h=37, w=53):
    rng = np.random.default_rng(seed)
    d = rng.random((3, h, w)).astype(np.float32) * 1.1 - 0.05
    d[:, 0, :4] = [0.0, 1.0, 0.5 / 65535, 0.5 / 255]
    return d


def _read_back(path):
    """What PIL reads, as (C, H, W); OpenCV (BGR → RGB) where PIL cannot
    hold 16-bit colour."""
    from PIL import Image

    im = Image.open(path)
    if im.mode == "RGB" and np.asarray(im).dtype == np.uint8 and \
            not path.endswith((".bmp", ".ppm")):
        import cv2

        a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if a.dtype != np.uint8:
            return np.moveaxis(a[:, :, ::-1], 2, 0)
    a = np.asarray(im)
    return a[None] if a.ndim == 2 else np.moveaxis(a, 2, 0)


SAVES = [("savetif", "tif", 16), ("savetif -deflate", "tif", 16),
         ("savetif8", "tif", 8), ("savepng", "png", 16),
         ("savebmp", "bmp", 8), ("savepnm", "ppm", 8)]


@pytest.mark.parametrize("nch", [1, 3])
@pytest.mark.parametrize("cmd,ext,bits", SAVES,
                         ids=[s[0] for s in SAVES])
def test_save_commands_vs_jax(tmp_path, caplog, cmd, ext, bits, nch):
    """The port's file read back by PIL (OpenCV for 16-bit colour) equals
    to_u16 / to_u8, and ``load`` reads it back so; the JAX package writes
    the same values where PIL lets it (8 bits, and 16-bit mono), and
    raises on 16-bit colour (a departure, ROADMAP §3)."""
    from tests.test_torch_analysis import Both

    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    data = _rgb()[:nch]
    both = Both(tmp_path, caplog)
    both.load(data)
    words = cmd.split()
    want = TImage(data=data).to_u16() if bits == 16 else \
        TImage(data=data).to_u8()
    assert np.array_equal(want, JImage(data=data).to_u16() if bits == 16
                          else JImage(data=data).to_u8())
    tp = str(both.dirs["port"] / f"out.{ext}")
    jp = str(both.dirs["jax"] / f"out.{ext}")
    if bits == 16 and nch == 3:     # PIL holds no 16-bit colour
        TCMD[words[0]].fn(both.t, ["out"] + words[1:])
        with pytest.raises(TypeError):
            JCMD[words[0]].fn(both.j, ["out"] + words[1:])
    else:
        (_, jl), (_, tl) = both.run(f"{words[0]} out {' '.join(words[1:])}")
        assert tl == jl
        assert np.array_equal(_read_back(jp), want)
    assert np.array_equal(_read_back(tp), want)
    back = tconv.load_any(tp).host()
    assert np.array_equal(back, want.astype(np.float32) /
                          np.float32(65535.0 if bits == 16 else 255.0))
    if os.path.exists(jp):
        assert np.array_equal(tconv.load_any(jp).host(), back)
        assert np.array_equal(jconv.load_any(jp).host(), back)


@pytest.mark.parametrize("nch", [1, 3])
def test_savetif32_vs_jax(tmp_path, caplog, nch):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from tests.test_torch_analysis import Both

    data = _rgb()[:nch]
    both = Both(tmp_path, caplog)
    both.load(data)
    TCMD["savetif32"].fn(both.t, ["f"])
    tp = str(both.dirs["port"] / "f.tif")
    assert np.array_equal(tconv.load_any(tp).host(), data)
    import cv2

    a = cv2.imread(tp, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(a if nch == 1 else np.moveaxis(a[:, :, ::-1], 2, 0),
                          data[0] if nch == 1 else data)
    if nch == 3:                    # PIL holds no float colour
        with pytest.raises(TypeError):
            JCMD["savetif32"].fn(both.j, ["f"])
        return
    JCMD["savetif32"].fn(both.j, ["f"])
    jp = str(both.dirs["jax"] / "f.tif")
    assert np.array_equal(jconv.load_any(jp).host(), data)
    assert np.array_equal(tconv.load_any(jp).host(), data)


PIL_FILES = [("L", ".png", {}), ("L", ".tif", {}), ("L", ".bmp", {}),
             ("L", ".pgm", {}), ("RGB", ".png", {}), ("RGB", ".tif", {}),
             ("RGB", ".tif", {"compression": "tiff_deflate"}),
             ("RGB", ".tif", {"compression": "tiff_lzw"}),
             ("RGB", ".bmp", {}), ("RGB", ".ppm", {}), ("RGBA", ".png", {}),
             ("I;16", ".png", {}), ("I;16", ".tif", {}),
             ("I;16", ".tif", {"compression": "tiff_deflate"}),
             ("F", ".tif", {}), ("RGB", ".jpg", {})]


@pytest.mark.parametrize("mode,ext,kw", PIL_FILES,
                         ids=[f"{m}{e}{'-' + k['compression'] if k else ''}"
                              for m, e, k in PIL_FILES])
def test_pil_files_read_as_jax(tmp_path, mode, ext, kw):
    """Files PIL writes (PNG with its adaptive row filters, deflate and
    LZW TIFF, JPEG): the port reads what the JAX package's load_any reads
    (LZW and JPEG go through PIL in both)."""
    from PIL import Image

    rng = np.random.default_rng(8)
    shape = (33, 47)
    if mode == "I;16":
        a = rng.integers(0, 65536, shape, dtype=np.uint16)
    elif mode == "F":
        a = rng.random(shape).astype(np.float32)
    else:
        n = {"L": 0, "RGB": 3, "RGBA": 4}[mode]
        a = rng.integers(0, 256, shape + ((n,) if n else ()), dtype=np.uint8)
        a = (a // 16) * 16 if ext == ".png" else a    # filter-friendly rows
    p = str(tmp_path / f"x{ext}")
    Image.fromarray(a).save(p, **kw)
    _same(tconv.load_any(p), jconv.load_any(p))


def test_png_row_filters():
    """Every PNG row filter undone (native/decoders.cpp) as the plain
    definitions give it, on rows filtered with each of the five."""
    import zlib

    rng = np.random.default_rng(3)
    h, w, bpp = 10, 7, 3
    img = rng.integers(0, 256, (h, w * bpp)).astype(np.int64)
    rows = []
    for y in range(h):
        ft = y % 5
        prev = img[y - 1] if y else np.zeros(w * bpp, np.int64)
        out = []
        for i in range(w * bpp):
            a = img[y, i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if (y and i >= bpp) else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    ][ft]
            out.append((img[y, i] - pred) % 256)
        rows.append(bytes([ft] + out))
    from siril_tpu_torch import native

    got = native.png_unfilter(zlib.decompress(zlib.compress(b"".join(rows))),
                              h, w * bpp, bpp)
    assert np.array_equal(got, img.astype(np.uint8))


def test_pnm16_departure(tmp_path):
    """A 16-bit PGM: the JAX package reads PIL's int32 and leaves it at
    0…65535; the port normalises it (ROADMAP §3)."""
    a = np.random.default_rng(1).integers(0, 65536, (1, 20, 30),
                                          dtype=np.uint16)
    p = str(tmp_path / "x.pgm")
    imf.write_pnm(p, a)
    assert np.array_equal(jconv.load_any(p).host(), a.astype(np.float32))
    assert np.array_equal(tconv.load_any(p).host(),
                          a.astype(np.float32) / np.float32(65535.0))


def test_savejpg_and_savejxl(tmp_path, caplog, monkeypatch):
    """savejpg through PIL equals the JAX package's file; without PIL it
    and savejxl raise a CommandError naming PIL."""
    import sys

    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import CommandError
    from tests.test_torch_analysis import Both

    both = Both(tmp_path, caplog)
    both.load(_rgb())
    (_, jl), (_, tl) = both.run("savejpg q -quality=80")
    assert tl == jl
    from PIL import Image

    assert np.array_equal(
        np.asarray(Image.open(both.dirs["port"] / "q.jpg")),
        np.asarray(Image.open(both.dirs["jax"] / "q.jpg")))
    assert JCMD["savejpg"] is not TCMD["savejpg"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    for cmd in ("savejpg", "savejxl"):
        with pytest.raises(CommandError, match="PIL"):
            TCMD[cmd].fn(both.t, ["n"])
    with pytest.raises(ValueError, match="PIL"):
        tconv.load_any(str(both.dirs["port"] / "q.jpg"))


@pytest.mark.parametrize("level", [120, 1500])
def test_packed12_dark_frame_departure(tmp_path, level):
    """A 12-bit packed ORF of a dark frame (a night sky): the JAX
    package's packing-order picker compares the two orders' relative
    roughness, and the wrong order, whose level rises more than its
    median step, wins; the port compares the steps of each order's
    rougher column parity in ADU and reads the written values (ROADMAP
    §3).  Bright frames, and strips packed in the other order than the
    container's, read the same in both."""
    rng = np.random.default_rng(level)
    h, w = 128, 192
    xx = np.mgrid[0:h, 0:w][1]
    s = np.clip(level + 20 * np.sin(xx / w * 3) + rng.normal(0, 6, (h, w)),
                0, 4095).astype(np.uint16)
    p = str(tmp_path / "dark.orf")
    wraw._write_tiff_cfa(p, s, b"IIRO", packed=True)
    assert np.array_equal(np.rint(tconv.load_any(p).host()[0] * 4095), s)
    assert not np.array_equal(np.rint(jconv.load_any(p).host()[0] * 4095), s)
    sensor = wraw._natural_sensor(rng, 64, 96)
    v0, v1 = sensor.reshape(-1)[0::2], sensor.reshape(-1)[1::2]
    b = np.zeros(sensor.size // 2 * 3, np.uint8)
    b[0::3] = (v0 >> 4).astype(np.uint8)
    b[1::3] = (((v0 & 0xF) << 4) | (v1 >> 8)).astype(np.uint8)
    b[2::3] = (v1 & 0xFF).astype(np.uint8)
    for name, kw in (("swapped", dict(raw_override=b.tobytes())),
                     ("natural", dict(packed=True))):
        q = str(tmp_path / f"{name}.orf")
        wraw._write_tiff_cfa(q, sensor, b"IIRO", **kw)
        _same(tconv.load_any(q), jconv.load_any(q))
        assert np.array_equal(np.rint(tconv.load_any(q).host()[0] * 4095),
                              sensor)


def test_chip_smoke_encoders():
    """chip_smoke's vectorized lossless-JPEG and Nikon encoders, whose
    streams the card run decodes: the port's Python decoders return the
    image."""
    import chip_smoke

    rng = np.random.default_rng(12)
    img = rng.integers(0, 1 << 14, (48, 64)).astype(np.uint16)
    assert np.array_equal(
        tdng._ljpeg_decode_py(chip_smoke.encode_ljpeg(img, 14))[0], img)
    raw, vpred = chip_smoke.encode_nikon(img)
    assert np.array_equal(traw._nikon_decode_py(raw, 64, 48, 5, vpred, 0),
                          img)
