"""The port's FITS pixel formats and tiled compression against the JAX
package on the CPU (``siril_tpu_torch/io/fits_io.py``,
``io/fits_compress.py``, ``native/``), on the same data made from a seed
with numpy.

Tolerances, each with its reason:
- BITPIX 8/16/32/-32/-64 reads equal: the same numpy conversions;
- written files byte-equal: the same cards and the same conversions;
- RICE_1 streams byte-equal for BYTEPIX 2 and 4, the C++ coder's equal to
  the Python coder's; GZIP_1 / GZIP_2 byte-equal (zlib level 6 in both);
- compressed files read across the two packages equal;
- the stack of a compressed (fz) sequence within 2e-6 of the stack of the
  same 16-bit frames uncompressed, and of the JAX package's: the fz
  frames are decoded on the host and take the streamed path, the plain
  ones the resident path, whose estimators differ by an ulp
  (tests/test_torch_stacking.py).
"""

import os
import shutil

import numpy as np
import pytest

from siril_tpu.cli.commands import COMMANDS as JCOMMANDS
from siril_tpu.cli.context import Session as JSession
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io import fits_compress as jfc
from siril_tpu.io import fits_io as jfio
from siril_tpu_torch import cli, native
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.io import fits_compress as tfc
from siril_tpu_torch.io import fits_io as tfio


def _raw_fits(path, data, bitpix, bzero=None, bscale=None, top_down=False):
    """A one-HDU FITS file of the stored values ``data`` (C, H, W) at
    ``bitpix``, written with numpy."""
    c, h, w = data.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    cards = ["SIMPLE  =                    T", f"BITPIX  = {bitpix:>20}",
             f"NAXIS   = {2 if c == 1 else 3:>20}", f"NAXIS1  = {w:>20}",
             f"NAXIS2  = {h:>20}"]
    if c > 1:
        cards.append(f"NAXIS3  = {c:>20}")
    if bzero is not None:
        cards.append(f"BZERO   = {bzero:>20}")
    if bscale is not None:
        cards.append(f"BSCALE  = {bscale:>20}")
    if top_down:
        cards.append("ROWORDER= 'TOP-DOWN'")
    cards += ["EXPTIME =                 30.0", "END"]
    hdr = "".join(c_.ljust(80) for c_ in cards).encode("ascii")
    hdr += b" " * ((-len(hdr)) % 2880)
    body = np.ascontiguousarray(data).astype(dt).tobytes()
    with open(path, "wb") as f:
        f.write(hdr + body + b"\0" * ((-len(body)) % 2880))


_STORED = {
    8: (lambda r: r.integers(0, 256, (2, 12, 10)), None, None),
    16: (lambda r: r.integers(-32768, 32767, (1, 12, 10)), 32768.0, 1.0),
    32: (lambda r: r.integers(-2**31, 2**31 - 1, (3, 12, 10)),
         2147483648.0, 1.0),
    -32: (lambda r: r.uniform(0, 1, (1, 12, 10)), None, None),
    -64: (lambda r: r.uniform(0, 1, (3, 12, 10)), None, None),
}


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_read_bitpix_vs_jax(tmp_path, bitpix, top_down):
    """Every BITPIX the JAX package reads, through read_fits and the
    region reader, equal to it."""
    make, bzero, bscale = _STORED[bitpix]
    p = str(tmp_path / "a.fit")
    _raw_fits(p, make(np.random.default_rng(bitpix + 100)), bitpix, bzero,
              bscale, top_down)
    a, b = jfio.read_fits(p), tfio.read_fits(p)
    np.testing.assert_array_equal(b.host(), a.host())
    assert b.orig_bitdepth == a.orig_bitdepth
    assert b.keywords.exposure == a.keywords.exposure == 30.0
    r = tfio.FitsReader(p)
    assert not r.is_f32() or bitpix == -32
    for chan in range(b.nchans):
        np.testing.assert_array_equal(r.read_region(chan, 3, 9),
                                      a.host()[chan, 3:9])


def test_read_signed_and_scaled_vs_jax(tmp_path):
    rng = np.random.default_rng(5)
    for k, (bitpix, bzero, bscale) in enumerate(
            [(16, None, None), (8, 10.0, 0.5), (32, 0.0, 2.0),
             (-32, 0.25, 0.5)]):
        p = str(tmp_path / f"s{k}.fit")
        _raw_fits(p, _STORED[bitpix][0](rng), bitpix, bzero, bscale)
        np.testing.assert_array_equal(tfio.read_fits(p).host(),
                                      jfio.read_fits(p).host())
    _raw_fits(str(tmp_path / "i64.fit"), np.zeros((1, 4, 4)), -64)
    with open(tmp_path / "i64.fit", "r+b") as f:
        f.seek(80)
        f.write(f"BITPIX  = {64:>20}".ljust(80).encode())
    with pytest.raises(ValueError, match="BITPIX 64"):
        tfio.read_fits(str(tmp_path / "i64.fit"))


@pytest.mark.parametrize("bitdepth", [8, 20, -32, -64])
def test_write_bytes_vs_jax(tmp_path, bitdepth):
    """8-bit, 16-bit, float32, and -64 written as float32: the same
    bytes as the JAX package's, which reads them back."""
    rng = np.random.default_rng(30)
    data = rng.uniform(-0.1, 1.1, (3, 20, 24)).astype(np.float32)
    a, b = JImage(data=data), SirilImage(data=data)
    for img in (a, b):
        img.keywords.exposure = 25.0
        img.keywords.object = "M 42"
        img.history.append("made")
    pa, pb = str(tmp_path / "j.fit"), str(tmp_path / "t.fit")
    jfio.write_fits(a, pa, bitdepth=bitdepth)
    tfio.write_fits(b, pb, bitdepth=bitdepth)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    back = jfio.read_fits(pb)
    step = {8: 1 / 255, 20: 1 / 65535}.get(bitdepth, 0.0)
    assert np.abs(back.host() - np.clip(data, 0, 1) if step else
                  back.host() - data).max() <= step / 2 + 1e-7


def test_write_unsupported_depth_raises(tmp_path):
    img = SirilImage(data=np.zeros((1, 4, 4), np.float32))
    with pytest.raises(ValueError, match="bitdepth 32"):
        tfio.write_fits(img, str(tmp_path / "x.fit"), bitdepth=32)


@pytest.mark.parametrize("bytepix", [1, 2, 4])
def test_rice_streams_vs_jax(bytepix):
    """The Python RICE_1 coder byte-equal to the JAX package's, on noise,
    a smooth ramp and runs of equal values (the zero and uncoded
    blocks); decoded back exactly."""
    rng = np.random.default_rng(bytepix)
    lim = {1: 120, 2: 30000, 4: 2_000_000_000}[bytepix]
    for x in (rng.integers(-lim, lim, 257),
              (np.sin(np.linspace(0, 20, 300)) * lim / 4).astype(np.int64),
              np.r_[np.full(70, 7), rng.integers(-lim, lim, 40)]):
        enc = tfc.rice_encode(x, bytepix)
        assert enc == jfc.rice_encode(x, bytepix)
        np.testing.assert_array_equal(tfc.rice_decode(enc, x.size, bytepix),
                                      x)


def test_rice_cpp_vs_python():
    """BYTEPIX 2: the C++ coder's streams equal the Python coder's, row by
    row, and decode back exactly (64 rows of 16-bit noise and a sky)."""
    rng = np.random.default_rng(9)
    rows = np.concatenate([
        rng.integers(-32768, 32767, (32, 300)),
        (rng.normal(2000, 30, (32, 300))).astype(np.int64)]).astype(np.int16)
    heap, offs, lens = native.rice_encode_tiles_i16(rows)
    for k in range(len(rows)):
        assert heap[offs[k]:offs[k] + lens[k]] == tfc.rice_encode(
            rows[k].astype(np.int64), 2)
    np.testing.assert_array_equal(
        native.rice_decode_tiles_i16(heap, offs, lens, rows.shape[1]), rows)


def test_rice_build_failure_raises(tmp_path, monkeypatch):
    """A failed build of the C++ coder raises; nothing falls back to the
    Python coder."""
    bad = tmp_path / "rice.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.rice_encode_tiles_i16(np.zeros((2, 8), np.int16))
    img = SirilImage(data=np.zeros((1, 4, 8), np.float32))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tfio.write_fits(img, str(tmp_path / "x.fit"), bitdepth=20,
                        compression="rice")


@pytest.mark.parametrize("comp,bitdepth", [
    ("rice", 20), ("gzip1", 20), ("gzip2", 20), ("rice", -32),
    ("gzip2", -32), ("gzip1", 8)])
def test_compressed_files_vs_jax(tmp_path, comp, bitdepth):
    """``write_fits(compression=)``: the JAX package's bytes (float images
    always GZIP_1); each package reads the other's file as its own."""
    rng = np.random.default_rng(40)
    data = rng.uniform(0, 1, (3, 18, 21)).astype(np.float32)
    a, b = JImage(data=data), SirilImage(data=data)
    for img in (a, b):
        img.keywords.exposure = 25.0
    pa, pb = str(tmp_path / "j.fit"), str(tmp_path / "t.fit")
    jfio.write_fits(a, pa, bitdepth=bitdepth, compression=comp)
    tfio.write_fits(b, pb, bitdepth=bitdepth, compression=comp)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    blob = open(pb, "rb").read(5760).decode("ascii", "replace")
    assert "ZIMAGE" in blob and "BINTABLE" in blob
    mine, theirs = tfio.read_fits(pa), jfio.read_fits(pb)
    np.testing.assert_array_equal(mine.host(), theirs.host())
    assert mine.orig_bitdepth == theirs.orig_bitdepth
    assert mine.keywords.exposure == 25.0
    tol = 0.0 if bitdepth == -32 else 0.5 / 65535 + 1e-7
    assert np.abs(mine.host() - data).max() <= tol
    r = tfio.FitsReader(pb)
    assert not r.is_u16() and not r.is_f32()
    np.testing.assert_array_equal(r.read_region(1, 2, 9),
                                  mine.host()[1, 2:9])


@pytest.mark.parametrize("kind", ["rice", "gzip2"])
def test_setcompress_save_vs_jax(tmp_path, kind):
    """``setcompress 1 -type=…`` then ``save`` (tests/test_fits_io.py:200):
    the JAX package's bytes; ``setcompress 0`` writes a plain file
    again."""
    rng = np.random.default_rng(50)
    write_src = SirilImage(data=rng.uniform(0, 1, (1, 16, 16)).astype(
        np.float32))
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        tfio.write_fits(write_src, str(tmp_path / d / "a.fit"))
    js = JSession(cwd=str(tmp_path / "jax"))
    for words in (["load", "a.fit"], ["setcompress", "1", f"-type={kind}",
                                      "16"], ["save", "b"],
                  ["setcompress", "0"], ["save", "c"]):
        JCOMMANDS[words[0]].fn(js, words[1:])
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", "load",
                  "a.fit"])
    cli.commands.cmd_setcompress(ts, ["1", f"-type={kind}", "16"])
    assert ts.compression == kind
    cli.commands.cmd_save(ts, ["b"])
    cli.commands.cmd_setcompress(ts, ["0"])
    cli.commands.cmd_save(ts, ["c"])
    for n in ("b.fit", "c.fit"):
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes()
    assert b"ZIMAGE" in (tmp_path / "port" / "b.fit").read_bytes()[:5760]
    assert b"ZIMAGE" not in (tmp_path / "port" / "c.fit").read_bytes()
    np.testing.assert_array_equal(
        tfio.read_fits(str(tmp_path / "port" / "b.fit")).host(),
        tfio.read_fits(str(tmp_path / "port" / "a.fit")).host())


def test_fz_sequence_scan_stack_round_trip(tmp_path):
    """Four RICE-compressed ``fz_0000k.fit.fz`` frames: scanned (the fz
    flag set, file numbers from the names), stacked through the CLI
    within 2e-6 of the same frames uncompressed and of the JAX package's
    stack of those, and round-tripped through the .seq (the JAX package reads
    the fz flag too)."""
    from siril_tpu.core.sequence import Sequence as JSequence
    from siril_tpu.io.seqfile import read_seqfile as jread
    from siril_tpu.ops import rejection as jrj
    from siril_tpu.ops import stacking as jst
    from siril_tpu.ops.normalization import ADDITIVE_SCALING
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.seqfile import read_seqfile

    rng = np.random.default_rng(60)
    scene = rng.uniform(0.1, 0.5, (1, 30, 36)).astype(np.float32)
    fz, plain = tmp_path / "fz", tmp_path / "plain"
    fz.mkdir()
    plain.mkdir()
    for i in range(4):
        img = SirilImage(data=np.clip(scene + rng.normal(
            0, 0.01, scene.shape), 0, 1).astype(np.float32),
            orig_bitdepth=20)
        img.keywords.exposure = 10.0
        tfio.write_fits(img, str(fz / f"fz_{i + 1:05d}.fit.fz"),
                        compression="rice")
        tfio.write_fits(img, str(plain / f"fz_{i + 1:05d}.fit"))
    seq = Sequence.scan("fz_", str(fz))
    assert seq.fz and seq.number == 4 and list(seq.filenum) == [1, 2, 3, 4]
    assert (seq.nb_layers, seq.ry, seq.rx) == (1, 30, 36)
    words = ["stack", "fz_", "rej", "s", "3", "3", "-norm=addscale",
             "-out=out"]
    a = cli.run(["-d", str(fz), "--device", "cpu", *words]).image.host()
    b = cli.run(["-d", str(plain), "--device", "cpu", *words]).image.host()
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    jres = jst.stack_sequence(
        JSequence.scan("fz_", str(plain)),
        jst.StackArgs(method="rej", rejection=jrj.SIGMA,
                      normalize=ADDITIVE_SCALING))
    np.testing.assert_allclose(a, jres.image.host(), rtol=0, atol=2e-6)
    seq.save()
    text = open(fz / "fz_.seq").read()
    assert "S 'fz_' 1 4 4 5 -1 7 0 1 0" in text
    back = read_seqfile(str(fz / "fz_.seq"))
    assert back.fz and all(f.endswith(".fit.fz") for f in back._file_list)
    np.testing.assert_array_equal(back.read_frame(2).host(),
                                  seq.read_frame(2).host())
    assert jread(str(fz / "fz_.seq")).fz
    shutil.rmtree(plain)
