"""Parity: the port's CFA extraction (``siril_tpu_torch/ops/extraction.py``)
and its commands (``load``, ``save``, ``split_cfa``, ``extract_Ha``,
``extract_Green``, ``extract_HaOIII``, ``merge_cfa`` and the sequence
forms ``seqsplit_cfa``, ``seqextract_*``, ``seqmerge_cfa``) against the
JAX package's commands, on copies of the same files, on the CPU.

Every extraction and merge is bit-equal: both are the same numpy slices
and means on the host.  ``seqextract_Ha -upscale`` resamples ×2 with the
gather warp (lanczos4 with the clamp; ``ops/interp.resize``), held within
2e-6 as tests/test_torch_interp.py holds that warp (float32 frames, so
that no 16-bit rounding comes between).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from siril_tpu.cli.commands import COMMANDS as JCOMMANDS
from siril_tpu.cli.context import Session as JSession
from siril_tpu_torch import cli
from siril_tpu_torch.cli.context import Session
from siril_tpu_torch.core.image import FLOAT_IMG, USHORT_IMG, SirilImage
from siril_tpu_torch.io.fits_io import read_fits, write_fits
from siril_tpu_torch.ops import extraction

torch.set_num_threads(1)


def _cfa_file(path, rng, pattern, h=24, w=30, bitdepth=USHORT_IMG):
    img = SirilImage(data=rng.random((1, h, w)).astype(np.float32),
                     orig_bitdepth=bitdepth)
    img.keywords.bayer_pattern = pattern
    img.keywords.exposure = 30.0
    write_fits(img, str(path), bitdepth=bitdepth)


def _dirs(tmp_path, make):
    src = tmp_path / "src"
    src.mkdir()
    make(src)
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    return tmp_path / "jax", tmp_path / "port"


def _run(jdir, tdir, lines):
    js = JSession(cwd=str(jdir))
    ts = Session(cwd=str(tdir), device="cpu")
    for line in lines:
        words = line.split()
        JCOMMANDS[words[0].lower()].fn(js, words[1:])
        cli.COMMANDS[words[0].lower()].fn(ts, words[1:])
    return js, ts


def _same_files(jdir, tdir, atol=0.0):
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".fit"))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith(".fit"))
    for n in names:
        a, b = read_fits(str(jdir / n)), read_fits(str(tdir / n))
        assert a.data.shape == b.data.shape, n
        assert a.orig_bitdepth == b.orig_bitdepth, n
        assert (a.keywords.bayer_pattern, a.keywords.filter) == \
            (b.keywords.bayer_pattern, b.keywords.filter), n
        if atol:
            np.testing.assert_allclose(b.data, a.data, rtol=0, atol=atol,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(b.data, a.data, err_msg=n)
    return names


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG"])
def test_single_image_commands_vs_jax(tmp_path, pattern):
    jdir, tdir = _dirs(tmp_path, lambda d: _cfa_file(
        d / "img.fit", np.random.default_rng(1), pattern))
    js, ts = _run(jdir, tdir, [
        "load img", "split_cfa", "extract_HaOIII", "load img.fit",
        "extract_Green", "save green_copy", "load img",
        "extract_HaOIII -resample=ha", "load img", "extract_Ha",
        "merge_cfa CFA0_img.fit CFA1_img.fit CFA2_img.fit CFA3_img.fit "
        f"{pattern}", "save merged", "load img", "extract_Ha -upscale"])
    names = _same_files(jdir, tdir)
    assert {"CFA0_img.fit", "Ha_img.fit", "OIII_img.fit", "Green_img.fit",
            "green_copy.fit", "merged.fit"} <= set(names)
    merged = read_fits(str(tdir / "merged.fit"))
    np.testing.assert_array_equal(merged.data,
                                  read_fits(str(tdir / "img.fit")).data)
    assert merged.keywords.bayer_pattern == pattern
    assert ts.image_name == js.image_name == "Ha_img"
    np.testing.assert_array_equal(ts.image.data, js.image.host())
    assert ts.image.data.shape == (1, 24, 30)          # -upscale: ×2


def test_functions_vs_jax():
    """The functions on one image: sites, keywords and history."""
    from siril_tpu.core.image import SirilImage as JImage
    from siril_tpu.ops import extraction as jext

    rng = np.random.default_rng(2)
    data = rng.random((1, 11, 13)).astype(np.float32)      # odd sizes
    jimg, img = JImage(data=data.copy()), SirilImage(data=data.copy())
    jimg.keywords.bayer_pattern = img.keywords.bayer_pattern = "BGGR"
    pairs = [(jext.split_cfa(jimg), extraction.split_cfa(img)),
             (jext.extract_ha_oiii(jimg), extraction.extract_ha_oiii(img)),
             (jext.extract_ha_oiii(jimg, "ha"),
              extraction.extract_ha_oiii(img, "ha")),
             ([jext.extract_ha(jimg, True)], [extraction.extract_ha(img,
                                                                    True)]),
             ([jext.extract_green(jimg)], [extraction.extract_green(img)])]
    for want, got in pairs:
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.data, a.host())
            assert (b.keywords.filter, b.keywords.bayer_pattern,
                    b.history) == (a.keywords.filter,
                                   a.keywords.bayer_pattern, a.history)
    np.testing.assert_array_equal(
        extraction.extract_channel_sites(img, "G"),
        jext.extract_channel_sites(jimg, "G"))
    with pytest.raises(ValueError, match="4 images"):
        extraction.merge_cfa([img], "RGGB")


def test_sequence_commands_vs_jax(tmp_path):
    """seqsplit_cfa, seqextract_Green, seqextract_HaOIII and seqmerge_cfa
    of the split sequences (16-bit frames, bit-equal), then seqextract_Ha
    -upscale on float32 frames (the gather warp, 2e-6)."""
    rng = np.random.default_rng(3)

    def make(d):
        for i in range(3):
            _cfa_file(d / f"c_{i + 1:05d}.fit", rng, "GRBG")
            _cfa_file(d / f"f_{i + 1:05d}.fit", rng, "RGGB", h=20, w=16,
                      bitdepth=FLOAT_IMG)

    jdir, tdir = _dirs(tmp_path, make)
    _run(jdir, tdir, [
        "seqsplit_cfa c_", "seqextract_Green c_", "seqextract_HaOIII c_",
        "seqmerge_cfa CFA_0_c_ CFA_1_c_ CFA_2_c_ CFA_3_c_ GRBG"])
    names = _same_files(jdir, tdir)
    assert {"CFA_3_c_00002.fit", "Green_c_00003.fit", "Ha_c_00001.fit",
            "OIII_c_00001.fit", "mCFA_00003.fit"} <= set(names)
    for i in range(3):
        merged = read_fits(str(tdir / f"mCFA_{i + 1:05d}.fit"))
        np.testing.assert_array_equal(
            merged.data, read_fits(str(tdir / f"c_{i + 1:05d}.fit")).data)
    assert open(tdir / "mCFA.seq").read() == open(jdir / "mCFA.seq").read()
    for d in (jdir, tdir):
        for f in os.listdir(d):
            if not f.startswith("f_"):
                os.unlink(d / f)
    _run(jdir, tdir, ["seqextract_Ha f_ -upscale"])
    names = _same_files(jdir, tdir, atol=2e-6)
    assert read_fits(str(tdir / "Ha_f_00001.fit")).data.shape == (1, 20, 16)
