"""Parity of the port's drizzle (``siril_tpu_torch/ops/drizzle.py`` and the
drizzle commands) with ``siril_tpu.ops.drizzle`` on the CPU, on the same
frames made from a seed with numpy.

Tolerances, each with its reason:
- output and weight map within 2e-6: the same float32 operations in the
  same order, XLA:CPU's fused ``acc + w·v`` reproduced; the lanczos and
  Gaussian weights go through another sin / exp (5.4e-7 measured);
- the point kernel bit-equal, ties included: at scale 2 on an identity H
  half of the samples land on .5, where ``round`` (half to even) and the
  strict ``|sx − cx| < 0.5`` decide whole taps;
- ``drizzle_sequence`` against the port's own per-frame path within 2e-5,
  as the JAX package holds its two paths (tests/test_drizzle.py): they
  invert S·H in different precisions;
- the registration of ``register -drizzle`` within 0.01 px at the frame
  corners (tests/test_torch_registration.py), and its drizzled frames
  within 2e-6 of the JAX package's accumulator on the port's H;
- ``stack -upscale`` within one 16-bit step: the lanczos4 resample
  agrees to ~1e-7, but the upscaled frames are written at the source's
  16 bits, where a value at a rounding boundary lands on the next step
  (each frame is held within that step).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from siril_tpu.cli.commands import COMMANDS as JCOMMANDS
from siril_tpu.cli.context import Session as JSession
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import drizzle as jd
from siril_tpu_torch import cli
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.io.fits_io import read_fits, write_fits
from siril_tpu_torch.io.seqfile import read_seqfile
from siril_tpu_torch.ops import drizzle as td

torch.set_num_threads(1)

H_IN, W_IN = 24, 32
TOL = 2e-6


def _shift(dx, dy):
    H = np.eye(3)
    H[:2, 2] = dx, dy
    return H


def _turn(deg, dx, dy):
    t = np.deg2rad(deg)
    return np.array([[np.cos(t), -np.sin(t), dx], [np.sin(t), np.cos(t), dy],
                     [0.0, 0.0, 1.0]])


#: dithered shifts and a turned frame
HS = [_shift(0, 0), _shift(0.37, -0.62), _turn(1.3, 0.3, -0.7)]


def _pair(data, cfa):
    a, b = JImage(data=data.copy()), SirilImage(data=data.copy())
    if cfa:
        a.keywords.bayer_pattern = b.keywords.bayer_pattern = "RGGB"
    return a, b


def _close(jpair, tpair, tol=TOL):
    for a, b in zip(jpair, tpair):
        np.testing.assert_allclose(b.host(), a.host(), rtol=0, atol=tol)


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("kernel", sorted(td.KERNEL_NAMES.values()))
def test_accumulator_vs_jax(kernel, scale):
    """``add_frame`` of each kernel, mono and CFA, pixfrac 1.0 and 0.8,
    with input weights, over dithered and turned frames."""
    assert td.KERNEL_NAMES == jd.KERNEL_NAMES
    rng = np.random.default_rng(10 + kernel)
    wp = rng.uniform(0.8, 1.2, (H_IN, W_IN)).astype(np.float32)
    for cfa in (False, True):
        for pf in (1.0, 0.8):
            shape = (3 if cfa else 1, int(H_IN * scale), int(W_IN * scale))
            args = dict(scale=scale, pixfrac=pf, kernel=kernel,
                        use_bayer=cfa)
            ja = jd.DrizzleAccumulator(shape, jd.DrizzleArgs(**args))
            ta = td.DrizzleAccumulator(shape, td.DrizzleArgs(**args), "cpu")
            for k, H in enumerate(HS):
                data = rng.uniform(0.05, 0.9, (1, H_IN, W_IN)).astype(
                    np.float32)
                a, b = _pair(data, cfa)
                ja.add_frame(a, H, weight=0.7 if k == 1 else 1.0,
                             weight_plane=wp)
                ta.add_frame(b, H, weight=0.7 if k == 1 else 1.0,
                             weight_plane=wp)
            _close(ja.finalize(), ta.finalize())


def test_taps_vs_jax():
    for kernel in range(6):
        for pf in (0.5, 0.8, 1.0):
            for inv in (1.0, 0.5, 1 / 3):
                assert td._taps_for(kernel, pf, inv) == \
                    jd._taps_for(kernel, pf, inv)


@pytest.mark.parametrize("shift", [(0, 0), (0.25, -0.25), (0.5, 0.5),
                                   (-0.5, 0.75)])
def test_point_kernel_ties(shift):
    """Scale 2, point kernel: bit-equal to the JAX package.  On the
    identity H every odd output row and column samples an input pixel
    edge (.5), which no tap takes, so those pixels get no weight."""
    rng = np.random.default_rng(3)
    data = rng.uniform(0.1, 0.9, (1, 16, 20)).astype(np.float32)
    args = dict(scale=2.0, kernel=td.KERNEL_POINT)
    ja = jd.DrizzleAccumulator((1, 32, 40), jd.DrizzleArgs(**args))
    ta = td.DrizzleAccumulator((1, 32, 40), td.DrizzleArgs(**args), "cpu")
    a, b = _pair(data, False)
    ja.add_frame(a, _shift(*shift))
    ta.add_frame(b, _shift(*shift))
    (jo, jw), (to, tw) = ja.finalize(), ta.finalize()
    np.testing.assert_array_equal(to.host(), jo.host())
    np.testing.assert_array_equal(tw.host(), jw.host())
    if shift == (0, 0):
        w = tw.host()[0]
        assert (w[::2, ::2] == 1).all() and (w[1::2] == 0).all() and \
            (w[:, 1::2] == 0).all()
        np.testing.assert_array_equal(to.host()[0][::2, ::2], data[0])


@pytest.mark.parametrize("cfa", [False, True])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_add_frames_vs_jax(dtype, cfa):
    """The chunk path: i16 frames decoded as (x + 32768) / 65535, or
    float32; three frames with their own weights and a weight plane;
    three channels drizzled apart, or one CFA mosaic to three planes."""
    rng = np.random.default_rng(20)
    L = 1 if cfa else 3
    if dtype == np.int16:
        frames = rng.integers(-30000, 30000, (3, L, H_IN, W_IN)).astype(
            np.int16)
    else:
        frames = rng.uniform(0.05, 0.9, (3, L, H_IN, W_IN)).astype(
            np.float32)
    wp = rng.uniform(0.8, 1.2, (H_IN, W_IN)).astype(np.float32)
    kw = dict(weights=[1.0, 0.8, 1.2], weight_plane=wp,
              pattern="GBRG" if cfa else None)
    args = dict(scale=2.0, pixfrac=0.8, use_bayer=cfa)
    shape = (3, 2 * H_IN, 2 * W_IN)
    ja = jd.DrizzleAccumulator(shape, jd.DrizzleArgs(**args))
    ta = td.DrizzleAccumulator(shape, td.DrizzleArgs(**args), "cpu")
    ja.add_frames(frames, np.stack(HS), **kw)
    ta.add_frames(torch.from_numpy(frames), np.stack(HS), **kw)
    assert ta.nframes == ja.nframes == 3
    _close(ja.finalize(), ta.finalize())


def test_bands_do_not_change_the_result(monkeypatch):
    rng = np.random.default_rng(4)
    data = rng.uniform(0.1, 0.9, (1, H_IN, W_IN)).astype(np.float32)
    outs = []
    for band in (64 << 20, 3 * 2 * W_IN * 5):
        monkeypatch.setattr(td.DrizzleAccumulator, "BAND_ELEMS", band)
        acc = td.DrizzleAccumulator((3, 2 * H_IN, 2 * W_IN),
                                    td.DrizzleArgs(use_bayer=True), "cpu")
        img = SirilImage(data=data)
        img.keywords.bayer_pattern = "RGGB"
        for H in HS:
            acc.add_frame(img, H)
        outs.append([x.host() for x in acc.finalize()])
    assert len(acc.bands) > 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _cfa_seq(d, n=5, bitdepth=16, seed=5, name="dc_"):
    """``n`` RGGB frames with sub-pixel registration data in the .seq, for
    both packages (the same files)."""
    from siril_tpu.io.seqfile import read_seqfile as jread

    rng = np.random.default_rng(seed)
    for i in range(n):
        img = SirilImage(data=rng.uniform(0.1, 0.6, (1, H_IN, W_IN)).astype(
            np.float32))
        img.keywords.bayer_pattern = "RGGB"
        write_fits(img, os.path.join(d, f"{name}{i + 1:05d}.fit"),
                   bitdepth=bitdepth)
    ctx = cli.run(["-d", d, "--device", "cpu", "setext", "fit"])
    seq = ctx.load_sequence(name)
    reg = seq.reg(0)
    for k in range(n):
        reg.H[k] = _turn(0.2 * k, 0.3 * k, -0.2 * k)
        reg.valid[k] = True
    seq.save()
    return jread(os.path.join(d, name + ".seq")), read_seqfile(
        os.path.join(d, name + ".seq"))


@pytest.mark.parametrize("bitdepth", [16, -32])
def test_drizzle_sequence_vs_jax(tmp_path, bitdepth):
    """The chunk path with one chunk read ahead (the u16 frames decoded on
    the device, or float32), against the JAX package's
    ``drizzle_sequence`` and against the port's per-frame path."""
    jseq, tseq = _cfa_seq(str(tmp_path), bitdepth=bitdepth)
    args = dict(scale=2.0, pixfrac=0.8, use_bayer=True)
    jo = jd.drizzle_sequence(jseq, jd.DrizzleArgs(**args), frame_chunk=2)
    stages = {}
    to = td.drizzle_sequence(tseq, td.DrizzleArgs(**args), frame_chunk=2,
                             device="cpu", stages=stages)
    _close(jo, to)
    assert {"read", "upload", "drizzle", "fetch"} <= set(stages)
    ref = td.DrizzleAccumulator((3, 2 * H_IN, 2 * W_IN),
                                td.DrizzleArgs(**args), "cpu")
    for k in range(5):
        ref.add_frame(tseq.read_frame(k), tseq.reg(0).H[k])
    _close(ref.finalize(), to, tol=2e-5)


def _run_jax(d, words, sf_radius=None):
    js = JSession(cwd=d)
    if sf_radius:
        js.prefs.sf_radius = sf_radius
    JCOMMANDS[words[0]].fn(js, words[1:])
    return js


@pytest.mark.parametrize("cfa", [False, True])
def test_stack_drizzle_cli_vs_jax(tmp_path, cfa):
    """``stack seq -drizzle -scale=2 -pixfrac=0.8 -kernel=turbo``: one
    float32 image, three layers from a CFA sequence."""
    src = tmp_path / "src"
    src.mkdir()
    _cfa_seq(str(src), n=4)
    if not cfa:
        for f in src.iterdir():
            if f.suffix == ".fit":
                img = read_fits(str(f))
                img.keywords.bayer_pattern = ""
                write_fits(img, str(f))
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    words = ["stack", "dc_", "-drizzle", "-scale=2", "-pixfrac=0.8",
             "-kernel=turbo", "-out=drz"]
    _run_jax(str(tmp_path / "jax"), words)
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", *words])
    a, b = (read_fits(str(tmp_path / d / "drz.fit"))
            for d in ("jax", "port"))
    assert a.nchans == b.nchans == (3 if cfa else 1)
    assert b.orig_bitdepth == a.orig_bitdepth == -32
    np.testing.assert_allclose(b.host(), a.host(), rtol=0, atol=TOL)
    assert ts.image.data.shape == (b.nchans, 2 * H_IN, 2 * W_IN)
    assert "drizzle" in ts.stages


@pytest.mark.parametrize("flat", [False, True])
def test_seqapplyreg_drizzle_vs_jax(tmp_path, flat):
    """``seqapplyreg -drizzle``: a per-frame drizzled float32 sequence
    (tests/test_drizzle.py:140); with ``-flat=`` the master flat's first
    layer is each frame's weight plane."""
    src = tmp_path / "src"
    src.mkdir()
    _cfa_seq(str(src), n=3)
    words = ["seqapplyreg", "dc_", "-drizzle", "-scale=1", "-pixfrac=0.8"]
    if flat:
        rng = np.random.default_rng(8)
        write_fits(SirilImage(data=rng.uniform(0.5, 1.0, (1, H_IN, W_IN))
                              .astype(np.float32)), str(src / "flat.fit"),
                   bitdepth=-32)
        words.append("-flat=flat")
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    _run_jax(str(tmp_path / "jax"), words)
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", *words])
    assert ts.sequence.name == "r_dc_" and ts.sequence.number == 3
    names = sorted(f for f in os.listdir(tmp_path / "jax")
                   if f.startswith("r_"))
    assert sorted(f for f in os.listdir(tmp_path / "port")
                  if f.startswith("r_")) == names
    for n in names:
        if not n.endswith(".fit"):
            continue
        a, b = (read_fits(str(tmp_path / d / n)) for d in ("jax", "port"))
        assert a.nchans == b.nchans == 3
        assert b.orig_bitdepth == a.orig_bitdepth == -32
        np.testing.assert_allclose(b.host(), a.host(), rtol=0, atol=TOL)
    seq = read_seqfile(str(tmp_path / "port" / "r_dc_.seq"))
    assert seq.number == 3 and seq.nb_layers == 3


def test_register_drizzle_vs_jax(tmp_path, monkeypatch):
    """``register -drizzle``: the transforms of the raw frames (no warp),
    then each frame drizzled at scale 1.  H within 0.01 px of the JAX
    package's at the corners; each drizzled frame within 2e-6 of the JAX
    package's accumulator given the H the port drizzled it with (the
    .seq keeps H to six digits)."""
    from tests.test_torch_registration import _corners, _reg_seqs

    src = tmp_path / "src"
    src.mkdir()
    _reg_seqs(src, np.random.default_rng(44))
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    words = ["register", "g_", "-drizzle", "-scale=1", "-pixfrac=0.9",
             "-transf=shift", "-nostarlist"]
    js = _run_jax(str(tmp_path / "jax"), words, sf_radius=6)
    ctx = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu",
                   "setfindstar", "-radius=6"])
    used = []
    real = td.DrizzleAccumulator.add_frame

    def spy(self, img, H, **kw):
        used.append(np.array(H))
        return real(self, img, H, **kw)

    monkeypatch.setattr(td.DrizzleAccumulator, "add_frame", spy)
    cli.commands.cmd_register(ctx, words[1:])
    assert js.seq.name == ctx.sequence.name == "r_g_"
    jH = read_seqfile(str(tmp_path / "jax" / "g_.seq")).reg(0).H
    tseq = read_seqfile(str(tmp_path / "port" / "g_.seq"))
    for k in range(4):
        np.testing.assert_allclose(_corners(tseq.reg(0).H[k]),
                                   _corners(jH[k]), rtol=0, atol=0.01)
    args = jd.DrizzleArgs(scale=1.0, pixfrac=0.9)
    assert len(used) == 4
    for k in range(4):
        np.testing.assert_allclose(used[k], tseq.reg(0).H[k], rtol=1e-5,
                                   atol=1e-6)
        acc = jd.DrizzleAccumulator((1, 128, 144), args)
        acc.add_frame(JImage(data=tseq.read_frame(k).host()), used[k])
        want = acc.finalize(want_weight=False)[0].host()
        got = read_fits(str(tmp_path / "port" / f"r_g_{k + 1:05d}.fit"))
        assert got.orig_bitdepth == -32
        np.testing.assert_allclose(got.host(), want, rtol=0, atol=TOL)
    assert {"detect", "drizzle", "write"} <= set(ctx.stages)


@pytest.mark.parametrize("select", [False, True])
def test_stack_upscale_vs_jax(tmp_path, select):
    """``stack -upscale`` (tests/test_stacking.py:239): the frames
    resampled ×2 into ``upscaled_``, their registration the source's
    with the translation doubled, then stacked; with a selection in the
    .seq, only the selected frames, in order."""
    from siril_tpu.io.seqfile import read_seqfile as jread

    rng = np.random.default_rng(22)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        write_fits(SirilImage(data=rng.uniform(0.2, 0.4, (1, 40, 48))
                              .astype(np.float32)),
                   str(src / f"mx_{i + 1:05d}.fit"), bitdepth=16)
    ctx = cli.run(["-d", str(src), "--device", "cpu", "setext", "fit"])
    seq = ctx.load_sequence("mx_")
    reg = seq.reg(0)
    for k, (dx, dy) in enumerate([(0, 0), (6, 0), (0, -4)]):
        reg.H[k] = _shift(dx, dy)
        reg.valid[k] = True
    if select:
        seq.incl[1] = False
    seq.save()
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
    words = ["stack", "mx_", "rej", "s", "3", "3", "-upscale", "-out=up2"]
    _run_jax(str(tmp_path / "jax"), words)
    ts = cli.run(["-d", str(tmp_path / "port"), "--device", "cpu", *words])
    assert ts.image.data.shape == (1, 80, 96)
    a, b = (read_fits(str(tmp_path / d / "up2.fit")).host()
            for d in ("jax", "port"))
    np.testing.assert_allclose(b, a, rtol=0, atol=1.0 / 65535 + 1e-6)
    ju = jread(str(tmp_path / "jax" / "upscaled_mx_.seq"))
    tu = read_seqfile(str(tmp_path / "port" / "upscaled_mx_.seq"))
    assert tu.number == ju.number == (2 if select else 3)
    np.testing.assert_array_equal(tu.reg(0).H, ju.reg(0).H)
    for k in range(tu.number):
        np.testing.assert_allclose(
            read_fits(tu._file_list[k]).host(),
            read_fits(ju._file_list[k]).host(), rtol=0,
            atol=1.0 / 65535 + 1e-7)
