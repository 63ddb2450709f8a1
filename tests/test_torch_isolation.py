"""Isolation and device rules of the port (``siril_tpu_torch``):

- importing the package, every submodule and ``chip_smoke`` (without
  running it) loads no ``jax*`` and nothing of ``siril_tpu``;
- entry points run on CUDA by default and raise without a card; the CPU is
  used only when asked for;
- the kernel module imports without nvcc;
- ``convert`` carries the JAX package's configuration (calibration
  arguments and masters, registration arguments) and per-frame state
  (registration data) across and back unchanged.
"""

import dataclasses
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import siril_tpu_torch
from siril_tpu_torch import convert
from siril_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        siril_tpu_torch.__path__, "siril_tpu_torch.")
        if not m.name.endswith("__main__"))


def test_imports_nothing_of_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'siril_tpu' or "
        "m.startswith('siril_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = ("import shutil\n"
            "assert shutil.which('nvcc') is None\n"
            "import siril_tpu_torch.kernels.reject_stack as k\n"
            "assert sum(k.launches.values()) == 0\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.pipeline import fused_preprocess_stack

    with pytest.raises(RuntimeError, match="CUDA"):
        fused_preprocess_stack(Sequence("none"))
    from siril_tpu_torch.ops.stacking import StackArgs, stack_sequence

    with pytest.raises(RuntimeError, match="CUDA"):
        stack_sequence(Sequence("none"), StackArgs())
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        compute_normalization,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        compute_normalization(Sequence("none"), np.arange(2),
                              ADDITIVE_SCALING)
    # the entry points of the preprocessing commands and the script runner
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.cli.parser import execute_script
    from siril_tpu_torch.ops.calibration import CalibArgs, calibrate_sequence
    from siril_tpu_torch.registration.global_reg import (
        apply_reg_sequence,
        register_sequence,
    )

    for call in (lambda: calibrate_sequence(Sequence("none"), CalibArgs()),
                 lambda: register_sequence(Sequence("none")),
                 lambda: apply_reg_sequence(Sequence("none")),
                 lambda: execute_script(Session(), "none.ssf")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the OSC entry points: demosaicing, X-Trans, resampling, convert
    # -debayer
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.conversion import convert_to_sequence
    from siril_tpu_torch.ops.demosaic import debayer_image
    from siril_tpu_torch.ops.geometry import resample
    from siril_tpu_torch.ops.xtrans import (
        XTRANS_PATTERNS,
        demosaic_xtrans_image,
    )

    cfa = SirilImage(data=np.zeros((1, 12, 12), np.float32))
    cfa.keywords.bayer_pattern = "RGGB"
    xt = SirilImage(data=np.zeros((1, 12, 12), np.float32))
    xt.keywords.bayer_pattern = XTRANS_PATTERNS[0]
    for call in (lambda: debayer_image(cfa),
                 lambda: demosaic_xtrans_image(xt),
                 lambda: resample(cfa, 24, 24)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    src = tmp_path / "cfa.fit"
    from siril_tpu_torch.io.fits_io import write_fits

    write_fits(cfa, str(src))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_to_sequence([str(src)], "c", str(tmp_path / "out"),
                            debayer=True)


def test_image_ops_default_to_cuda(monkeypatch, tmp_path):
    """The image ops of the post-stack session (the stretches, the colour
    ops, the geometry, subsky, pcc / spcc / bgneutralize and their
    commands) run on CUDA unless asked for the CPU, and raise without a
    card; the new modules are among those imported without JAX above."""
    names = set(_port_modules())
    for m in ("ops.stretch", "ops.colors", "ops.background",
              "ops.photometry", "astrometry.pcc", "astrometry.spcc",
              "astrometry.xp_spectra", "astrometry.compstars"):
        assert f"siril_tpu_torch.{m}" in names
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from siril_tpu_torch.astrometry.pcc import background_neutralization
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops import background, colors, geometry, stretch

    img = SirilImage(data=np.full((3, 16, 16), 0.2, np.float32))
    for call in (lambda: stretch.autostretch(img),
                 lambda: stretch.apply_ght(img, stretch.GHTParams()),
                 lambda: stretch.asinh_stretch(img, 3.0),
                 lambda: colors.scnr(img), lambda: colors.negative(img),
                 lambda: colors.saturation(img, 0.5),
                 lambda: colors.apply_ccm(img, np.eye(3)),
                 lambda: geometry.crop(img, 0, 0, 8, 8),
                 lambda: geometry.rotate(img, 10.0),
                 lambda: geometry.binxy(img, 2),
                 lambda: background.extract_background(img),
                 lambda: background_neutralization(img)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for words in (["neg"], ["mirrorx"], ["autostretch"], ["rmgreen"]):
        s = Session(cwd=str(tmp_path))
        s.set_image(img, "x")
        with pytest.raises(RuntimeError, match="CUDA"):
            COMMANDS[words[0]].fn(s, words[1:])
    out = colors.negative(img, device="cpu")
    assert np.array_equal(out.data, 1.0 - img.data)


def test_convert_round_trips():
    from siril_tpu.ops.normalization import NormCoeffs
    from siril_tpu.ops.stacking import StackArgs
    from siril_tpu.pipeline import FusedArgs
    from siril_tpu.registration.starfinder import StarFinderParams

    for jax_obj, fn in ((FusedArgs(), convert.fused_args),
                        (StackArgs(normalize=3, siglow=2.5), convert.stack_args),
                        (StarFinderParams(radius=6), convert.starfinder_params)):
        d = dataclasses.asdict(jax_obj)
        assert dataclasses.asdict(fn(d)) == d
    rng = np.random.default_rng(0)
    nc = NormCoeffs(rng.random((1, 5)), rng.random((1, 5)), rng.random((1, 5)))
    got = convert.norm_coeffs(nc.offset, nc.mul, nc.scale)
    for k in ("offset", "mul", "scale"):
        np.testing.assert_array_equal(getattr(got, k), getattr(nc, k))
    H = np.tile(np.eye(3), (4, 1, 1))
    np.testing.assert_array_equal(convert.homographies(H), H)
    from siril_tpu.ops.rejection import gesdt_critical_values

    lam = gesdt_critical_values(12, 0.05, 3)
    np.testing.assert_array_equal(convert.gesdt_table(lam).numpy(), lam)
    with pytest.raises(ValueError):
        convert.stack_args({"no_such_field": 1})

    # calibration arguments (and masters), registration arguments
    from siril_tpu.core.image import SirilImage
    from siril_tpu.ops.calibration import CalibArgs
    from siril_tpu.registration.global_reg import RegArgs

    for jax_obj, fn in ((CalibArgs(bias_level=0.03, use_dark_optim=True,
                                   sig_cold=2.0, is_cfa=True,
                                   prefix="c_"), convert.calib_args),
                        (RegArgs(ttype=2, two_pass=True, min_pairs=7,
                                 starfinder=StarFinderParams(sigma=0.7)),
                         convert.reg_args)):
        d = dataclasses.asdict(jax_obj)
        assert dataclasses.asdict(fn(d)) == d
    dark = SirilImage(data=rng.random((1, 6, 8)).astype(np.float32),
                      orig_bitdepth=20)
    dark.keywords.exposure = 30.0
    dark.history.append("stacked")
    ca = CalibArgs(dark=dark, use_cosmetic=False)
    got = convert.calib_args(dataclasses.asdict(ca))
    np.testing.assert_array_equal(got.dark.data, dark.data)
    assert (got.dark.orig_bitdepth, got.dark.keywords.exposure,
            got.dark.history) == (20, 30.0, ["stacked"])
    back = dataclasses.asdict(got)
    np.testing.assert_array_equal(back["dark"]["data"], dark.data)
    assert {k: v for k, v in back.items() if k != "dark"} == \
        {k: v for k, v in dataclasses.asdict(ca).items() if k != "dark"}
    fa = convert.fused_args(dataclasses.asdict(FusedArgs(calib=ca)))
    np.testing.assert_array_equal(fa.calib.dark.data, dark.data)
    # a sequence's registration data
    from siril_tpu.core.sequence import RegData

    rd = RegData(5)
    rd.H[:] = rng.normal(size=(5, 3, 3))
    rd.fwhm[:] = rng.random(5)
    rd.number_of_stars[:] = [3, 5, 8, 13, 21]
    rd.valid[[0, 2]] = True
    d = dataclasses.asdict(rd)
    got = convert.reg_data(d)
    back = dataclasses.asdict(got)
    assert sorted(back) == sorted(d)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype


def test_drizzle_and_formats_need_a_card(monkeypatch, tmp_path):
    """The drizzle entry points (the accumulator, ``drizzle_sequence``,
    ``stack -drizzle`` and ``-upscale``, ``register`` / ``seqapplyreg
    -drizzle``) raise without a card unless the CPU is asked for; the
    format modules (SER, FITS cubes, tiled compression) are host code."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from siril_tpu_torch import cli
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.drizzle import (
        DrizzleAccumulator,
        drizzle_sequence,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        DrizzleAccumulator((1, 8, 8))
    for i in range(2):
        write_fits(SirilImage(data=np.full((1, 8, 8), 0.5, np.float32)),
                   str(tmp_path / f"d_{i + 1:05d}.fit"))
    seq = Sequence.scan("d_", str(tmp_path))
    seq.reg(0).valid[:] = True
    seq.save()
    with pytest.raises(RuntimeError, match="CUDA"):
        drizzle_sequence(seq)
    for words in (["stack", "d_", "-drizzle"],
                  ["stack", "d_", "rej", "-upscale"],
                  ["seqapplyreg", "d_", "-drizzle"],
                  ["register", "d_", "-drizzle"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.run(["-d", str(tmp_path), *words])
    assert DrizzleAccumulator((1, 8, 8), device="cpu").acc.device.type == \
        "cpu"


def test_astrometry_entry_points_need_a_card(monkeypatch, tmp_path):
    """The plate solver (its star detection) and the platesolve commands
    raise without a card unless the CPU is asked for; the WCS, the
    catalogues, the astrometric registration, the 3-star follow and the
    AVI reader are host code and run without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from siril_tpu_torch import cli
    from siril_tpu_torch.astrometry.catalog import Catalog
    from siril_tpu_torch.astrometry.solver import SolveArgs, solve_image
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.avi import AviReader, AviWriter
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.wcs import WCS

    img = SirilImage(data=np.full((1, 16, 16), 0.1, np.float32))
    cat = Catalog(ra=np.zeros(1), dec=np.zeros(1), mag=np.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_image(img, cat, SolveArgs(ra=0.0, dec=0.0, pixel_scale=1.0))
    assert solve_image(img, cat, SolveArgs(ra=0.0, dec=0.0,
                                           pixel_scale=1.0),
                       device="cpu") is None
    cat.save(str(tmp_path / "c.npz"))
    write_fits(img, str(tmp_path / "f_00001.fit"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["-d", str(tmp_path), "seqplatesolve", "f_", "0", "0",
                 "-catalog=c.npz", "-focal=1000", "-pixelsize=5"])
    w = WCS(crpix=(8.5, 8.5), crval=(10.0, 20.0), height=16)
    assert np.isfinite(w.pix2world(np.ones(2), np.ones(2))).all()
    av = AviWriter(str(tmp_path / "a.avi"), 16, 16, color=False)
    av.add_frame(img)
    av.close()
    assert AviReader(str(tmp_path / "a.avi")).read_frame(0).nchans == 1


ENHANCE_MODULES = ("filters", "wavelets", "deconvolution", "blind_deconv",
                   "nlbayes", "da3d", "pixelmath", "arithmetic", "curves",
                   "masks")


def test_enhance_modules_run_with_jax_blocked():
    """The ten modules of the enhancement session and the command table
    import and run (on the CPU, a 40² image through each) in a process
    where importing ``jax`` or ``siril_tpu`` raises, so that no call
    reaches either lazily."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'siril_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from siril_tpu_torch.cli.commands import COMMANDS\n"
        "from siril_tpu_torch.cli.context import Session\n"
        "from siril_tpu_torch.core.image import SirilImage\n"
        f"for m in {ENHANCE_MODULES!r}:\n"
        "    __import__('siril_tpu_torch.ops.' + m)\n"
        "rng = np.random.default_rng(0)\n"
        "img = SirilImage(data=(0.1 + 0.05 * rng.random((3, 40, 40)))"
        ".astype(np.float32))\n"
        "s = Session(device='cpu')\n"
        "s.set_image(img, 'x')\n"
        "for line in ('gauss 1', 'unsharp 1 1.5', 'fmedian 3 1', "
        "'clahe 2 4', 'epf', 'epf -guided', 'ddp 0.05 0.3 1', "
        "'rgradient 20 20 2 3', 'unpurple', 'wavelet 3', 'wrecons 1 1 1', "
        "'denoise -da3d', 'makepsf manual -ks=9', 'rl -iters=2', "
        "'wiener', 'sb -iters=2', 'fmul 1.1', 'pm \"$T * 0.9\"', "
        "'mask_from_lum', 'mask_blur 1', 'mask_autostretch', "
        "'clear_mask'):\n"
        "    w = line.split(' ', 1)\n"
        "    args = [a.strip('\"') for a in w[1].split(' ')] "
        "if len(w) > 1 and not w[1].startswith('\"') else "
        "([w[1].strip('\"')] if len(w) > 1 else [])\n"
        "    COMMANDS[w[0]].fn(s, args)\n"
        "from siril_tpu_torch.ops import blind_deconv\n"
        "blind_deconv.estimate_kernel_blind(rng.random((64, 64))"
        ".astype(np.float32), 7, 'si', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'siril_tpu')]\n"
        "print('ok' if not bad and s.image.data.shape == (3, 40, 40) "
        "else bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_enhance_ops_default_to_cuda(monkeypatch, tmp_path):
    """The enhancement session's entry points run on CUDA unless asked
    for the CPU, and raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.cli.context import Session
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.ops import (
        blind_deconv,
        curves,
        da3d,
        deconvolution,
        filters,
        masks,
        nlbayes,
        pixelmath,
        wavelets,
    )

    img = SirilImage(data=np.full((3, 16, 16), 0.2, np.float32))
    psf = deconvolution.make_psf(size=5)
    plane = np.full((70, 70), 0.2, np.float32)
    for call in (lambda: filters.gauss(img, 1.0),
                 lambda: filters.median_filter(img, 3),
                 lambda: filters.clahe(img),
                 lambda: filters.guided_filter(img),
                 lambda: filters.fftd(img),
                 lambda: wavelets.wavelet_denoise(img),
                 lambda: deconvolution.richardson_lucy(img, psf, 1),
                 lambda: nlbayes.nlbayes_denoise(img),
                 lambda: da3d.da3d(plane, plane, 0.01),
                 lambda: blind_deconv.estimate_kernel_blind(plane, 5),
                 lambda: pixelmath.pixel_math("T", {"T": img}),
                 lambda: curves.apply_curve(img, [(0.5, 0.6)]),
                 lambda: masks.mask_blur(plane, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for words in (["gauss", "1"], ["rl"], ["denoise"], ["fmul", "2"],
                  ["mask_from_stars"]):
        s = Session(cwd=str(tmp_path))
        s.set_image(img, "x")
        with pytest.raises(RuntimeError, match="CUDA"):
            COMMANDS[words[0]].fn(s, words[1:])
    out = filters.gauss(img, 1.0, device="cpu").data
    assert np.abs(out - img.data).max() <= 1e-7
