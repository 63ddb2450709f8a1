"""The port's pixel math, masks and image arithmetic
(siril_tpu_torch/ops/pixelmath.py, masks.py, arithmetic.py) and their
commands, a masked op, and the sequence forms of the enhancement session
(seqfixbanding, seqrl, seqwiener, seqsb, seqdenoise, seqatrous) against
the JAX package on the CPU, on the same seeded inputs.

Bounds (absolute, on [0, 1] data): pixel math 1e-6 (2e-6 for the
transcendental functions of a few float32 roundings, and for the
statistics — the whole image's mean / std summed in another order); the
masks and their commands 1e-6 (the star mask from each package's star
finder 1e-3: the fits differ in the fifth digit; from one star list it
is bit-equal); the arithmetic 1e-6 (u16
quantized: equal); the masked unsharp 1e-5, as the unsharp itself; the
sequence forms as their single-image ops: fixbanding bit-equal, rl,
wiener, sb and the à-trous denoiser 1e-5, NL-Bayes by its effect as in
tests/test_torch_denoise.py.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.ops import arithmetic as jar
from siril_tpu.ops import masks as jmk
from siril_tpu.ops import pixelmath as jpm
from siril_tpu_torch.core.image import SirilImage as TImage
from siril_tpu_torch.ops import arithmetic as tar
from siril_tpu_torch.ops import masks as tmk
from siril_tpu_torch.ops import pixelmath as tpm

torch.set_num_threads(1)

CPU = "cpu"


def scene(seed=71, size=64, nch=3, nstars=12):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    data = np.empty((nch, size, size), np.float32)
    sx = rng.uniform(8, size - 8, nstars)
    sy = rng.uniform(8, size - 8, nstars)
    amp = rng.uniform(0.2, 0.8, nstars)
    for c in range(nch):
        d = 0.08 + 0.05 * xx / size + rng.normal(0, 0.005, (size, size))
        for x, y, a in zip(sx, sy, amp):
            d += a * (0.8 + 0.1 * c) * np.exp(
                -((xx + 0.5 - x) ** 2 + (yy + 0.5 - y) ** 2) / 4.5)
        data[c] = np.clip(d, 0, 1)
    return data


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err


EXPRESSIONS = [
    ("T * 0.9 + 0.01", 1e-6), ("(T + A) / 2 - 0.01", 1e-6),
    ("T ^ 2", 1e-6), ("T % 0.07", 1e-6), ("-T + 1", 1e-6),
    ("iif(T > 0.1, T, 0)", 1e-6), ("iif(T <= A, 1, 0)", 1e-6),
    ("iif(T == T, 0.5, 0)", 1e-6), ("iif(T != A, 0.2, 0.3)", 1e-6),
    ("iif(T >= 0.1, A, T)", 1e-6), ("iif(T < 0.1, A, T)", 1e-6),
    ("abs(T - 0.1)", 1e-6), ("acos(T)", 2e-6), ("asin(T)", 2e-6),
    ("atan(T)", 2e-6), ("atan2(T, A)", 2e-6), ("ceil(T * 4) / 4", 1e-6),
    ("cos(T)", 2e-6), ("cosh(T) - 1", 2e-6), ("exp(T) - 1", 2e-6),
    ("floor(T * 8) / 8", 1e-6), ("ln(T + 1)", 2e-6), ("log(T + 1)", 2e-6),
    ("log10(T + 1)", 2e-6), ("log2(T + 1)", 2e-6), ("max(T, A)", 1e-6),
    ("min(T, 0.3)", 1e-6), ("pow(T, 0.5)", 2e-6), ("sin(T)", 2e-6),
    ("sinh(T)", 2e-6), ("sqrt(T)", 2e-6), ("tan(T)", 2e-6),
    ("tanh(T)", 2e-6), ("truncate(T * 5) / 5", 1e-6),
    ("trunc(T * 3) / 3", 1e-6), ("mtf(0.2, T)", 2e-6), ("asinh(T)", 2e-6),
    ("mean(T, A, 0.1)", 1e-6), ("T - median(T)", 1e-6),
    ("mad(T) * 10 + T", 1e-6), ("mdev(A) + T", 1e-6),
    ("adev(T) + T", 2e-6), ("sdev(T) + T", 2e-6), ("avg(T) + 0 * T", 2e-6),
    ("noise(T) + T", 1e-6), ("pi / 10 + 0 * T", 1e-6),
    ("e / 10 + T", 1e-6), ("0.25", 1e-6), ("sqrt(2) / 4", 1e-6),
    ("max(0.1, 0.2)", 1e-6),
]


@pytest.mark.parametrize("expr,tol", EXPRESSIONS,
                         ids=[e for e, _ in EXPRESSIONS])
def test_pixel_math_vs_jax(expr, tol):
    """Every function of pixelmath.py:29-58 on 64² RGB images (an even
    count: the medians take the middle pair's mean)."""
    t, a = scene(72), scene(73)
    want = jpm.pixel_math(expr, {"T": JImage(data=t), "A": JImage(data=a)})
    got = tpm.pixel_math(expr, {"T": TImage(data=t), "A": TImage(data=a)},
                         device=CPU)
    close(got.data, want.data, tol)


def test_pixel_math_rescale_and_errors():
    t = scene(74)
    want = jpm.pixel_math("T * 3 - 0.5", {"T": JImage(data=t)}, rescale=True)
    got = tpm.pixel_math("T * 3 - 0.5", {"T": TImage(data=t)}, rescale=True,
                         device=CPU)
    close(got.data, want.data, 1e-6)
    for bad in ("T +", "foo(T)", "U * 2", "T < A < 1", "'s'"):
        with pytest.raises(tpm.PixelMathError):
            tpm.pixel_math(bad, {"T": TImage(data=t), "A": TImage(data=t)},
                           device=CPU)
    with pytest.raises(tpm.PixelMathError):
        tpm.pixel_math("T + A", {"T": TImage(data=t),
                                 "A": TImage(data=t[:, :32])}, device=CPU)


def test_mask_sources_and_modifiers_vs_jax():
    d = scene(75)
    j, t = JImage(data=d.copy()), TImage(data=d.copy())
    pairs = [
        (tmk.mask_from_channel(t, 1), jmk.mask_from_channel(j, 1), 0.0),
        (tmk.mask_from_lum(t), jmk.mask_from_lum(j), 0.0),
        (tmk.mask_from_lum(t, (0.5, 0.3, 0.2)),
         jmk.mask_from_lum(j, (0.5, 0.3, 0.2)), 0.0),
        (tmk.mask_from_color(t, (0.1, 0.1, 0.1), 0.05),
         jmk.mask_from_color(j, (0.1, 0.1, 0.1), 0.05), 0.0),
        (tmk.mask_from_stars(t, device=CPU), jmk.mask_from_stars(j), 1e-3),
    ]
    m = jmk.mask_from_lum(j)
    pairs += [
        (tmk.mask_invert(m), jmk.mask_invert(m), 0.0),
        (tmk.mask_blur(m, 2.0, device=CPU), jmk.mask_blur(m, 2.0), 1e-6),
        (tmk.mask_feather(m * 3, 4), jmk.mask_feather(m * 3, 4), 0.0),
        (tmk.mask_threshold(m, 0.1, 0.5), jmk.mask_threshold(m, 0.1, 0.5),
         0.0),
        (tmk.mask_threshold(m, 0.1, 0.5, True),
         jmk.mask_threshold(m, 0.1, 0.5, True), 0.0),
        (tmk.mask_fmul(m, 3.0), jmk.mask_fmul(m, 3.0), 0.0),
        (tmk.mask_autostretch(m, device=CPU), jmk.mask_autostretch(m),
         1e-6),
    ]
    for i, (got, want, tol) in enumerate(pairs):
        assert got.dtype == np.float32, i
        close(got, want, tol)
    assert tmk.mask_from_stars(t, device=CPU).max() > 0.9


def test_star_blobs_bit_equal():
    """The star mask drawn from the JAX package's own star list is its
    mask, bit for bit; the masks from each package's finder differ by
    what their fits differ by (8.5e-5 here: positions and FWHMs in the
    fifth digit), so the sources are held to 1e-3."""
    from siril_tpu.registration.starfinder import detect_stars

    d = scene(75)
    stars = detect_stars(d[0])
    assert len(stars) >= 4
    assert np.array_equal(tmk.star_blobs(stars, 64, 64),
                          jmk.mask_from_stars(JImage(data=d)))


def _sessions(tmp_path, data):
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.context import Session as TSession

    js = JSession(cwd=str(tmp_path))
    ts = TSession(cwd=str(tmp_path), device=CPU)
    js.set_image(JImage(data=data.copy()), "x")
    ts.set_image(TImage(data=data.copy()), "x")
    return js, ts


MASK_SCRIPTS = [
    ["mask_from_channel 0", "mask_invert", "mask_blur 1.5",
     "mask_threshold 0.2 0.9", "mask_fmul 1.5", "mask_bitpix 8"],
    ["mask_from_lum -rw=0.3 -gw=0.4 -bw=0.3 -autostretch -bitdepth=16",
     "mask_autostretch", "mask_bitpix 16"],
    ["mask_from_lum -invert -feather=3", "mask_feather -dist=2"],
    ["mask_from_stars", "mask_blur 2"],
    ["mask_from_color -cr=0.1 -cg=0.1 -cb=0.1 -tol=0.05 -invert",
     "mask_bitpix 32"],
    ["mask_from_channel 2", "clear_mask"],
]


@pytest.mark.parametrize("lines", MASK_SCRIPTS,
                         ids=[s[0].split()[0] for s in MASK_SCRIPTS])
def test_mask_commands_vs_jax(tmp_path, lines):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    js, ts = _sessions(tmp_path, scene(76))
    for line in lines:
        words = line.split()
        JCMD[words[0]].fn(js, words[1:])
        TCMD[words[0]].fn(ts, words[1:])
        jm, tm = js.image.mask, ts.image.mask
        assert (jm is None) == (tm is None), line
        if tm is not None:
            close(tm, jm, 1e-3 if lines[0] == "mask_from_stars" else 1e-6)
    assert ts.image.mask_active == js.image.mask_active


def test_masked_unsharp_vs_jax(tmp_path):
    """unsharp through a blurred star mask: the blend of both packages
    within the unsharp's bound, and where the mask is 0 the input."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    d = scene(77)
    js, ts = _sessions(tmp_path, d)
    for line in ("mask_from_stars", "mask_blur 2", "unsharp 1.5 1.6"):
        words = line.split()
        JCMD[words[0]].fn(js, words[1:])
        TCMD[words[0]].fn(ts, words[1:])
    close(ts.image.data, np.asarray(js.image.data), 1e-5)
    zero = ts.image.mask == 0
    assert zero.any()
    assert np.array_equal(ts.image.data[:, zero], d[:, zero])


@pytest.mark.parametrize("force16", [False, True])
def test_arithmetic_commands_vs_jax(tmp_path, force16):
    """iadd … addmax through both command tables, in the u16 mode
    (clip16) and without."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.io.fits_io import write_fits

    b = scene(78)
    b[:, :4, :4] = 0.0                                 # division by zero
    write_fits(TImage(data=b), str(tmp_path / "b.fit"), bitdepth=-32)
    js, ts = _sessions(tmp_path, scene(79))
    js.force_16bit = ts.force_16bit = force16
    for line in ("iadd b", "isub b", "imul b", "idiv b", "fadd 1000",
                 "fsub 300", "fmul 1.3", "fdiv b 0.5", "offset 120.5",
                 "addmax b", "pm \"$b$ * 0.5 + 0.1\""):
        words = line.split()
        JCMD[words[0]].fn(js, [w.strip('"') if w.startswith('"') else w
                               for w in words[1:]])
        TCMD[words[0]].fn(ts, [w.strip('"') if w.startswith('"') else w
                               for w in words[1:]])
        close(ts.image.data, np.asarray(js.image.data), 1e-6)


@pytest.mark.parametrize("oper", range(4))
def test_imoper_soper_q16_vs_jax(oper):
    a, b = scene(80)[0], scene(81)[0]
    b[:3] = 0.0
    for clip16 in (False, True):
        want = jar.imoper(a, b, oper, 0.7, clip16)
        got = tar.imoper(torch.from_numpy(a), torch.from_numpy(b), oper,
                         0.7, clip16)
        close(got, want, 0.0 if clip16 else 1e-6)
        close(tar.soper(torch.from_numpy(a), 0.37, oper, clip16),
              jar.soper(a, 0.37, oper, clip16), 0.0 if clip16 else 1e-6)
    close(tar.addmax(torch.from_numpy(a), torch.from_numpy(b)),
          jar.addmax(a, b), 0.0)
    with pytest.raises(ZeroDivisionError):
        tar.soper(torch.from_numpy(a), 0.0, tar.OPER_DIV)


def test_pm_command_on_loaded_image_vs_jax(tmp_path):
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD

    js, ts = _sessions(tmp_path, scene(82))
    JCMD["pm"].fn(js, ["$T * 0.9 + 0.01", "-rescale"])
    TCMD["pm"].fn(ts, ["$T * 0.9 + 0.01", "-rescale"])
    close(ts.image.data, np.asarray(js.image.data), 1e-6)
    assert ts.image_name == "pm_result"


SEQ_FORMS = [
    ("seqfixbanding light_ 1 1", "unband_", 0.0),
    ("seqrl light_ -iters=5 -fwhm=3", "rl_", 1e-5),
    ("seqwiener light_ -alpha=200 -fwhm=3", "wiener_", 1e-5),
    ("seqsb light_ -iters=3 -fwhm=3", "sb_", 1e-5),
    ("seqdenoise light_", "dn_", None),
    ("seqatrous light_ 3", "atrous_", 1e-5),
]


@pytest.mark.parametrize("line,prefix,tol", SEQ_FORMS,
                         ids=[f[0].split()[0] for f in SEQ_FORMS])
def test_sequence_forms_vs_jax(tmp_path, line, prefix, tol):
    """Each form on a 4-frame float32 sequence in a directory of its own
    for each package; the written frames compared."""
    from siril_tpu.cli.commands import COMMANDS as JCMD
    from siril_tpu.cli.context import Session as JSession
    from siril_tpu_torch.cli.commands import COMMANDS as TCMD
    from siril_tpu_torch.cli.context import Session as TSession
    from siril_tpu_torch.io.fits_io import read_fits, write_fits

    src = tmp_path / "src"
    src.mkdir()
    clean = scene(83, 48, 1)
    rng = np.random.default_rng(84)
    for i in range(1, 5):
        f = np.clip(clean + rng.normal(0, 0.02, clean.shape), 0, 1)
        write_fits(TImage(data=f.astype(np.float32)),
                   str(src / f"light_{i:05d}.fit"), bitdepth=-32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    words = line.split()
    JCMD[words[0]].fn(JSession(cwd=str(jdir)), words[1:])
    TCMD[words[0]].fn(TSession(cwd=str(tdir), device=CPU), words[1:])
    for i in range(1, 5):
        name = f"{prefix}light_{i:05d}.fit"
        assert os.path.exists(tdir / name), name
        got = read_fits(str(tdir / name)).data
        want = read_fits(str(jdir / name)).data
        if tol is None:
            err_p = np.sqrt(np.mean((got - clean) ** 2))
            err_j = np.sqrt(np.mean((want - clean) ** 2))
            assert err_p <= 1.05 * err_j, (err_p, err_j)
            assert np.mean(np.abs(got.astype(np.float64) - want)) <= 5e-3
        else:
            close(got, want, tol)
