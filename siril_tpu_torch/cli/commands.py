"""The ported commands — counterpart of ``siril_tpu/cli/commands.py``
(``load``:98, ``save``:117, ``requires``:321, ``cd``:217, ``setext``:237,
``close``:205, ``convert``:473, ``link``:500, ``_load_master``:601,
``_drizzle_out_sequence``:1011,
``_calib_args_from_flags``:617, ``calibrate``:651, ``split_cfa``:763,
``extract_Ha``:776, ``extract_Green``:790, ``extract_HaOIII``:802,
``merge_cfa``:817, ``setfindstar``:833, ``_sf_params``:874, ``register``
:910, ``seqapplyreg``:1059, ``stack``:1197, ``_stack_args_from_flags``
:1121, ``_get_catalog``:2288, ``platesolve``:2333, ``conesearch``:2374,
``_seq_apply``:2684, ``seqsplit_cfa``:2792, ``seqextract_Ha``:2818,
``seqextract_Green``:2836, ``seqextract_HaOIII``:2846, ``online``:3041,
``offline``:3048, ``show``:3159, ``catsearch``:3185) and
``siril_tpu/cli/commands2.py`` (``setcompress``:134, ``seqmerge_cfa``:369,
``seqplatesolve``:477, ``disto``:685, ``healpix``:765, ``trixel``:787,
``fusedstack``:836), and the image ops of the post-stack session: geometry
(``crop``:1294, ``resample``:1308, ``rotate``:1331, ``rotatepi``:1345,
``mirrorx``:1352, ``mirrory``:1376, ``binxy``:1383), the stretches
(``autostretch``:1397, ``mtf``:1409, ``invmtf``:1418, ``asinh``:1431,
``ght``:1481, ``invght``:1489, ``modasinh``:1496, ``invmodasinh``:1503,
``linstretch``:1510, ``autoghs``:1521), colour (``neg``:1556,
``rmgreen``:1664, ``satu``:1674, ``ccm``:1804, ``split``:2219,
``rgbcomp``:2236), ``subsky`` (:2197), photometry and colour calibration
(``pcc``:2402, ``bgneutralize``:2416, ``setphot``:2423, ``spcc``:3072,
``spcc_list``:3116, ``findcompstars``:3125) and, from commands2.py,
``catmag`` (:605) and ``eqcrop`` (:712); and the enhancement session:
the filters (``ddp``:1549, the threshold family :1563-1598, ``gauss``
:1606, ``unsharp``, ``fmedian``, ``clahe``, ``epf``:1636, ``fixbanding``,
``unpurple``, ``rgradient``, ``fftd``, ``ffti``, ``linear_match``),
``denoise`` (:1710), ``wavelet`` / ``wrecons``, ``makepsf`` (:1848),
``_psf_for_deconv`` (:1897), ``rl``, ``wiener``, ``sb``, the arithmetic
(``_load_operand``:1962, ``iadd`` … ``addmax``), ``pm`` (:2067), the
masks (``mask_from_channel``:2117 … ``clear_mask``), the sequence forms
``seqfixbanding`` (:2760), ``seqrl`` (:2871), ``seqwiener``, ``seqsb``,
``seqdenoise`` (:2908), ``seqatrous`` (:2922), and from commands2.py
``ffill`` (:108) and ``mask_autostretch`` (:214) … ``mask_from_color``
(:259).

Each command keeps the reference's name, argument order and ``-key=value``
flags, so the standard preprocessing scripts run unchanged.  Device work
runs on ``Session.device`` (CUDA unless "cpu").  Inputs that are not
ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
import glob as globmod
import logging
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.core.image import FLOAT_IMG
from siril_tpu_torch.ops.rejection import (
    SIGMEDIAN_MAX_ROUNDS,
    WINSOR_MAX_STEPS,
)

_log = logging.getLogger(__name__)

VERSION = "1.5.0"


class Command:
    def __init__(self, name: str, fn: Callable, usage: str,
                 min_args: int = 0):
        self.name = name
        self.usage = usage
        self.min_args = min_args

        def run(ctx, args):
            # the session knows which command runs (its undo rule,
            # core/undo.UNDO_COMMANDS); a nested command runs as itself
            prev = getattr(ctx, "command", "")
            ctx.command = name
            try:
                return fn(ctx, args)
            finally:
                ctx.command = prev

        self.fn = functools.update_wrapper(run, fn)


COMMANDS: Dict[str, Command] = {}


def command(name: str, usage: str = "", min_args: int = 0,
            aliases=()):
    def deco(fn):
        cmd = Command(name, fn, usage, min_args)
        COMMANDS[name.lower()] = cmd
        for a in aliases:
            COMMANDS[a.lower()] = cmd
        return fn

    return deco


def get_command(name: str) -> Optional[Command]:
    return COMMANDS.get(name.lower())


def parse_flags(args: List[str]):
    """Split ['-key=value', '-flag', 'pos'] → (positional, {key: value})."""
    pos, flags = [], {}
    for a in args:
        if a.startswith("-") and len(a) > 1 and a[1].isalnum() \
                and not _is_number(a) and ":" not in a.split("=")[0]:
            if "=" in a:
                k, v = a[1:].split("=", 1)
                flags[k.lower()] = v
            else:
                flags[a[1:].lower()] = True
        else:
            pos.append(a)
    return pos, flags


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _f(v, default=None):
    return float(v) if v is not None and v is not True else default


# ===========================================================================
# session
# ===========================================================================


@command("requires", "requires version", min_args=1)
def cmd_requires(ctx: Session, args: List[str]) -> None:
    def vtup(s):
        return tuple(int(x) for x in s.split("-")[0].split(".")[:3])

    try:
        need = vtup(args[0])
    except ValueError:
        raise CommandError(f"invalid version: {args[0]}")
    if need > vtup(VERSION):
        raise CommandError(
            f"script requires version {args[0]}, this is {VERSION}")


@command("cd", "cd directory", min_args=1)
def cmd_cd(ctx: Session, args: List[str]) -> None:
    p = ctx.path(args[0])
    if not os.path.isdir(p):
        raise CommandError(f"no such directory: {args[0]}")
    ctx.cwd = os.path.abspath(p)
    _log.info("Setting CWD to '%s'", ctx.cwd)


@command("setext", "setext extension", min_args=1)
def cmd_setext(ctx: Session, args: List[str]) -> None:
    e = args[0].lower().lstrip(".")
    if e not in ("fit", "fits", "fts"):
        raise CommandError("extension must be fit/fits/fts")
    ctx.ext = "." + e


@command("close", "close")
def cmd_close(ctx: Session, args: List[str]) -> None:
    ctx.image = None


@command("load", "load filename", min_args=1)
def cmd_load(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import load_any

    p = ctx.path(args[0])
    if not os.path.exists(p):
        for ext in (ctx.ext, ".fit", ".fits", ".fts", ".tif", ".png"):
            if os.path.exists(p + ext):
                p = p + ext
                break
        else:
            raise CommandError(f"file not found: {args[0]}")
    img = load_any(p)
    ctx.set_image(img, os.path.basename(p))
    _log.info("Reading FITS: '%s', %d layer(s), %dx%d", os.path.basename(p),
              img.nchans, img.width, img.height)


@command("save", "save filename", min_args=1)
def cmd_save(ctx: Session, args: List[str]) -> None:
    """Write the loaded image at its bit depth (16 bits while
    ``set16bits`` is on), tile-compressed while ``setcompress`` is on;
    ``$KEY:fmt$`` in the name takes the image's keywords."""
    from siril_tpu_torch.core.image import USHORT_IMG
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.utils.pathparse import parse_path

    img = ctx.require_image()
    pos, _ = parse_flags(args)
    p = ctx.path(parse_path(pos[0], img) if "$" in pos[0] else pos[0])
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(img, p,
               bitdepth=USHORT_IMG if ctx.force_16bit else img.orig_bitdepth,
               compression=ctx.compression)
    _log.info("Saving FITS: '%s'%s", os.path.basename(p),
              f" (compressed: {ctx.compression})" if ctx.compression else "")


@command("setcompress", "setcompress 0|1 [-type=rice|gzip1|gzip2] [q]",
         min_args=1)
def cmd_setcompress(ctx: Session, args: List[str]) -> None:
    """Turn the tile compression of ``save`` on or off.  Every codec is
    lossless here: float images are written GZIP_1, and the quantization
    level ``q`` is read and not used, as in the JAX package."""
    pos, flags = parse_flags(args)
    if pos[0] in ("0", "false", "no"):
        ctx.compression = None
        _log.info("FITS compression disabled")
        return
    ctx.compression = str(flags.get("type", "rice")).lower()
    if len(pos) > 1:
        ctx.prefs.comp_quantization = float(pos[1])
    _log.info("FITS compression enabled: %s", ctx.compression)


# ===========================================================================
# conversion
# ===========================================================================

#: what ``convert`` picks up in the working directory (the reference's
#: list; only FITS inputs are ported, the others raise in load_any)
#: every extension ``load_any`` reads, and the films: the JAX package's
#: list (``siril_tpu/cli/commands.py:482-483``) lacks RW2, PEF, ORF, CR3,
#: XISF and PIC, so its ``convert`` skips those files (ROADMAP §3)
_CONVERT_EXT = (".fit", ".fits", ".fts", ".tif", ".tiff", ".png", ".jpg",
                ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm", ".webp", ".avif",
                ".ser", ".dng", ".cr2", ".nef", ".arw", ".raf", ".rw2",
                ".cr3", ".pef", ".orf", ".heic", ".heif", ".xisf", ".pic",
                ".avi", ".mpg", ".mpeg", ".mov", ".mp4", ".webm")


def _inputs(ctx: Session, dest: str, exts) -> List[str]:
    outpat = re.compile(re.escape(dest) + r"\d+\.")
    return [f for f in globmod.glob(os.path.join(ctx.cwd, "*"))
            if os.path.splitext(f)[1].lower() in exts
            and not outpat.match(os.path.basename(f))]


@command("convert", "convert basename [-debayer] [-start=index] [-out=] "
         "[-fitseq|-ser]", min_args=1)
def cmd_convert(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import convert_to_sequence

    pos, flags = parse_flags(args)
    out_dir = ctx.path(flags["out"]) if isinstance(flags.get("out"), str) \
        else ctx.cwd
    files = _inputs(ctx, pos[0], _CONVERT_EXT)
    if not files:
        raise CommandError("no convertible files found")
    output = "ser" if "ser" in flags else (
        "fitseq" if "fitseq" in flags else "fits")
    ctx.sequence = convert_to_sequence(
        files, pos[0], out_dir, output=output,
        start=int(_f(flags.get("start"), 1) or 1),
        debayer="debayer" in flags, device=ctx.device)


@command("link", "link basename [-start=] [-out=]", min_args=1)
def cmd_link(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import FITS_EXT, convert_to_sequence

    pos, flags = parse_flags(args)
    files = _inputs(ctx, pos[0], FITS_EXT)
    if not files:
        raise CommandError("no FITS files found")
    ctx.sequence = convert_to_sequence(
        files, pos[0], ctx.cwd, symlink=True,
        start=int(_f(flags.get("start"), 1) or 1))


# ===========================================================================
# calibration
# ===========================================================================


def _load_master(ctx: Session, name):
    from siril_tpu_torch.io.conversion import load_any

    if name in ("", None):
        return None
    p = ctx.path(name)
    if not os.path.exists(p):
        for ext in (ctx.ext, ".fit", ".fits", ".fts"):
            if os.path.exists(p + ext):
                p = p + ext
                break
        else:
            raise CommandError(f"master not found: {name}")
    return load_any(p)


def _calib_args_from_flags(ctx: Session, flags: dict, ref_img=None):
    from siril_tpu_torch.ops.calibration import (
        CalibArgs,
        evaluate_offset_level,
    )

    ca = CalibArgs()
    b = flags.get("bias")
    if isinstance(b, str):
        if b.startswith("="):
            if ref_img is None:
                raise CommandError("synthetic bias needs a loaded image")
            ca.bias_level = evaluate_offset_level(b, ref_img)
        else:
            ca.bias = _load_master(ctx, b)
    if isinstance(flags.get("dark"), str):
        ca.dark = _load_master(ctx, flags["dark"])
    if isinstance(flags.get("flat"), str):
        ca.flat = _load_master(ctx, flags["flat"])
    ca.use_dark_optim = "opt" in flags
    ca.use_exposure = flags.get("opt") == "exp"
    ca.use_cosmetic = "cc" in flags
    ca.is_cfa = "cfa" in flags
    ca.debayer = "debayer" in flags
    ca.equalize_cfa = "equalize_cfa" in flags or ca.is_cfa
    if isinstance(flags.get("prefix"), str):
        ca.prefix = flags["prefix"]
    return ca


@command("calibrate", "calibrate sequencename [-bias=] [-dark=] [-flat=] "
         "[-cc=dark] [-cfa] [-debayer] [-opt] [-prefix=]", min_args=1)
def cmd_calibrate(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.calibration import calibrate_sequence

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    ref = seq.read_frame(int(seq.selected_indices()[0]))
    res = calibrate_sequence(seq, _calib_args_from_flags(ctx, flags, ref),
                             device=ctx.device)
    ctx.sequence = res.new_seq or seq
    ctx.stages = res.stage_s
    _log.info("Calibration: %d images processed", res.processed)


# ===========================================================================
# CFA: channel extraction of one image and of sequences
# ===========================================================================


def _image_base(ctx: Session) -> str:
    return os.path.splitext(ctx.image_name or "image")[0]


def _prefix(flags: dict, default: str, key: str = "prefix") -> str:
    return flags[key] if isinstance(flags.get(key), str) else default


@command("split_cfa", "split_cfa")
def cmd_split_cfa(ctx: Session, args: List[str]) -> None:
    """The four CFA sites of the loaded image → CFA0_…CFA3_<name>."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.extraction import split_cfa

    base = _image_base(ctx)
    for i, sub in enumerate(split_cfa(ctx.require_image())):
        write_fits(sub, ctx.path(f"CFA{i}_{base}{ctx.ext}"))
    _log.info("Extracted 4 CFA channels from %s", base)


@command("extract_Ha", "extract_Ha [-upscale]",
         aliases=("extract_haoiii_ha",))
def cmd_extract_ha(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.extraction import extract_ha

    _, flags = parse_flags(args)
    out = extract_ha(ctx.require_image(), upscale="upscale" in flags)
    base = _image_base(ctx)
    write_fits(out, ctx.path(f"Ha_{base}{ctx.ext}"))
    ctx.set_image(out, f"Ha_{base}")



@command("extract_Green", "extract_Green")
def cmd_extract_green(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.extraction import extract_green

    out = extract_green(ctx.require_image())
    base = _image_base(ctx)
    write_fits(out, ctx.path(f"Green_{base}{ctx.ext}"))
    ctx.set_image(out, f"Green_{base}")


@command("extract_HaOIII", "extract_HaOIII [-resample=ha|oiii]")
def cmd_extract_haoiii(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.extraction import extract_ha_oiii

    _, flags = parse_flags(args)
    ha, oiii = extract_ha_oiii(ctx.require_image(),
                               resample=str(flags.get("resample", "oiii")))
    base = _image_base(ctx)
    write_fits(ha, ctx.path(f"Ha_{base}{ctx.ext}"))
    write_fits(oiii, ctx.path(f"OIII_{base}{ctx.ext}"))
    _log.info("Extracted Ha and OIII layers")


@command("merge_cfa", "merge_cfa f0 f1 f2 f3 pattern", min_args=5)
def cmd_merge_cfa(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.ops.extraction import merge_cfa

    imgs = [load_any(ctx.path(a)) for a in args[:4]]
    ctx.set_image(merge_cfa(imgs, args[4]), "merged_cfa")


def _seq_apply(ctx: Session, seqname: str, prefix: str, desc: str,
               fn: Callable, output_bitdepth: Optional[int] = None):
    """A single-image operation over a sequence through the engine → the
    ``prefix`` sequence (the reference's generic_seq_args)."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence

    seq = ctx.load_sequence(seqname)
    res = run_sequence(SeqArgs(seq=seq, description=desc, prefix=prefix,
                               image=lambda c, idx, img: fn(img),
                               output_bitdepth=output_bitdepth))
    ctx.sequence = res.new_seq or seq
    ctx.stages = res.stage_s
    _log.info("%s: %d images processed", desc, res.processed)
    return res


def _seq_write_each(ctx: Session, seqname: str, desc: str,
                    outputs: Callable) -> None:
    """Run ``outputs(img)`` → [(prefix, image), …] on every selected frame
    and write each image beside the sequence as ``<prefix><name><num>``;
    the engine writes nothing (the reference's hooks return no frame)."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence
    from siril_tpu_torch.io.fits_io import write_fits

    seq = ctx.load_sequence(seqname)

    def image(c, idx, img):
        num = int(seq.filenum[idx])
        for prefix, out in outputs(img):
            write_fits(out, os.path.join(
                seq.directory,
                f"{prefix}{seq.name}{num:0{seq.fixed_len}d}.fit"))
        return None

    run_sequence(SeqArgs(seq=seq, description=desc, image=image))


@command("seqsplit_cfa", "seqsplit_cfa sequencename [-prefix=]",
         min_args=1)
def cmd_seqsplit_cfa(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.extraction import split_cfa

    pos, flags = parse_flags(args)
    prefix = _prefix(flags, "CFA_")
    _seq_write_each(ctx, pos[0], "seqsplit_cfa", lambda img: [
        (f"{prefix}{i}_", s) for i, s in enumerate(split_cfa(img))])


@command("seqextract_Ha", "seqextract_Ha sequencename [-prefix=] "
         "[-upscale]", min_args=1)
def cmd_seqextract_ha(ctx: Session, args: List[str]) -> None:
    """Each frame's red site; with ``-upscale`` resampled ×2 (lanczos4
    with the clamp, on the session's device)."""
    from siril_tpu_torch.ops.extraction import extract_ha
    from siril_tpu_torch.ops.geometry import resample

    pos, flags = parse_flags(args)

    def op(img):
        out = extract_ha(img)
        if "upscale" in flags:
            out = resample(out, out.width * 2, out.height * 2,
                           device=ctx.device)
        return out

    _seq_apply(ctx, pos[0], _prefix(flags, "Ha_"), "seqextract_Ha", op)


@command("seqextract_Green", "seqextract_Green sequencename [-prefix=]",
         min_args=1)
def cmd_seqextract_green(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.extraction import extract_green

    pos, flags = parse_flags(args)
    _seq_apply(ctx, pos[0], _prefix(flags, "Green_"), "seqextract_Green",
               extract_green)


@command("seqextract_HaOIII", "seqextract_HaOIII sequencename "
         "[-resample=ha|oiii]", min_args=1)
def cmd_seqextract_haoiii(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.extraction import extract_ha_oiii

    pos, flags = parse_flags(args)
    resample = str(flags.get("resample", "oiii")).lower()
    _seq_write_each(ctx, pos[0], "seqextract_HaOIII", lambda img: zip(
        ("Ha_", "OIII_"), extract_ha_oiii(img, resample=resample)))


@command("seqmerge_cfa", "seqmerge_cfa seq0 seq1 seq2 seq3 pattern "
         "[-prefixout=]", min_args=5)
def cmd_seqmerge_cfa(ctx: Session, args: List[str]) -> None:
    """Four sequences of CFA sites → one mosaic sequence, float32."""
    from siril_tpu_torch.core.sequence import Sequence
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.extraction import merge_cfa

    pos, flags = parse_flags(args)
    seqs = [ctx.load_sequence(p) for p in pos[:4]]
    prefix = _prefix(flags, "mCFA_", "prefixout")
    n = min(s.number for s in seqs)
    files = []
    for i in range(n):
        p = ctx.path(f"{prefix}{i + 1:05d}{ctx.ext}")
        write_fits(merge_cfa([s.read_frame(i) for s in seqs], pos[4]), p,
                   bitdepth=FLOAT_IMG)
        files.append(p)
    ctx.sequence = Sequence.from_files(files, name=prefix.rstrip("_"))
    ctx.sequence.save()
    _log.info("seqmerge_cfa: %d frames merged", n)


# ===========================================================================
# registration
# ===========================================================================


@command("setfindstar", "setfindstar [reset] [-radius=] [-sigma=] "
         "[-roundness=] [-focal=] [-pixelsize=] [-convergence=] "
         "[-gaussian|-moffat] [-minbeta=] [-minA=] [-maxA=] [-maxR=] "
         "[-relax=on|off]")
def cmd_setfindstar(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.registration.starfinder import StarFinderParams

    pos, flags = parse_flags(args)
    if pos and pos[0] == "reset":
        ctx.starfinder = dataclasses.replace(
            StarFinderParams(), max_stars=ctx.starfinder.max_stars)
    p = ctx.starfinder
    for key, attr, conv in (("radius", "radius", lambda v: int(float(v))),
                            ("sigma", "sigma", float),
                            ("roundness", "roundness", float),
                            ("convergence", "convergence",
                             lambda v: int(float(v))),
                            ("minbeta", "min_beta", float),
                            ("mina", "min_A", float),
                            ("maxa", "max_A", float),
                            ("maxr", "max_r", float)):
        if key in flags:
            setattr(p, attr, conv(flags[key]))
    if "relax" in flags:
        p.relax_checks = str(flags["relax"]).lower() in ("on", "1", "true")
    if "gaussian" in flags:
        p.profile = 0
    if "moffat" in flags:
        p.profile = 1
    if "focal" in flags:
        ctx.focal_length = float(flags["focal"])
    if "pixelsize" in flags:
        ctx.pixel_size = float(flags["pixelsize"])
    _log.info("starfinder: radius=%s sigma=%s roundness=%s", p.radius,
              p.sigma, p.roundness)


def _sf_params(ctx: Session):
    """The star finder's parameters of the session (a copy; the maximum
    star count stays the default, as in the reference's _sf_params)."""
    from siril_tpu_torch.registration.starfinder import StarFinderParams

    return dataclasses.replace(ctx.starfinder,
                               max_stars=StarFinderParams().max_stars)


def _disto_path(ctx: Session, flags: dict) -> str:
    """The ``-disto=`` master's path (the session's extension added when
    it has none), or "" without the flag."""
    if not isinstance(flags.get("disto"), str):
        return ""
    p = ctx.path(flags["disto"])
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    if not os.path.exists(p):
        raise CommandError(f"-disto master not found: {flags['disto']}")
    return p


def _register_three_stars(ctx: Session, seq, flags: dict) -> None:
    """``register -3stars -star1=x,y [-star2=x,y] [-star3=x,y]
    [-boxsize=n]``: the picked stars replace the reference's GUI
    selection."""
    from siril_tpu_torch.registration.threestars import register_three_stars

    picked = []
    for key in ("star1", "star2", "star3"):
        v = flags.get(key)
        if isinstance(v, str) and "," in v:
            x, y = v.split(",", 1)
            picked.append((float(x), float(y)))
    if not picked:
        raise CommandError("register -3stars needs -star1=x,y (and "
                           "optionally -star2/-star3)")
    t = time.perf_counter()
    try:
        res = register_three_stars(
            seq, picked, layer=int(float(flags.get("layer", 0) or 0)),
            box=int(float(flags.get("boxsize", 30) or 30)))
    except ValueError as e:
        raise CommandError(str(e))
    ctx.sequence = seq
    ctx.stages = {"follow": time.perf_counter() - t}
    _log.info("Registration complete: %d images (3 stars)", res.registered)


@command("register", "register sequencename [-2pass] [-noout] [-transf=] "
         "[-layer=] [-prefix=] [-minpairs=] [-maxstars=] [-interp=] "
         "[-noclamp] [-disto=master] [-drizzle [-scale=] [-pixfrac=] "
         "[-kernel=] [-flat=]] | register sequencename -3stars -star1=x,y "
         "[-star2=x,y] [-star3=x,y] [-boxsize=]", min_args=1)
def cmd_register(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.interp import INTERP_NAMES
    from siril_tpu_torch.registration.global_reg import (
        RegArgs,
        register_sequence,
    )
    from siril_tpu_torch.registration.matching import (
        AFFINE_TRANSFORMATION,
        HOMOGRAPHY_TRANSFORMATION,
        SHIFT_TRANSFORMATION,
        SIMILARITY_TRANSFORMATION,
    )

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    if "3stars" in flags:
        _register_three_stars(ctx, seq, flags)
        return
    ra = RegArgs(starfinder=_sf_params(ctx))
    ra.two_pass = "2pass" in flags
    ra.output = "noout" not in flags and not ra.two_pass
    tmap = {"shift": SHIFT_TRANSFORMATION,
            "similarity": SIMILARITY_TRANSFORMATION,
            "affine": AFFINE_TRANSFORMATION,
            "homography": HOMOGRAPHY_TRANSFORMATION}
    if isinstance(flags.get("transf"), str):
        ra.ttype = tmap.get(flags["transf"].lower(), ra.ttype)
    if "layer" in flags:
        ra.reglayer = int(float(flags["layer"]))
    if isinstance(flags.get("prefix"), str):
        ra.prefix = flags["prefix"]
    if "minpairs" in flags:
        ra.min_pairs = int(float(flags["minpairs"]))
    if "maxstars" in flags:
        ra.max_stars = int(float(flags["maxstars"]))
    if isinstance(flags.get("interp"), str):
        ra.interpolation = INTERP_NAMES.get(flags["interp"].lower(),
                                            ra.interpolation)
    if "noclamp" in flags:
        ra.clamp = False
    if "scale" in flags:
        ra.scale = float(flags["scale"])
    if isinstance(flags.get("extref"), str):
        ra.extref = ctx.path(flags["extref"])
    ra.save_starlists = "nostarlist" not in flags
    disto = _disto_path(ctx, flags)
    if "drizzle" in flags:
        # the transforms only, then every frame drizzled onto the output
        # grid (the Bayer-drizzle workflow)
        ra.output = False
        res = register_sequence(seq, ra, device=ctx.device)
        stages = dict(res.stage_s)
        _drizzle_out_sequence(ctx, seq, ra.reglayer, ra.prefix or "r_",
                              flags)
        ctx.stages = {**stages, **ctx.stages}
        _log.info("Registration complete: %d images", int(seq.incl.sum()))
        return
    if disto:
        # the transforms first, then the warp with the master's SIP
        # distortion composed into its sampling
        from siril_tpu_torch.registration.global_reg import (
            ApplyRegArgs,
            apply_reg_sequence,
        )

        ra.output = False
        stages = dict(register_sequence(seq, ra, device=ctx.device).stage_s)
        res = apply_reg_sequence(seq, ApplyRegArgs(
            reglayer=ra.reglayer, prefix=ra.prefix,
            interpolation=ra.interpolation, clamp=ra.clamp, scale=ra.scale,
            disto_file=disto), device=ctx.device)
        ctx.sequence = res.new_seq or seq
        ctx.stages = {**stages, **res.stage_s}
        _log.info("Registration complete: %d images", res.processed)
        return
    res = register_sequence(seq, ra, device=ctx.device)
    ctx.sequence = res.new_seq or seq
    ctx.stages = res.stage_s
    _log.info("Registration complete: %d images", res.processed)


def _drizzle_args(flags: dict):
    """DrizzleArgs of ``-scale= -pixfrac= -kernel=`` (2, 1, square)."""
    from siril_tpu_torch.ops.drizzle import KERNEL_NAMES, DrizzleArgs

    da = DrizzleArgs(scale=_f(flags.get("scale"), 2.0) or 2.0,
                     pixfrac=_f(flags.get("pixfrac"), 1.0) or 1.0)
    if isinstance(flags.get("kernel"), str):
        da.kernel = KERNEL_NAMES.get(flags["kernel"].lower(), da.kernel)
    return da


def _drizzle_out_sequence(ctx: Session, seq, reglayer: int, prefix: str,
                          flags: dict):
    """Each selected, registered frame drizzled alone → the float32
    sequence ``<prefix><name>`` (applyreg.c's drizzle path,
    initialize_drizzle_params:1111), for ``register -drizzle`` and
    ``seqapplyreg -drizzle``.  A CFA frame drizzles its sites to three
    planes; ``-flat=`` gives the input weights (the master flat's first
    layer, as read)."""
    from siril_tpu_torch.core.engine import SeqArgs, run_sequence
    from siril_tpu_torch.device import resolve_device, synchronize
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.ops.drizzle import DrizzleAccumulator

    dev = resolve_device(ctx.device)
    da = _drizzle_args(flags)
    wplane = None
    if isinstance(flags.get("flat"), str):
        fp = ctx.path(flags["flat"])
        if not os.path.splitext(fp)[1]:
            fp += ctx.ext
        wplane = load_any(fp).host()[0]
    reg = seq.reg(reglayer)
    first = seq.read_frame(int(seq.selected_indices()[0]))
    da.use_bayer = first.is_cfa()
    out_shape = (3 if da.use_bayer else first.nchans,
                 int(seq.ry * da.scale), int(seq.rx * da.scale))
    stages: dict = {}

    def image(c, idx, img):
        if not reg.valid[idx]:
            return None
        t = time.perf_counter()
        acc = DrizzleAccumulator(out_shape, da, dev)
        acc.add_frame(img, reg.H[idx], weight_plane=wplane)
        out, _ = acc.finalize(want_weight=False)
        synchronize(dev)
        stages["drizzle"] = stages.get("drizzle", 0.0) + \
            time.perf_counter() - t
        return out

    # the outputs go beside the sequence, one float32 FITS file a frame
    res = run_sequence(SeqArgs(seq=seq, description="drizzle",
                               prefix=prefix, image=image,
                               output_bitdepth=FLOAT_IMG, stage_s=stages))
    if res.new_seq is not None:
        res.new_seq.save()
    ctx.sequence = res.new_seq or seq
    ctx.stages = stages
    _log.info("drizzle: %d frames at x%g", res.processed, da.scale)
    return res.new_seq


@command("seqapplyreg", "seqapplyreg sequencename [-framing=] [-interp=] "
         "[-prefix=] [-layer=] [-scale=] [-noclamp] [-disto=master] "
         "[-filter-*=] [-drizzle [-pixfrac=] [-kernel=] [-flat=]]",
         min_args=1)
def cmd_seqapplyreg(ctx: Session, args: List[str]) -> None:
    """Warp the selected frames by their registration; a sequence with no
    registration data whose frames are plate-solved is registered from
    their WCS solutions first (applyreg.c:1188-1213, the mosaic route),
    and that registration is kept in its ``.seq``."""
    from siril_tpu_torch.core.filtering import apply_filters, filter_specs
    from siril_tpu_torch.ops.interp import INTERP_NAMES
    from siril_tpu_torch.registration.global_reg import (
        FRAMING_NAMES,
        ApplyRegArgs,
        apply_reg_sequence,
    )

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    aa = ApplyRegArgs(disto_file=_disto_path(ctx, flags))
    if isinstance(flags.get("framing"), str):
        aa.framing = FRAMING_NAMES.get(flags["framing"].lower(), aa.framing)
    if isinstance(flags.get("interp"), str):
        aa.interpolation = INTERP_NAMES.get(flags["interp"].lower(),
                                            aa.interpolation)
    if isinstance(flags.get("prefix"), str):
        aa.prefix = flags["prefix"]
    if "layer" in flags:
        aa.reglayer = int(float(flags["layer"]))
    if "scale" in flags:
        aa.scale = float(flags["scale"])
    if "noclamp" in flags:
        aa.clamp = False
    specs = filter_specs(flags)
    if specs:
        keep = np.zeros(seq.number, bool)
        keep[apply_filters(seq, specs, aa.reglayer)] = True
        seq.incl &= keep
        _log.info("seqapplyreg filter: %d of %d frames kept",
                  int(seq.incl.sum()), seq.number)
    if "drizzle" in flags:
        _drizzle_out_sequence(ctx, seq, aa.reglayer, aa.prefix or "r_",
                              flags)
        return
    stages = {}
    if not seq.has_reg(aa.reglayer):
        from siril_tpu_torch.registration.astrometric import (
            register_astrometric,
        )

        t = time.perf_counter()
        if register_astrometric(seq, aa.reglayer) == 0:
            raise CommandError("no registration data and no WCS solutions "
                               "in this sequence")
        seq.save()
        stages["astrometric"] = time.perf_counter() - t
    res = apply_reg_sequence(seq, aa, device=ctx.device)
    ctx.sequence = res.new_seq or seq
    ctx.stages = {**stages, **res.stage_s}
    _log.info("Applied registration to %d images", res.processed)


# ===========================================================================
# stacking
# ===========================================================================


@command("fusedstack", "fusedstack sequencename [rejection] [sig_low "
         "sig_high] [-norm=] [-bias=] [-dark=] [-flat=] [-cc=dark] [-out=] "
         "[-noreg]", min_args=1)
def cmd_fusedstack(ctx: Session, args: List[str]) -> None:
    """Fused calibrate+register+stack with the sequence resident on the
    device; no intermediate sequences, one upload and one result fetch.
    The sequence and masters' load and the result's write are the spans
    ``cli.load`` and ``cli.write``."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        NORM_NAMES,
    )
    from siril_tpu_torch.ops.stacking import StackArgs
    from siril_tpu_torch.pipeline import FusedArgs, fused_preprocess_stack
    from siril_tpu_torch.registration.matching import (
        HOMOGRAPHY_TRANSFORMATION,
    )
    from siril_tpu_torch.utils.trace import stage

    pos, flags = parse_flags(args)
    with stage("cli.load"):
        seq = ctx.load_sequence(pos[0])
        calib = None
        if any(k in flags for k in ("bias", "dark", "flat")):
            calib = _calib_args_from_flags(
                ctx, flags, seq.read_frame(int(seq.selected_indices()[0])))
    sa = StackArgs(method="rej")
    rest = pos[1:]
    if rest and not _is_number(rest[0]):
        sa.rejection = rj.REJECTION_NAMES.get(rest[0].lower(), rj.WINSORIZED)
        rest = rest[1:]
    if len(rest) >= 2:
        sa.siglow, sa.sighigh = float(rest[0]), float(rest[1])
    sa.normalize = NORM_NAMES.get(str(flags.get("norm", "addscale")).lower(),
                                  ADDITIVE_SCALING)
    fa = FusedArgs(calib=calib, stack=sa, starfinder=_sf_params(ctx),
                   register="noreg" not in flags)
    # any other -transf= value registers by shifts, as the reference's
    # command does (siril_tpu/cli/commands2.py:877-878)
    if flags.get("transf") == "homography":
        fa.ttype = HOMOGRAPHY_TRANSFORMATION
    try:
        res = fused_preprocess_stack(seq, fa, device=ctx.device)
    except MemoryError as e:
        raise CommandError(str(e))
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else seq.name + "fused"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    with stage("cli.write"):
        write_fits(res.image, p, bitdepth=FLOAT_IMG)
    ctx.image = res.image
    ctx.result = res
    ctx.stages = res.stage_s
    _log.info("fusedstack: saved %s (%.2fs)", os.path.basename(p),
              res.elapsed_s)
    _warn_capped(res)


def _warn_capped(res) -> None:
    if res.capped:
        _log.warning(
            "%d rejection loops stopped at their bound (SIGMEDIAN %d "
            "rounds, winsorized %d σ steps) before settling", res.capped,
            SIGMEDIAN_MAX_ROUNDS, WINSOR_MAX_STEPS)


def stack_args_from_flags(pos: List[str], flags: dict):
    """StackArgs of ``stack seq [method] [type] [sig_low sig_high] -…``
    (``_stack_args_from_flags``, siril_tpu/cli/commands.py:1121-1187)."""
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import NORM_NAMES
    from siril_tpu_torch.ops.stacking import (
        NBSTACK_WEIGHT,
        NBSTARS_WEIGHT,
        NOISE_WEIGHT,
        WFWHM_WEIGHT,
        StackArgs,
    )

    sa = StackArgs()
    method = pos[1] if len(pos) > 1 else "rej"
    sa.method = {"sum": "sum", "min": "min", "max": "max", "med": "med",
                 "median": "med", "rej": "rej", "mean": "rej"}.get(method,
                                                                  "rej")
    rest = pos[2:]
    if sa.method == "rej":
        sa.rejection = rj.WINSORIZED
        if rest and not _is_number(rest[0]):
            sa.rejection = rj.REJECTION_NAMES.get(rest[0].lower(),
                                                  rj.WINSORIZED)
            rest = rest[1:]
        if sa.rejection == rj.GESDT:
            sa.siglow, sa.sighigh = 0.3, 0.05
        elif sa.rejection == rj.PERCENTILE:
            sa.siglow, sa.sighigh = 0.2, 0.1
        if len(rest) >= 2:
            sa.siglow, sa.sighigh = float(rest[0]), float(rest[1])
        if sa.siglow < 0 or sa.sighigh < 0:
            raise CommandError("The average stacking with rejection "
                               "requires two extra arguments: sigma low "
                               "and high")
        # command.c:11909-11917: both GESDT parameters (max outlier
        # fraction, significance) and percentile bounds lie in [0, 1]
        if sa.rejection == rj.GESDT and (sa.siglow > 1 or sa.sighigh > 1):
            raise CommandError("Extra parameters of GESDT rejection "
                               "algorithm must be between 0 and 1, default "
                               "is 0.3 and 0.05")
        if sa.rejection == rj.PERCENTILE and (sa.siglow > 1
                                              or sa.sighigh > 1):
            raise CommandError("Extra parameters of percentile rejection "
                               "algorithm must be between 0 and 1, default "
                               "is 0.2 and 0.1")
    if isinstance(flags.get("norm"), str):
        sa.normalize = NORM_NAMES.get(flags["norm"].lower(), 0)
    sa.lite_norm = "fastnorm" in flags
    sa.force_norm = "force_norm" in flags
    sa.equalize_rgb = "rgb_equal" in flags
    if "weight_from_noise" in flags:
        sa.weighting = NOISE_WEIGHT
    elif "weight_from_wfwhm" in flags:
        sa.weighting = WFWHM_WEIGHT
    elif "weight_from_nbstars" in flags:
        sa.weighting = NBSTARS_WEIGHT
    elif "weight_from_nbstack" in flags:
        sa.weighting = NBSTACK_WEIGHT
    sa.overlap_norm = "overlap_norm" in flags
    if "feather" in flags and flags["feather"] is not True:
        sa.feather_dist = int(float(flags["feather"]))
    sa.create_rejmaps = "rejmap" in flags or "rejmaps" in flags
    sa.merge_rejmaps = flags.get("rejmap") == "merged"
    sa.output_norm = "output_norm" in flags
    sa.use_32bit = "16b" not in flags
    sa.maximize = "maximize" in flags
    return sa


@command("stack", "stack seqfilename {sum|min|max|med|rej} [type] "
         "[sigma_low sigma_high] [-norm=] [-weight_from_…] [-feather=] "
         "[-overlap_norm] [-maximize] [-filter-*=] [-upscale] [-out=] | "
         "stack seqfilename -drizzle [-scale=] [-pixfrac=] [-kernel=] "
         "[-out=]", min_args=1)
def cmd_stack(ctx: Session, args: List[str]) -> None:
    """Stack a registered sequence: normalization, weights and pixel
    rejection on the device; writes ``<seq>stacked.fit`` (or ``-out=``)
    and, with ``-rejmaps``, ``rejmap_low``/``rejmap_high``.  ``-drizzle``
    drizzles the registered frames into one float32 image instead;
    ``-upscale`` stacks a ×2 resampled copy of the selection."""
    from siril_tpu_torch.core.filtering import apply_filters, filter_specs
    from siril_tpu_torch.core.image import USHORT_IMG
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.stacking import stack_sequence

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    if "drizzle" in flags:
        _stack_drizzle(ctx, seq, flags)
        return
    sa = stack_args_from_flags(pos, flags)
    # setmem → device block budget (commands.py _apply_mem_budget)
    ratio = ctx.prefs.memory_ratio or 0.9
    sa.block_mb = max(int(2048 * min(ratio, 4.0)), 128)
    if "upscale" in flags:
        seq = _upscaled(ctx, pos[0], seq, sa.reglayer)
    indices = None
    specs = filter_specs(flags)
    if specs:
        indices = apply_filters(seq, specs, sa.reglayer)
        _log.info("Stacking filter: %d of %d frames kept", len(indices),
                  seq.number)
    res = stack_sequence(seq, sa, indices=indices, device=ctx.device)
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else seq.name + "stacked"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(res.image, p,
               bitdepth=FLOAT_IMG if sa.use_32bit else USHORT_IMG)
    ctx.image = res.image
    ctx.result = res
    ctx.stages = res.stage_s
    _log.info(
        "Stacked %d images, rejected %d/%d px (low/high) in %.2fs → %s",
        res.image.keywords.stackcnt, *res.total_rejected, res.elapsed_s,
        os.path.basename(p))
    _warn_capped(res)
    if sa.create_rejmaps and res.rejmap_low is not None:
        write_fits(res.rejmap_low, ctx.path("rejmap_low" + ctx.ext))
        if res.rejmap_high is not None:
            write_fits(res.rejmap_high, ctx.path("rejmap_high" + ctx.ext))




def _stack_drizzle(ctx: Session, seq, flags: dict) -> None:
    """``stack -drizzle``: the selected, registered frames drizzled into
    one float32 image (``drizzle_sequence``), written as ``-out=`` or
    ``<seq>stacked``; a CFA sequence gives three layers."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.drizzle import drizzle_sequence

    da = _drizzle_args(flags)
    da.use_bayer = seq.read_frame(int(seq.selected_indices()[0])).is_cfa()
    stages: dict = {}
    out, _ = drizzle_sequence(seq, da, device=ctx.device, stages=stages)
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else seq.name + "stacked"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(out, p, bitdepth=FLOAT_IMG)
    ctx.set_image(out, os.path.basename(p))
    ctx.stages = stages
    _log.info("Drizzle-stacked %d frames → %s", seq.selnum,
              os.path.basename(p))


def _upscaled(ctx: Session, seqname: str, seq, layer: int):
    """``stack -upscale`` (upscaling.c): the selected frames resampled ×2
    (lanczos4 with the clamp) into ``upscaled_<name>``, whose
    registration is the source's with its translation doubled, as the
    JAX package does (siril_tpu/cli/commands.py:1228-1245; not S·H·S⁻¹ of
    a projective H).  Without registration data the source sequence is
    stacked as it is, as there."""
    from siril_tpu_torch.ops.geometry import resample

    res = _seq_apply(ctx, seqname, "upscaled_", "upscale x2",
                     lambda im: resample(im, im.width * 2, im.height * 2,
                                         device=ctx.device))
    up = res.new_seq
    if up is None or not seq.has_reg(layer):
        return seq
    src, dst = seq.reg(layer), up.reg(layer)
    for k, i in enumerate(seq.selected_indices()[:up.number]):
        Hm = src.H[i].copy()
        Hm[0, 2] *= 2.0
        Hm[1, 2] *= 2.0
        dst.H[k] = Hm
        dst.valid[k] = src.valid[i]
    up.save()
    ctx.sequence = up
    return up


# ===========================================================================
# astrometry: plate solving, catalogues, annotations
# ===========================================================================


def _get_catalog(ctx: Session, flags: dict):
    """The catalogue of ``-catalog=``: a remote TAP catalogue by name
    (tycho2, nomad, gaiadr3, …: recorded fixtures, or the live service
    once ``online``), a binary Gaia ``.cat`` (HEALPix), a KStars binary
    (``.dat`` / ``.bin``, or a Tycho / NOMAD file), else an ``.npz`` /
    CSV catalogue; without the flag the installed local catalogue."""
    from siril_tpu_torch.astrometry.catalog import (
        Catalog,
        default_catalog_path,
    )
    from siril_tpu_torch.astrometry.remote import (
        TAP_CATALOGUES,
        RemoteCatalogue,
    )

    path = flags.get("catalog") if isinstance(flags.get("catalog"), str) \
        else default_catalog_path()
    if isinstance(path, str) and path.lower() in TAP_CATALOGUES:
        return RemoteCatalogue(path.lower(), online=ctx.online)
    if path is None:
        raise CommandError(
            "no local catalogue available (set -catalog=file.npz/csv/.cat, "
            "a remote name like -catalog=gaiadr3 with `online`, or "
            "SIRIL_TPU_CATALOG)")
    p = ctx.path(path)
    if p.lower().endswith(".cat"):
        # the cat_type byte at offset 50 picks the astrometric or the
        # photometric (XP) reader (healpix_cat.h:11-21)
        from siril_tpu_torch.astrometry.gaia_local import (
            CAT_XPCTS,
            CAT_XPSAMP,
            GaiaLocalCatalogue,
            GaiaXPLocalCatalogue,
        )

        with open(p, "rb") as f:
            hdr = f.read(51)
        if len(hdr) > 50 and hdr[50] in (CAT_XPSAMP, CAT_XPCTS):
            return GaiaXPLocalCatalogue(p)
        return GaiaLocalCatalogue(p)
    if p.lower().endswith((".dat", ".bin")) or "tycho" in p.lower() \
            or "nomad" in os.path.basename(p).lower():
        from siril_tpu_torch.astrometry.kstars_local import KStarsCatalogue

        try:
            return KStarsCatalogue(p)
        except ValueError:
            pass
    return Catalog.load(p)


def _solve_args(flags: dict, radec: List[str]):
    """SolveArgs of ``[ra dec] -focal= -pixelsize= -limitmag= -order=
    -radius=``."""
    from siril_tpu_torch.astrometry.solver import SolveArgs
    from siril_tpu_torch.ops.wcs import parse_dec, parse_ra

    sa = SolveArgs()
    if len(radec) >= 2:
        sa.ra = parse_ra(radec[0])
        sa.dec = parse_dec(radec[1])
    for key, attr, conv in (("focal", "focal_mm", float),
                            ("pixelsize", "pixel_size_um", float),
                            ("limitmag", "mag_limit", float),
                            ("order", "sip_order", lambda v: int(float(v))),
                            ("radius", "radius_deg", float)):
        if key in flags:
            setattr(sa, attr, conv(flags[key]))
    return sa


def _centre(img):
    """(RA, Dec) of the image centre under its WCS."""
    ra, dec = img.wcs.pix2world(np.array([img.width / 2.0]),
                                np.array([img.height / 2.0]))
    return float(ra[0]), float(dec[0])


@command("platesolve", "platesolve [ra dec] [-focal=] [-pixelsize=] "
         "[-catalog=] [-limitmag=] [-order=] [-radius=] [-force]")
def cmd_platesolve(ctx: Session, args: List[str]) -> None:
    """Plate-solve the loaded image (stars detected on the session's
    device); its WCS is kept with the image and written by ``save``."""
    from siril_tpu_torch.astrometry.solver import solve_image
    from siril_tpu_torch.ops.wcs import format_dec, format_ra

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    if img.wcs is not None and "force" not in flags:
        _log.info("image is already plate solved (use -force)")
        return
    stages: dict = {}
    try:
        res = solve_image(img, _get_catalog(ctx, flags),
                          _solve_args(flags, pos), device=ctx.device,
                          stages=stages)
    except ValueError as e:
        raise CommandError(str(e))
    ctx.stages = stages
    if res is None:
        raise CommandError("plate solve failed")
    ra_c, dec_c = _centre(img)
    _log.info("Image center: RA %s, Dec %s", format_ra(ra_c),
              format_dec(dec_c))


@command("seqplatesolve", "seqplatesolve sequencename [ra dec] [-focal=] "
         "[-pixelsize=] [-catalog=] [-limitmag=] [-order=]", min_args=1)
def cmd_seqplatesolve(ctx: Session, args: List[str]) -> None:
    """Plate-solve every selected frame and write its WCS into its file;
    each solved frame's centre seeds the next (the reference's sequence
    solve caches the catalogue and the previous solution)."""
    from siril_tpu_torch.astrometry.solver import solve_image
    from siril_tpu_torch.io.fits_io import write_fits

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    sa = _solve_args(flags, pos[1:3])
    cat = _get_catalog(ctx, flags)
    stages: dict = {}
    solved = 0
    for i in seq.selected_indices():
        i = int(i)
        img = seq.read_frame(i)
        try:
            res = solve_image(img, cat, sa, device=ctx.device,
                              stages=stages)
        except ValueError as e:
            raise CommandError(str(e))
        if res is None:
            _log.warning("frame %d: plate solve failed", i + 1)
            continue
        p = seq.frame_path(i)
        if p is not None:
            t = time.perf_counter()
            write_fits(img, p, bitdepth=img.orig_bitdepth)
            stages["write"] = stages.get("write", 0.0) + \
                time.perf_counter() - t
        solved += 1
        sa.ra, sa.dec = _centre(img)
    ctx.sequence = seq
    ctx.stages = stages
    _log.info("seqplatesolve: %d/%d frames solved", solved, seq.number)


@command("conesearch", "conesearch [limit_mag] [-catalog=] [-out=]")
def cmd_conesearch(ctx: Session, args: List[str]) -> int:
    """The catalogue stars in the solved image's field (a cone of ⅔ of
    its diagonal field); ``-out=`` writes them as CSV.  Returns their
    count."""
    pos, flags = parse_flags(args)
    img = ctx.require_image()
    if img.wcs is None:
        raise CommandError("image is not plate solved")
    mag = float(pos[0]) if pos else 13.0
    w = img.wcs
    ra_c, dec_c = _centre(img)
    fov = w.pixel_scale_arcsec * max(img.width, img.height) / 3600.0
    cone = _get_catalog(ctx, flags).cone_search(ra_c, dec_c, fov / 1.5, mag)
    xs, ys = w.world2pix(cone.ra, cone.dec)
    inside = [k for k in range(len(cone))
              if 0 <= xs[k] < img.width and 0 <= ys[k] < img.height]
    _log.info("%d catalogue objects in the field (of %d in cone)",
              len(inside), len(cone))
    out = flags.get("out")
    if isinstance(out, str):
        with open(ctx.path(out), "w") as f:
            f.write("ra,dec,mag,x,y\n")
            for k in inside:
                f.write(f"{cone.ra[k]:.6f},{cone.dec[k]:.6f},"
                        f"{cone.mag[k]:.3f},{xs[k]:.2f},{ys[k]:.2f}\n")
        _log.info("catalogue written to %s", out)
    return len(inside)


@command("catsearch", "catsearch name", min_args=1)
def cmd_catsearch(ctx: Session, args: List[str]):
    """An object by name: the local annotation catalogues, else SIMBAD
    (recorded fixtures, or the live service once ``online``).  Returns
    (RA, Dec, name)."""
    from siril_tpu_torch.astrometry.annotations import find_object
    from siril_tpu_torch.astrometry.remote import (
        TransportError,
        search_object,
    )
    from siril_tpu_torch.ops.wcs import format_dec, format_ra

    name = " ".join(args)
    a = find_object(name)
    if a is not None:
        hit = (a.ra, a.dec, a.name)
    else:
        try:
            hit = search_object(name, online=ctx.online)
        except TransportError as e:
            raise CommandError(f"object '{name}' not found locally and "
                               f"remote lookup unavailable ({e})")
        if hit is None:
            raise CommandError(f"object '{name}' not found")
    _log.info("%s: RA %s, Dec %s", hit[2], format_ra(hit[0]),
              format_dec(hit[1]))
    return hit


@command("show", "show [name]")
def cmd_show(ctx: Session, args: List[str]):
    """The annotation catalogues' objects in the solved image (returned),
    or one object by name and its pixel."""
    from siril_tpu_torch.astrometry.annotations import (
        annotate_image,
        find_object,
    )

    img = ctx.require_image()
    if args:
        a = find_object(args[0])
        if a is None:
            raise CommandError(f"object '{args[0]}' not found in local "
                               "catalogues")
        if img.wcs is not None:
            x, y = img.wcs.world2pix(np.array([a.ra]), np.array([a.dec]))
            a.x, a.y = float(x[0]), float(y[0])
            _log.info("%s: RA=%.4f Dec=%.4f → pixel (%.1f, %.1f)", a.name,
                      a.ra, a.dec, a.x, a.y)
        else:
            _log.info("%s: RA=%.4f Dec=%.4f", a.name, a.ra, a.dec)
        return [a]
    try:
        anns = annotate_image(img)
    except ValueError as e:
        raise CommandError(str(e))
    for a in anns:
        _log.info("%s at (%.1f, %.1f)", a.name, a.x, a.y)
    _log.info("%d annotation(s) in field", len(anns))
    return anns


@command("disto", "disto [clear]")
def cmd_disto(ctx: Session, args: List[str]):
    """The solved image's SIP distortion on a 9 × 9 grid: returns (max,
    mean) of its amplitude in pixels, or None without SIP terms.  The
    polynomials are evaluated in ``WCS.pix2world``'s frame (FITS
    bottom-up v); the JAX command evaluates them at top-down offsets
    from CRPIX (ROADMAP §3)."""
    from siril_tpu_torch.ops.wcs import _sip_eval, sip_frame

    img = ctx.require_image()
    if args and args[0] == "clear":
        _log.info("distortion display disabled")
        return None
    w = img.wcs
    if w is None:
        raise CommandError("image is not plate solved")
    if w.sip_a is None:
        _log.info("No distortion terms in the WCS solution")
        return None
    gx, gy = np.meshgrid(np.linspace(0, img.width - 1, 9),
                         np.linspace(0, img.height - 1, 9))
    x0, y0, ysign = sip_frame(w.crpix, w.height)
    u, v = gx - x0, ysign * (gy - y0)
    amp = np.hypot(_sip_eval(w.sip_a, u, v), _sip_eval(w.sip_b, u, v))
    _log.info("Distortion field: max %.2f px, mean %.2f px (SIP order %d)",
              amp.max(), amp.mean(), w.sip_a.shape[0] - 1)
    return float(amp.max()), float(amp.mean())


@command("healpix", "healpix")
def cmd_healpix(ctx: Session, args: List[str]):
    """The NESTED HEALPix pixels (order 8, grouped by order-1 parent) that
    the solved image covers; returns the order-8 pixels."""
    from siril_tpu_torch.astrometry.healpix import (
        image_footprint_pixels,
        nest_parent,
    )

    img = ctx.require_image()
    if img.wcs is None:
        raise CommandError("image is not plate solved")
    pix8 = image_footprint_pixels(img.wcs, img.width, img.height, 256)
    parents = nest_parent(pix8, 8, 1)
    _log.info("HEALPix NESTED coverage: %d level-1 pixel(s), %d level-8 "
              "pixel(s)", len(np.unique(parents)), len(pix8))
    for p1 in np.unique(parents):
        kids = pix8[parents == p1]
        _log.info("  level1 %d: level8 %s%s", int(p1),
                  ", ".join(str(int(k)) for k in kids[:32]),
                  " …" if len(kids) > 32 else "")
    return pix8


@command("trixel", "trixel [-p]")
def cmd_trixel(ctx: Session, args: List[str]):
    """The level-3 HTM trixels the solved image covers (returned); ``-p``
    writes every star of the catalogue with its trixel to
    ``trixels.csv``."""
    from siril_tpu_torch.astrometry.healpix import (
        image_footprint_trixels,
        radec_to_htm,
    )

    _, flags = parse_flags(args)
    if "p" in flags:
        cat = _get_catalog(ctx, {})
        ids = radec_to_htm(cat.ra, cat.dec, 3)
        with open(ctx.path("trixels.csv"), "w") as f:
            f.write("trixel,ra,dec,mag\n")
            for i in np.argsort(ids):
                f.write(f"{int(ids[i])},{cat.ra[i]:.6f},{cat.dec[i]:.6f},"
                        f"{cat.mag[i]:.3f}\n")
        _log.info("trixels.csv written (%d stars)", len(ids))
        return ids
    img = ctx.require_image()
    if img.wcs is None:
        raise CommandError("image is not plate solved")
    trix = image_footprint_trixels(img.wcs, img.width, img.height, 3)
    _log.info("%d level-3 trixels visible: %s", len(trix),
              " ".join(str(int(t)) for t in trix))
    return trix


@command("online", "online")
def cmd_online(ctx: Session, args: List[str]) -> None:
    ctx.online = True
    _log.info("online mode: remote catalogues enabled (TAP cone search, "
              "SIMBAD object lookup)")


@command("offline", "offline")
def cmd_offline(ctx: Session, args: List[str]) -> None:
    ctx.online = False
    _log.info("offline mode (local catalogues only)")


# ===========================================================================
# the image ops: geometry, stretches, colour, background
# ===========================================================================


def _need_rgb(ctx: Session, name: str):
    img = ctx.require_image()
    if img.nchans != 3:
        raise CommandError(f"Command {name} requires an RGB image")
    return img


def _keep(ctx: Session, img) -> None:
    """The loaded image becomes ``img``; its name stays."""
    ctx.set_image(img, ctx.image_name)


def _interp_flag(flags: dict) -> int:
    from siril_tpu_torch.ops.interp import INTERP_NAMES

    return INTERP_NAMES.get(str(flags.get("interp", "la")).lower(), 3)


@command("crop", "crop [x y width height]")
def cmd_crop(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import crop

    img = ctx.require_image()
    if len(args) >= 4:
        x, y, w, h = (int(float(a)) for a in args[:4])
    elif ctx.selection:
        x, y, w, h = ctx.selection
    else:
        raise CommandError("crop needs coordinates or a selection")
    _keep(ctx, crop(img, x, y, w, h, device=ctx.device))


@command("resample", "resample factor | -width= | -height= [-interp=] "
         "[-noclamp]", min_args=1)
def cmd_resample(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import resample

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    if pos:
        f = float(pos[0])
        w, h = int(img.width * f), int(img.height * f)
    elif "width" in flags:
        w = int(float(flags["width"]))
        h = int(round(img.height * w / img.width))
    elif "height" in flags:
        h = int(float(flags["height"]))
        w = int(round(img.width * h / img.height))
    else:
        raise CommandError("resample needs a factor or -width=/-height=")
    _keep(ctx, resample(img, w, h, _interp_flag(flags),
                        clamp="noclamp" not in flags, device=ctx.device))


@command("rotate", "rotate degree [-nocrop] [-interp=] [-noclamp]",
         min_args=1)
def cmd_rotate(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import rotate

    pos, flags = parse_flags(args)
    _keep(ctx, rotate(ctx.require_image(), float(pos[0]), _interp_flag(flags),
                      crop_to_fit="nocrop" not in flags,
                      clamp="noclamp" not in flags, device=ctx.device))


@command("rotatepi", "rotatePi")
def cmd_rotatepi(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import rotate

    _keep(ctx, rotate(ctx.require_image(), 180.0, device=ctx.device))


@command("mirrorx", "mirrorx [-bottomup]")
def cmd_mirrorx(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import mirrorx

    _keep(ctx, mirrorx(ctx.require_image(), device=ctx.device))


@command("mirrory", "mirrory")
def cmd_mirrory(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import mirrory

    _keep(ctx, mirrory(ctx.require_image(), device=ctx.device))


@command("binxy", "binxy coefficient [-sum]", min_args=1)
def cmd_binxy(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import binxy

    pos, flags = parse_flags(args)
    _keep(ctx, binxy(ctx.require_image(), int(float(pos[0])),
                     mean="sum" not in flags, device=ctx.device))


@command("autostretch", "autostretch [-linked] [shadowsclip [targetbg]]")
def cmd_autostretch(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import autostretch

    pos, flags = parse_flags(args)
    shadows = float(pos[0]) if pos else -2.80
    target = float(pos[1]) if len(pos) > 1 else 0.25
    _keep(ctx, autostretch(ctx.require_image(), shadows, target,
                           linked="linked" in flags, device=ctx.device))


def _mtf_params(args: List[str]):
    from siril_tpu_torch.ops.stretch import MTFParams

    return MTFParams(shadows=float(args[0]), midtones=float(args[1]),
                     highlights=float(args[2]))


@command("mtf", "mtf low mid high [channels]", min_args=3)
def cmd_mtf(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import apply_mtf

    _keep(ctx, apply_mtf(ctx.require_image(), _mtf_params(args),
                         device=ctx.device))


@command("invmtf", "invmtf low mid high", min_args=3)
def cmd_invmtf(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import invmtf

    _keep(ctx, invmtf(ctx.require_image(), _mtf_params(args),
                      device=ctx.device))


@command("asinh", "asinh [-human] stretch [offset]", min_args=1)
def cmd_asinh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import asinh_stretch

    pos, flags = parse_flags(args)
    beta = float(pos[0])
    offset = float(pos[1]) if len(pos) > 1 else 0.0
    _keep(ctx, asinh_stretch(ctx.require_image(), beta, offset,
                             human_luminance="human" in flags,
                             device=ctx.device))


def _ght_cmd(ctx: Session, args: List[str], stretchtype: int) -> None:
    """-D= -B= -LP= -SP= -HP= -BP= (or D B LP SP HP as words) and the
    colour model (-human, -even, -sat, -independent)."""
    from siril_tpu_torch.ops.stretch import (
        COL_EVENLUM,
        COL_HUMANLUM,
        COL_INDEP,
        COL_SAT,
        GHTParams,
        apply_ght,
    )

    pos, flags = parse_flags(args)
    p = GHTParams(stretchtype=stretchtype)
    p.D = _f(flags.get("d"), None)
    p.B = _f(flags.get("b"), 0.0) or 0.0
    p.LP = _f(flags.get("lp"), 0.0) or 0.0
    p.SP = _f(flags.get("sp"), 0.0) or 0.0
    p.HP = _f(flags.get("hp"), 1.0) or 1.0
    p.BP = _f(flags.get("bp"), 0.0) or 0.0
    if p.D is None:
        if not pos:
            raise CommandError("ght needs -D= or positional D")
        vals = [float(x) for x in pos]
        for attr, v in zip(("D", "B", "LP", "SP", "HP"), vals):
            setattr(p, attr, v)
    for flag, model in (("human", COL_HUMANLUM), ("even", COL_EVENLUM),
                        ("sat", COL_SAT), ("independent", COL_INDEP)):
        if flag in flags:
            p.payne_colourstretchmodel = model
            break
    _keep(ctx, apply_ght(ctx.require_image(), p, device=ctx.device))


@command("ght", "ght -D= [-B=] [-LP=] [-SP=] [-HP=] [-human|-even|-sat]",
         min_args=1)
def cmd_ght(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_PAYNE_NORMAL

    _ght_cmd(ctx, args, STRETCH_PAYNE_NORMAL)


@command("invght", "invght -D= …", min_args=1)
def cmd_invght(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_PAYNE_INVERSE

    _ght_cmd(ctx, args, STRETCH_PAYNE_INVERSE)


@command("modasinh", "modasinh -D= …", min_args=1)
def cmd_modasinh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_ASINH

    _ght_cmd(ctx, args, STRETCH_ASINH)


@command("invmodasinh", "invmodasinh -D= …", min_args=1)
def cmd_invmodasinh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_INVASINH

    _ght_cmd(ctx, args, STRETCH_INVASINH)


@command("linstretch", "linstretch -BP=", min_args=1)
def cmd_linstretch(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import linstretch

    pos, flags = parse_flags(args)
    bp = _f(flags.get("bp"), None)
    if bp is None and pos:
        bp = float(pos[0])
    _keep(ctx, linstretch(ctx.require_image(), bp or 0.0, device=ctx.device))


@command("autoghs", "autoghs [-linked] shadowsclip stretchamount [-b=] "
         "[-hp=] [-lp=]", min_args=2)
def cmd_autoghs(ctx: Session, args: List[str]) -> None:
    """A GHT with SP at the layers' mean median + shadowsclip·MAD·1.4826
    (the mean MAD), D the stretch amount, B 13 and HP 0.7 by default."""
    from siril_tpu_torch.ops.statistics import STATS_MAD, compute_stats_np
    from siril_tpu_torch.ops.stretch import GHTParams, apply_ght

    pos, flags = parse_flags(args)
    shadows_clip = float(pos[0])
    amount = float(pos[1])
    img = ctx.require_image()
    data = img.host()
    stats = [compute_stats_np(data[c], STATS_MAD) for c in range(img.nchans)]
    m = float(np.mean([s.median for s in stats]))
    mad = float(np.mean([s.mad for s in stats])) * 1.4826
    p = GHTParams(D=amount, B=_f(flags.get("b"), 13.0) or 13.0,
                  SP=max(m + shadows_clip * mad, 0.0),
                  LP=_f(flags.get("lp"), 0.0) or 0.0,
                  HP=_f(flags.get("hp"), 0.7) or 0.7)
    _keep(ctx, apply_ght(img, p, device=ctx.device))


@command("neg", "neg")
def cmd_neg(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.colors import negative

    _keep(ctx, negative(ctx.require_image(), device=ctx.device))


@command("rmgreen", "rmgreen [type] [-nopreserve]")
def cmd_rmgreen(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.colors import scnr

    img = _need_rgb(ctx, "rmgreen")
    pos, flags = parse_flags(args)
    t = "avgneutral" if not pos or pos[0] == "0" else "maxneutral"
    _keep(ctx, scnr(img, t, preserve_lightness="nopreserve" not in flags,
                    device=ctx.device))


#: satu's hue ranges by index (6, every hue, is the default)
SATU_HUES = [(330, 30), (30, 90), (90, 150), (150, 210), (210, 270),
             (270, 330), (0, 360)]


@command("satu", "satu amount [background_factor [hue_range_index]]",
         min_args=1)
def cmd_satu(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.colors import saturation

    img = _need_rgb(ctx, "satu")
    amount = float(args[0])
    bkg = float(args[1]) if len(args) > 1 else 1.0
    hr = SATU_HUES[int(float(args[2]))] if len(args) > 2 else SATU_HUES[6]
    _keep(ctx, saturation(img, amount, bkg, hr[0], hr[1], device=ctx.device))


@command("ccm", "ccm m00 m01 m02 m10 m11 m12 m20 m21 m22 [gamma]",
         min_args=9)
def cmd_ccm(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.colors import apply_ccm

    img = _need_rgb(ctx, "ccm")
    m = [float(a) for a in args[:9]]
    gamma = float(args[9]) if len(args) > 9 else 1.0
    _keep(ctx, apply_ccm(img, m, gamma, device=ctx.device))


@command("split", "split r g b [-hsl|-hsv|-lab]", min_args=3)
def cmd_split(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.colors import split_channels

    img = _need_rgb(ctx, "split")
    pos, flags = parse_flags(args)
    space = "rgb"
    for s in ("hsl", "hsv", "lab"):
        if s in flags:
            space = s
    for name, im in zip(pos[:3], split_channels(img, space,
                                                device=ctx.device)):
        write_fits(im, ctx.path(name + ctx.ext))
    _log.info("Split into %s channels", space)


def _load_operand(ctx: Session, name: str):
    from siril_tpu_torch.io.conversion import load_any

    p = ctx.path(name)
    if not os.path.exists(p):
        p = p + ctx.ext
    return load_any(p)


@command("rgbcomp", "rgbcomp r g b [-lum=] [-align] [-out=]", min_args=3)
def cmd_rgbcomp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.colors import align_rgb_channels, rgb_compose

    pos, flags = parse_flags(args)
    lum = _load_operand(ctx, flags["lum"]) \
        if isinstance(flags.get("lum"), str) else None
    r, g, b = (_load_operand(ctx, p) for p in pos[:3])
    out = rgb_compose(r, g, b, lum=lum, device=ctx.device)
    if "align" in flags:
        out = align_rgb_channels(out, device=ctx.device)
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else "composed"
    write_fits(out, ctx.path(name + ctx.ext))
    ctx.set_image(out, name)


@command("subsky", "subsky {-rbf | degree} [-samples=] [-tolerance=] "
         "[-smooth=] [-dither] [-divide]", min_args=1)
def cmd_subsky(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.background import (
        BKG_POLY,
        BKG_RBF,
        DIVIDE,
        SUBTRACT,
        extract_background,
    )

    pos, flags = parse_flags(args)
    if "rbf" in flags:
        method, degree = BKG_RBF, 0
    else:
        method, degree = BKG_POLY, int(float(pos[0])) if pos else 4
    corr = DIVIDE if str(flags.get("mode", "")).lower() == "divide" \
        or "divide" in flags else SUBTRACT
    _keep(ctx, extract_background(
        ctx.require_image(), method, degree,
        smoothing=_f(flags.get("smooth"),
                     _f(flags.get("smoothness"), 0.5)) or 0.5,
        nb_samples=int(_f(flags.get("samples"), 20) or 20),
        tolerance=_f(flags.get("tolerance"), 1.0) or 1.0,
        correction=corr, dither="dither" in flags, device=ctx.device,
        stages=ctx.stages))


# ===========================================================================
# photometry and colour calibration
# ===========================================================================


def _phot_cfg(ctx: Session):
    return dataclasses.replace(ctx.phot)


@command("pcc", "pcc [-limitmag=] [-catalog=]")
def cmd_pcc(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.astrometry.pcc import photometric_color_calibration

    img = _need_rgb(ctx, "pcc")
    pos, flags = parse_flags(args)
    cat = _get_catalog(ctx, flags)
    out = photometric_color_calibration(
        img, cat, mag_limit=_f(flags.get("limitmag"), 13.0) or 13.0,
        device=ctx.device, stages=ctx.stages)
    if out is None:
        raise CommandError("PCC failed")
    _keep(ctx, out)


@command("bgneutralize", "bgneutralize")
def cmd_bgneutralize(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.astrometry.pcc import background_neutralization

    _keep(ctx, background_neutralization(_need_rgb(ctx, "bgneutralize"),
                                         device=ctx.device,
                                         stages=ctx.stages))


@command("setphot", "setphot [-inner=] [-outer=] [-aperture=] "
         "[-force_radius=] [-gain=]")
def cmd_setphot(ctx: Session, args: List[str]) -> None:
    """The photometry settings that catmag's measurements take (the
    reference's -min_val= and -max_val= are read and not used, as in the
    JAX package)."""
    pos, flags = parse_flags(args)
    p = ctx.phot
    for key in ("inner", "outer", "aperture", "gain"):
        if key in flags:
            setattr(p, key, float(flags[key]))
    if "force_radius" in flags:
        p.force_radius = str(flags["force_radius"]).lower() in (
            "1", "yes", "true")
    _log.info("photometry: inner=%s outer=%s aperture=%s gain=%s",
              p.inner, p.outer, p.aperture, p.gain)


@command("spcc", "spcc [-limitmag=] [-monosensor=|-oscsensor=] [-rfilter=] "
         "[-gfilter=] [-bfilter=] [-oscfilter=] [-narrowband [-rwl= -gwl= "
         "-bwl= -rbw= -gbw= -bbw=]] [-atmos [-obsheight=] "
         "[-pressure=|-slp=]] [-catalog=]")
def cmd_spcc(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.astrometry.spcc import (
        ResponseLibrary,
        atmospheric_transmission,
        narrowband_filters,
        spcc,
    )

    img = _need_rgb(ctx, "spcc")
    pos, flags = parse_flags(args)
    cat = _get_catalog(ctx, flags)
    sensor = str(flags.get("monosensor") or flags.get("oscsensor")
                 or flags.get("sensor") or "generic_qe")
    filters = (str(flags.get("rfilter", "R")),
               str(flags.get("gfilter", "G")),
               str(flags.get("bfilter", "B")))
    if isinstance(flags.get("oscfilter"), str):
        filters = (flags["oscfilter"],) * 3
    extra_resp = None
    if "narrowband" in flags:
        extra_resp = narrowband_filters(
            **{k: _f(flags.get(k), d) or d for k, d in (
                ("rwl", 656.28), ("gwl", 500.7), ("bwl", 500.7),
                ("rbw", 3.0), ("gbw", 3.0), ("bbw", 3.0))})
    atmos = None
    if "atmos" in flags:
        atmos = atmospheric_transmission(
            obsheight_m=_f(flags.get("obsheight"), 0.0) or 0.0,
            pressure_mbar=_f(flags.get("pressure"),
                             _f(flags.get("slp"), None)))
    out = spcc(img, cat, sensor=sensor, filters=filters,
               library=ResponseLibrary(),
               mag_limit=_f(flags.get("limitmag"), 13.0) or 13.0,
               extra_responses=extra_resp, atmosphere=atmos,
               device=ctx.device, stages=ctx.stages)
    if out is None:
        raise CommandError("SPCC failed")
    _keep(ctx, out)


@command("spcc_list", "spcc_list {sensors|filters}")
def cmd_spcc_list(ctx: Session, args: List[str]) -> List[str]:
    from siril_tpu_torch.astrometry.spcc import ResponseLibrary

    names = ResponseLibrary().names()
    for name in names:
        _log.info("%s", name)
    return names


@command("findcompstars", "findcompstars x y [-dvmag=] [-dbv=] [-emag=] "
         "[-narrow|-wide] [-out=] [-catalog=]", min_args=2)
def cmd_findcompstars(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.astrometry.compstars import (
        CompStarArgs,
        export_compstars_list,
        export_nina_csv,
        find_comp_stars,
    )

    pos, flags = parse_flags(args)
    cat = _get_catalog(ctx, flags)
    ca = CompStarArgs()
    if "emag" in flags:
        ca.max_emag = float(flags["emag"])
    if "narrow" in flags:
        ca.narrow_fov = True
    if "wide" in flags:
        ca.narrow_fov = False
    if "dvmag" in flags:
        ca.delta_vmag = float(flags["dvmag"])
    if "dbv" in flags:
        ca.delta_bv = float(flags["dbv"])
    try:
        target, comps = find_comp_stars(
            ctx.require_image(), cat, (float(pos[0]), float(pos[1])), ca)
    except ValueError as e:
        raise CommandError(str(e))
    out = flags.get("out") if isinstance(flags.get("out"), str) \
        else "compstars"
    export_compstars_list(target, comps, ctx.path(out + ".lst"))
    export_nina_csv(target, comps, ctx.path(out + ".csv"))
    _log.info("wrote %s.lst and %s.csv", out, out)


@command("catmag", "catmag [reftemp] [dtemp]")
def cmd_catmag(ctx: Session, args: List[str]) -> float:
    """The absolute magnitude offset (process_catmag_mono): stars detected
    on the session's device matched to the catalogue within 4 px, the
    offset median(catalogue − instrumental magnitude)."""
    import torch

    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.ops.photometry import measure_star
    from siril_tpu_torch.registration.starfinder import detect_stars

    img = ctx.require_image()
    if img.wcs is None:
        raise CommandError("image is not plate solved")
    cat = _get_catalog(ctx, {})
    w = img.wcs
    ra_c, dec_c = w.pix2world(np.array([img.width / 2.0]),
                              np.array([img.height / 2.0]))
    fov = w.pixel_scale_arcsec * max(img.width, img.height) / 3600.0
    cone = cat.cone_search(float(ra_c[0]), float(dec_c[0]), fov / 1.5, 15.0)
    cx, cy = w.world2pix(cone.ra, cone.dec)
    lay = img.host()[1 if img.nchans == 3 else 0]
    stars = detect_stars(torch.from_numpy(lay).to(resolve_device(ctx.device)),
                         _sf_params(ctx))
    cvf = float(img.keywords.extra.get("CVF", 0.0) or 0.0)
    offs = []
    for s in stars:
        d2 = (cx - s.x0) ** 2 + (cy - s.y0) ** 2
        k = int(np.argmin(d2))
        if d2[k] > 4.0 ** 2:
            continue
        phot = measure_star(lay, s.x0, s.y0, s.fwhmx, _phot_cfg(ctx),
                            cvf or None)
        if phot.valid and np.isfinite(cone.mag[k]):
            offs.append(float(cone.mag[k]) - phot.mag)
    if len(offs) < 3:
        raise CommandError("catmag: not enough matched stars")
    ctx.magnitude_offset = float(np.median(offs))
    _log.info("Absolute magnitude offset: %.3f (%d stars)",
              ctx.magnitude_offset, len(offs))
    return ctx.magnitude_offset


@command("eqcrop", "eqcrop ra1 dec1 ra2 dec2 [-marginpx=|-marginasec=] "
         "[-minsize=]", min_args=4)
def cmd_eqcrop(ctx: Session, args: List[str]) -> None:
    """Crop to a sky-coordinate rectangle (process_eqcrop)."""
    from siril_tpu_torch.ops.geometry import crop
    from siril_tpu_torch.ops.wcs import parse_dec, parse_ra

    img = ctx.require_image()
    if img.wcs is None:
        raise CommandError("image is not plate solved")
    pos, flags = parse_flags(args)
    ra1, dec1 = parse_ra(pos[0]), parse_dec(pos[1])
    ra2, dec2 = parse_ra(pos[2]), parse_dec(pos[3])
    xs, ys = img.wcs.world2pix(np.array([ra1, ra2]), np.array([dec1, dec2]))
    margin = int(_f(flags.get("marginpx"), 0) or 0)
    if "marginasec" in flags:
        margin = int(round(float(flags["marginasec"])
                           / img.wcs.pixel_scale_arcsec))
    x0 = max(0, int(np.floor(min(xs))) - margin)
    x1 = min(img.width, int(np.ceil(max(xs))) + margin)
    y0 = max(0, int(np.floor(min(ys))) - margin)
    y1 = min(img.height, int(np.ceil(max(ys))) + margin)
    minsize = int(_f(flags.get("minsize"), 32) or 32)
    if x1 - x0 < minsize or y1 - y0 < minsize:
        raise CommandError("eqcrop: target region too small or outside "
                           "the image")
    _keep(ctx, crop(img, x0, y0, x1 - x0, y1 - y0, device=ctx.device))
    _log.info("eqcrop: %dx%d at (%d,%d)", x1 - x0, y1 - y0, x0, y0)


# ===========================================================================
# the enhancement session: filters, wavelets, denoising, deconvolution,
# arithmetic, pixel math, masks
# ===========================================================================


@command("ddp", "ddp level coef sigma", min_args=3)
def cmd_ddp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import ddp

    _keep(ctx, ddp(ctx.require_image(), float(args[0]), float(args[1]),
                   float(args[2]), device=ctx.device))


@command("thresh", "thresh lo hi", min_args=2)
def cmd_thresh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import thresh

    _keep(ctx, thresh(ctx.require_image(), float(args[0]) / 65535.0,
                      float(args[1]) / 65535.0))


@command("threshlo", "threshlo level", min_args=1)
def cmd_threshlo(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import threshlo

    _keep(ctx, threshlo(ctx.require_image(), float(args[0]) / 65535.0))


@command("threshhi", "threshhi level", min_args=1)
def cmd_threshhi(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import threshhi

    _keep(ctx, threshhi(ctx.require_image(), float(args[0]) / 65535.0))


@command("nozero", "nozero level", min_args=1)
def cmd_nozero(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import nozero

    _keep(ctx, nozero(ctx.require_image(), float(args[0]) / 65535.0))


@command("fill", "fill value [x y w h]", min_args=1)
def cmd_fill(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import fill

    area = tuple(int(float(a)) for a in args[1:5]) if len(args) >= 5 \
        else None
    _keep(ctx, fill(ctx.require_image(), float(args[0]) / 65535.0, area))


@command("ffill", "ffill value [x y width height]", min_args=1)
def cmd_ffill(ctx: Session, args: List[str]) -> None:
    """Symmetric fill (process_ffill): the region and its point-symmetric
    counterpart about the image centre."""
    from siril_tpu_torch.ops.filters import fill

    img = ctx.require_image()
    v = float(args[0]) / 65535.0
    if len(args) >= 5:
        x, y, w, h = (int(float(a)) for a in args[1:5])
    elif ctx.selection:
        x, y, w, h = ctx.selection
    else:
        x, y, w, h = 0, 0, img.width, img.height
    out = fill(img, v, (x, y, w, h))
    out = fill(out, v, (max(img.width - x - w, 0),
                        max(img.height - y - h, 0), w, h))
    _keep(ctx, out)


@command("gauss", "gauss sigma", min_args=1)
def cmd_gauss(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import gauss

    _keep(ctx, gauss(ctx.require_image(), float(args[0]), device=ctx.device))


@command("unsharp", "unsharp sigma multi", min_args=2)
def cmd_unsharp(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import unsharp

    _keep(ctx, unsharp(ctx.require_image(), float(args[0]), float(args[1]),
                       device=ctx.device))


@command("fmedian", "fmedian ksize modulation", min_args=2)
def cmd_fmedian(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import median_filter

    _keep(ctx, median_filter(ctx.require_image(), int(float(args[0])),
                             float(args[1]), device=ctx.device))


@command("clahe", "clahe cliplimit tileSize", min_args=2)
def cmd_clahe(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import clahe

    _keep(ctx, clahe(ctx.require_image(), float(args[0]),
                     int(float(args[1])), device=ctx.device))


@command("epf", "epf [-guided] [-d=] [-si=] [-ss=] [-mod=]")
def cmd_epf(ctx: Session, args: List[str]) -> None:
    """The bilateral filter, or with ``-guided`` the guided filter (eps
    = si², as the JAX package reads it; ``-mod=0`` reads as 1)."""
    from siril_tpu_torch.ops.filters import bilateral, guided_filter

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    mod = _f(flags.get("mod"), 1.0) or 1.0
    if "guided" in flags:
        out = guided_filter(img, radius=int(_f(flags.get("d"), 8) or 8),
                            eps=(_f(flags.get("si"), 0.1) or 0.1) ** 2,
                            mod=mod, device=ctx.device)
    else:
        out = bilateral(img, d=_f(flags.get("d"), 5) or 5,
                        sigma_col=_f(flags.get("si"), 0.1) or 0.1,
                        sigma_spatial=_f(flags.get("ss"), 3.0) or 3.0,
                        mod=mod, device=ctx.device)
    _keep(ctx, out)


@command("fixbanding", "fixbanding amount sigma [-vertical]", min_args=2)
def cmd_fixbanding(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import fix_banding

    pos, flags = parse_flags(args)
    _keep(ctx, fix_banding(ctx.require_image(), sigma=float(pos[1]),
                           amount=float(pos[0]),
                           vertical="vertical" in flags))


@command("unpurple", "unpurple [-blue=] [-strength=]")
def cmd_unpurple(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import unpurple

    pos, flags = parse_flags(args)
    _keep(ctx, unpurple(_need_rgb(ctx, "unpurple"),
                        blue_threshold=_f(flags.get("blue"), 0.2) or 0.2,
                        strength=_f(flags.get("strength"), 1.0) or 1.0,
                        device=ctx.device))


@command("rgradient", "rgradient xc yc dR dalpha", min_args=4)
def cmd_rgradient(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import rgradient

    _keep(ctx, rgradient(ctx.require_image(), float(args[0]), float(args[1]),
                         float(args[2]), float(args[3]), device=ctx.device))


@command("denoise", "denoise [-mod=m] [-vst | -da3d | -sos=n [-rho=r]]")
def cmd_denoise(ctx: Session, args: List[str]) -> None:
    """NL-Bayes denoiser (``-vst``, ``-sos=``, ``-rho=``); ``-da3d`` runs
    the dual-domain refinement; ``-mod`` blends with the original (``-mod=
    0`` reads as 1, and ``-indep`` / ``-mask`` are not read, as in the JAX
    package).  Stages: search, solve, aggregate (and da3d)."""
    from siril_tpu_torch.ops.nlbayes import nlbayes_denoise

    pos, flags = parse_flags(args)
    sos = int(_f(flags.get("sos"), 0) or 0)
    rho = _f(flags.get("rho"), 0.3) or 0.3
    img = ctx.require_image()
    out = nlbayes_denoise(img, use_vst="vst" in flags, sos_iters=sos,
                          sos_rho=rho, device=ctx.device, stages=ctx.stages)
    if "da3d" in flags:
        import torch

        from siril_tpu_torch.ops.da3d import da3d_image
        from siril_tpu_torch.ops.statistics import bgnoise_np

        t = time.perf_counter()
        noisy = img.host()
        sigma = float(np.mean([bgnoise_np(noisy[c])
                               for c in range(img.nchans)]))
        refined = da3d_image(noisy, out.host(), sigma, device=ctx.device)
        out = out.copy(data=np.ascontiguousarray(
            torch.clamp(refined, 0.0, 1.0).cpu().numpy()))
        out.log_history("DA3D refinement")
        ctx.stages["da3d"] = time.perf_counter() - t
    mod = _f(flags.get("mod"), 1.0) or 1.0
    if mod < 1.0:
        blend = (mod * out.host() + (1.0 - mod) * img.host())
        out = img.copy(data=blend.astype(np.float32))
        out.log_history(f"denoise mod={mod}")
    _keep(ctx, out)


@command("wavelet", "wavelet nbr_layers type", min_args=1)
def cmd_wavelet(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.wavelets import (
        WAVELET_BSPLINE,
        WAVELET_LINEAR,
        wavelet_transform,
    )

    img = ctx.require_image()
    n = int(float(args[0]))
    ktype = WAVELET_LINEAR if (len(args) > 1 and args[1] == "1") \
        else WAVELET_BSPLINE
    ctx.wavelet_planes = wavelet_transform(img, n, ktype, device=ctx.device)
    ctx.wavelet_img = img
    _log.info("Computed %d wavelet layers", n)


@command("wrecons", "wrecons c1 c2 …", min_args=1)
def cmd_wrecons(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.wavelets import wavelet_reconstruct

    ctx.require_image()
    if ctx.wavelet_planes is None:
        raise CommandError("run `wavelet` first")
    _keep(ctx, wavelet_reconstruct(ctx.wavelet_img, ctx.wavelet_planes,
                                   [float(a) for a in args]))


@command("fftd", "fftd modulus phase", min_args=2)
def cmd_fftd(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.filters import fftd

    mod, phase = fftd(ctx.require_image(), device=ctx.device)
    write_fits(mod, ctx.path(args[0] + ctx.ext), bitdepth=FLOAT_IMG)
    write_fits(phase, ctx.path(args[1] + ctx.ext), bitdepth=FLOAT_IMG)
    # the session keeps the maxima (FFTNORM) for a later ffti
    ctx.pm_images["__fft_mod"] = mod
    ctx.pm_images["__fft_phase"] = phase


@command("ffti", "ffti modulus phase", min_args=2)
def cmd_ffti(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.filters import ffti

    mod = ctx.pm_images.get("__fft_mod")
    phase = ctx.pm_images.get("__fft_phase")
    if mod is None:
        mod = read_fits(ctx.path(args[0] + ctx.ext))
        phase = read_fits(ctx.path(args[1] + ctx.ext))
    _keep(ctx, ffti(mod, phase, device=ctx.device))


@command("linear_match", "linear_match reference low high", min_args=1)
def cmd_linear_match(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import linear_match

    ref = _load_operand(ctx, args[0])
    lo = float(args[1]) if len(args) > 1 else 1e-7
    hi = float(args[2]) if len(args) > 2 else 0.92
    _keep(ctx, linear_match(ctx.require_image(), ref, lo, hi))


# ---- deconvolution ----


def _get_psf(ctx: Session, flags: dict):
    from siril_tpu_torch.ops.deconvolution import (
        PSF_AIRY,
        PSF_DISC,
        PSF_GAUSSIAN,
        PSF_MOFFAT,
        make_psf,
        psf_from_stars,
    )

    ks = int(_f(flags.get("ks"), 31) or 31)
    if "psfstars" in flags or "stars" in flags:
        return psf_from_stars(ctx.require_image(), size=min(ks, 31),
                              device=ctx.device)
    kind = PSF_GAUSSIAN
    if "moffat" in flags:
        kind = PSF_MOFFAT
    elif "disc" in flags:
        kind = PSF_DISC
    elif "airy" in flags:
        kind = PSF_AIRY
    return make_psf(kind, size=ks, fwhm=_f(flags.get("fwhm"), 5.0) or 5.0,
                    beta=_f(flags.get("beta"), 2.2) or 2.2,
                    ratio=_f(flags.get("ratio"), 1.0) or 1.0,
                    angle_deg=_f(flags.get("angle"), 0.0) or 0.0,
                    diameter=_f(flags.get("dia"), 5.0) or 5.0)


def _write_psf(ctx: Session, psf, name: str) -> None:
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.io.fits_io import write_fits

    write_fits(SirilImage(data=psf[None] / psf.max()), ctx.path(name),
               bitdepth=FLOAT_IMG)


@command("makepsf",
         "makepsf {clear|load f|save [f]|blind [-l0] [-si] [-multiscale] "
         "[-lambda=] [-comp=] [-ks=] [-savepsf=]|stars [-sym] [-ks=] "
         "[-savepsf=]|manual …}", min_args=1)
def cmd_makepsf(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import psf_from_stars

    pos, flags = parse_flags(args)
    mode = pos[0]
    if mode == "clear":
        ctx.psf = None
        _log.info("PSF cleared")
        return
    if mode == "load":
        from siril_tpu_torch.io.conversion import load_any

        a = np.asarray(load_any(ctx.path(pos[1])).host()[0], np.float64)
        ctx.psf = (a / a.sum() if a.sum() > 0 else a).astype(np.float32)
        _log.info("PSF loaded")
        return
    if mode == "save":
        if ctx.psf is None:
            raise CommandError("no PSF to save")
        _write_psf(ctx, ctx.psf, pos[1] if len(pos) > 1 else "psf")
        return
    if mode == "blind":
        # -si: the spectral-irregularity engine; -l0 (default) the
        # ℓ0-descent engine
        from siril_tpu_torch.ops.blind_deconv import estimate_kernel_blind

        psf = estimate_kernel_blind(
            ctx.require_image().host(),
            ks=int(_f(flags.get("ks"), 15) or 15),
            method="si" if "si" in flags else "l0",
            multiscale="multiscale" in flags,
            lam=_f(flags.get("lambda"), 1e-3) or 1e-3,
            comp=_f(flags.get("comp"), None), device=ctx.device)
    elif mode == "stars":
        psf = psf_from_stars(ctx.require_image(), device=ctx.device)
    else:
        psf = _get_psf(ctx, flags)
    ctx.psf = psf
    if isinstance(flags.get("savepsf"), str):
        _write_psf(ctx, psf, flags["savepsf"])
    _log.info("PSF generated (%dx%d)", psf.shape[0], psf.shape[1])


def _psf_for_deconv(ctx: Session, flags: dict):
    """``-loadpsf=file``, else the session's PSF; any other flag makes a
    new synthetic PSF, the session's discarded (as the JAX package
    does)."""
    if isinstance(flags.get("loadpsf"), str):
        from siril_tpu_torch.io.conversion import load_any

        a = np.asarray(load_any(ctx.path(flags["loadpsf"])).host()[0],
                       np.float64)
        ssum = a.sum()
        return (a / ssum if ssum > 0 else a).astype(np.float32)
    psf = ctx.psf
    if psf is None or flags:
        psf = _get_psf(ctx, flags)
    return psf


@command("rl", "rl [-iters=] [-alpha=] [-gdstep=] [-mul] [-stop=] "
         "[psf flags]")
def cmd_rl(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import richardson_lucy

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    _keep(ctx, richardson_lucy(
        ctx.require_image(), psf,
        iterations=int(_f(flags.get("iters"), 20) or 20),
        tv_alpha=_f(flags.get("alpha"), 0.0) or 0.0,
        step=_f(flags.get("gdstep"), 0.0005) or 0.0005,
        multiplicative="mul" in flags or "gdstep" not in flags,
        stop_delta=_f(flags.get("stop"), 0.0) or 0.0, device=ctx.device))


@command("wiener", "wiener [-alpha=] [psf flags]")
def cmd_wiener(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import wiener

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    _keep(ctx, wiener(ctx.require_image(), psf,
                      alpha=1.0 / (_f(flags.get("alpha"), 500.0) or 500.0),
                      device=ctx.device))


@command("sb", "sb [-iters=] [-lambda=] [psf flags]")
def cmd_sb(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import split_bregman_tv

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    _keep(ctx, split_bregman_tv(
        ctx.require_image(), psf,
        lam=_f(flags.get("lambda"), 3000.0) or 3000.0,
        iterations=int(_f(flags.get("iters"), 10) or 10), device=ctx.device))


# ---- arithmetic & pixel math ----


def _arith(ctx: Session, fn, *operands) -> None:
    """The loaded image replaced by ``fn`` of it and ``operands`` (images
    or scalars), on the session's device; no mask blend."""
    from siril_tpu_torch.ops.stretch import upload

    img = ctx.require_image()
    ops = [upload(o, ctx.device) if hasattr(o, "host") else o
           for o in operands]
    out = fn(upload(img, ctx.device), *ops)
    _keep(ctx, img.copy(data=np.ascontiguousarray(out.cpu().numpy())))


def _imoper_command(name: str, oper: int):
    @command(name, f"{name} filename", min_args=1)
    def cmd(ctx: Session, args: List[str]) -> None:
        from siril_tpu_torch.ops.arithmetic import imoper

        _arith(ctx, lambda a, b: imoper(a, b, oper, clip16=ctx.force_16bit),
               _load_operand(ctx, args[0]))

    return cmd


def _soper_command(name: str, oper: int, scale: float,
                   clip16: bool = False):
    @command(name, f"{name} scalar", min_args=1)
    def cmd(ctx: Session, args: List[str]) -> None:
        from siril_tpu_torch.ops.arithmetic import soper

        _arith(ctx, lambda a: soper(a, float(args[0]) / scale, oper,
                                    clip16=clip16))

    return cmd


cmd_iadd = _imoper_command("iadd", 0)
cmd_isub = _imoper_command("isub", 1)
cmd_imul = _imoper_command("imul", 2)
cmd_idiv = _imoper_command("idiv", 3)
cmd_fadd = _soper_command("fadd", 0, 65535.0)
cmd_fsub = _soper_command("fsub", 1, 65535.0)
cmd_fmul = _soper_command("fmul", 2, 1.0)
# offset adds a value in ADU, always through the u16 quantizer
cmd_offset = _soper_command("offset", 0, 65535.0, clip16=True)


@command("fdiv", "fdiv filename scalar", min_args=2)
def cmd_fdiv(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.arithmetic import fdiv

    _arith(ctx, lambda a, b: fdiv(a, b, float(args[1])),
           _load_operand(ctx, args[0]))


@command("addmax", "addmax filename", min_args=1)
def cmd_addmax(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.arithmetic import addmax

    _arith(ctx, addmax, _load_operand(ctx, args[0]))


@command("pm", "pm \"expression\" [-rescale]", min_args=1)
def cmd_pm(ctx: Session, args: List[str]) -> None:
    """``$name$`` reads the image ``name`` (a file); without any, ``$T``
    is the loaded image."""
    from siril_tpu_torch.ops.pixelmath import pixel_math

    pos, flags = parse_flags(args)
    expr = pos[0].strip('"')
    images = {}
    for n in set(re.findall(r"\$([A-Za-z0-9_]+)\$", expr)):
        images[n] = _load_operand(ctx, n)
        expr = expr.replace(f"${n}$", n)
    if not images and ctx.image is not None:
        images["T"] = ctx.image
        expr = expr.replace("$T", "T")
    ctx.set_image(pixel_math(expr, images, rescale="rescale" in flags,
                             device=ctx.device), "pm_result")


# ---- masks ----


def _require_mask(ctx: Session):
    img = ctx.require_image()
    if img.mask is None:
        raise CommandError("no mask defined")
    return img


def _mask_postprocess(ctx: Session, img, flags: dict) -> None:
    """The mask_from_* options -autostretch, -invert, -feather=,
    -bitdepth=; the mask becomes active."""
    from siril_tpu_torch.ops.masks import (
        mask_autostretch,
        mask_feather,
        mask_invert,
    )

    if "autostretch" in flags:
        img.mask = mask_autostretch(img.mask, device=ctx.device)
    if "invert" in flags:
        img.mask = mask_invert(img.mask)
    if "feather" in flags and flags["feather"] is not True:
        img.mask = mask_feather(img.mask, int(float(flags["feather"])))
    q = {"8": 255.0, "16": 65535.0}.get(flags.get("bitdepth"))
    if q:
        img.mask = (np.round(img.mask * q) / q).astype(np.float32)
    img.mask_active = True


@command("mask_from_channel", "mask_from_channel channel [-invert] "
         "[-feather=] [-autostretch] [-bitdepth=]", min_args=1)
def cmd_mask_from_channel(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_from_channel

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    img.mask = mask_from_channel(img, int(float(pos[0])))
    _mask_postprocess(ctx, img, flags)


@command("mask_from_lum", "mask_from_lum [-rw=] [-gw=] [-bw=] [-invert] "
         "[-feather=] [-autostretch] [-bitdepth=]")
def cmd_mask_from_lum(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_from_lum

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    if any(k in flags for k in ("rw", "gw", "bw")):
        img.mask = mask_from_lum(img, weights=(
            _f(flags.get("rw"), 0.2126) or 0.2126,
            _f(flags.get("gw"), 0.7152) or 0.7152,
            _f(flags.get("bw"), 0.0722) or 0.0722))
    else:
        img.mask = mask_from_lum(img)
    _mask_postprocess(ctx, img, flags)


@command("mask_from_stars", "mask_from_stars [-invert] [-feather=] "
         "[-bitdepth=]")
def cmd_mask_from_stars(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_from_stars

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    img.mask = mask_from_stars(img, device=ctx.device)
    _mask_postprocess(ctx, img, flags)


@command("mask_from_color", "mask_from_color -cr= -cg= -cb= -tol= "
         "[-invert]", min_args=4)
def cmd_mask_from_color(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_from_color, mask_invert

    pos, flags = parse_flags(args)
    try:
        color = (float(flags["cr"]), float(flags["cg"]), float(flags["cb"]))
        tol = float(flags["tol"])
    except (KeyError, ValueError):
        raise CommandError("usage: mask_from_color -cr= -cg= -cb= -tol=")
    img = _need_rgb(ctx, "mask_from_color")
    m = mask_from_color(img, color, tol)
    img.mask = mask_invert(m) if "invert" in flags else m
    _log.info("mask created from color")


@command("mask_invert", "mask_invert")
def cmd_mask_invert(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_invert

    img = _require_mask(ctx)
    img.mask = mask_invert(img.mask)


@command("mask_blur", "mask_blur sigma", min_args=1)
def cmd_mask_blur(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_blur

    img = _require_mask(ctx)
    img.mask = mask_blur(img.mask, float(args[0]), device=ctx.device)


@command("mask_threshold", "mask_threshold lo [hi]", min_args=1)
def cmd_mask_threshold(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_threshold

    img = _require_mask(ctx)
    hi = float(args[1]) if len(args) > 1 else 1.0
    img.mask = mask_threshold(img.mask, float(args[0]), hi)


@command("mask_autostretch", "mask_autostretch")
def cmd_mask_autostretch(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_autostretch

    img = _require_mask(ctx)
    img.mask = mask_autostretch(img.mask, device=ctx.device)


@command("mask_bitpix", "mask_bitpix depth", min_args=1)
def cmd_mask_bitpix(ctx: Session, args: List[str]) -> None:
    """The mask quantized to the resolution of depth 8, 16 or 32."""
    img = _require_mask(ctx)
    m = img.mask
    depth = args[0]
    if depth in ("8", "byte"):
        m = np.round(m * 255.0) / 255.0
    elif depth in ("16", "ushort"):
        m = np.round(m * 65535.0) / 65535.0
    elif depth not in ("32", "float"):
        raise CommandError("mask_bitpix: depth must be 8, 16 or 32")
    img.mask = m.astype(np.float32)


@command("mask_feather", "mask_feather -dist= [-mode=]", min_args=1)
def cmd_mask_feather(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_feather

    pos, flags = parse_flags(args)
    dist = int(_f(flags.get("dist"), 0) or (float(pos[0]) if pos else 0))
    if dist <= 0:
        raise CommandError("mask_feather: -dist= required")
    img = _require_mask(ctx)
    img.mask = mask_feather(img.mask, dist)


@command("mask_fmul", "mask_fmul factor", min_args=1)
def cmd_mask_fmul(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.masks import mask_fmul

    img = _require_mask(ctx)
    img.mask = mask_fmul(img.mask, float(args[0]))


@command("clear_mask", "clear_mask")
def cmd_clear_mask(ctx: Session, args: List[str]) -> None:
    img = ctx.require_image()
    img.mask = None
    img.mask_active = False


# ---- the sequence forms ----


@command("seqfixbanding", "seqfixbanding sequencename amount sigma "
         "[-prefix=] [-vertical]", min_args=3)
def cmd_seqfixbanding(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.filters import fix_banding

    pos, flags = parse_flags(args)
    _seq_apply(ctx, pos[0], _prefix(flags, "unband_"), "seqfixbanding",
               lambda im: fix_banding(im, sigma=float(pos[2]),
                                      amount=float(pos[1]),
                                      vertical="vertical" in flags))


@command("seqrl", "seqrl sequencename [-iters=] [psf flags]", min_args=1)
def cmd_seqrl(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import richardson_lucy

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    iters = int(_f(flags.get("iters"), 20) or 20)
    _seq_apply(ctx, pos[0], _prefix(flags, "rl_"), "seqrl",
               lambda im: richardson_lucy(im, psf, iterations=iters,
                                          device=ctx.device))


@command("seqwiener", "seqwiener sequencename [-alpha=] [psf flags]",
         min_args=1)
def cmd_seqwiener(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import wiener

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    alpha = 1.0 / (_f(flags.get("alpha"), 500.0) or 500.0)
    _seq_apply(ctx, pos[0], _prefix(flags, "wiener_"), "seqwiener",
               lambda im: wiener(im, psf, alpha=alpha, device=ctx.device))


@command("seqsb", "seqsb sequencename [-iters=] [psf flags]", min_args=1)
def cmd_seqsb(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.deconvolution import split_bregman_tv

    pos, flags = parse_flags(args)
    psf = _psf_for_deconv(ctx, flags)
    iters = int(_f(flags.get("iters"), 10) or 10)
    _seq_apply(ctx, pos[0], _prefix(flags, "sb_"), "seqsb",
               lambda im: split_bregman_tv(im, psf, iterations=iters,
                                           device=ctx.device))


@command("seqdenoise", "seqdenoise sequencename [-vst | -sos=n [-rho=r]]",
         min_args=1)
def cmd_seqdenoise(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.nlbayes import nlbayes_denoise

    pos, flags = parse_flags(args)
    sos = int(_f(flags.get("sos"), 0) or 0)
    rho = _f(flags.get("rho"), 0.3) or 0.3
    _seq_apply(ctx, pos[0], _prefix(flags, "dn_"), "seqdenoise",
               lambda im: nlbayes_denoise(im, use_vst="vst" in flags,
                                          sos_iters=sos, sos_rho=rho,
                                          device=ctx.device))


@command("seqatrous", "seqatrous sequencename nbr_layers [-prefix=]",
         min_args=1)
def cmd_seqatrous(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.wavelets import wavelet_denoise

    pos, flags = parse_flags(args)
    n = int(float(pos[1])) if len(pos) > 1 else 4
    _seq_apply(ctx, pos[0], _prefix(flags, "atrous_"), "seqatrous",
               lambda im: wavelet_denoise(im, nb_layers=n,
                                          use_vst="anscombe" in flags,
                                          device=ctx.device))


# the analysis session's commands (register into COMMANDS on import)
from siril_tpu_torch.cli import analysis  # noqa: E402,F401  isort:skip
from siril_tpu_torch.cli import formats  # noqa: E402,F401  isort:skip
from siril_tpu_torch.cli import planetary  # noqa: E402,F401  isort:skip
from siril_tpu_torch.cli import sequence  # noqa: E402,F401  isort:skip
from siril_tpu_torch.cli import session  # noqa: E402,F401  isort:skip
