"""The sequence, header, live-stacking and export commands — counterpart
of ``siril_tpu/cli/commands.py`` (``dumpheader``:341, ``jsonmetadata``
:351, ``boxselect``:425, ``update_key``:442, ``select``:517,
``unselect``:526, ``setref``:534, ``getref``:541, ``seqheader``:565,
``seqclean``:583, ``calibrate_single``:665, ``stackall``:1282,
``mirrorx_single``:1360, ``seqstarnet``:2950, ``merge``:2956,
``start_ls``:2976, ``livestack``:2994, ``stop_ls``:3004, ``parse``:3034)
and of ``siril_tpu/cli/commands2.py`` (``load_seq``:129,
``sequpdate_key``:427, ``gps``:749, ``seqgps``:816, ``seqexport``:904).

``calibrate_single``, ``mirrorx_single``, ``stackall`` (K1 once a
sequence), the live stacker and ``seqexport`` run on ``Session.device``.
``start_ls`` takes the shift route whatever its flags, as the JAX
package's ``"shift" in flags or True`` does (commands.py:2989; ROADMAP
§3); ``LiveStacker`` itself also takes the star route.  ``seqstarnet``
raises: it needs the external StarNet binary, as in the JAX package.
"""

from __future__ import annotations

import glob as globmod
import json
import logging
import os
from typing import List

from siril_tpu_torch.cli.commands import (
    _calib_args_from_flags,
    _f,
    _load_master,
    cmd_stack,
    command,
    parse_flags,
)
from siril_tpu_torch.cli.context import CommandError, Session

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# headers
# ---------------------------------------------------------------------------


@command("dumpheader", "dumpheader")
def cmd_dumpheader(ctx: Session, args: List[str]) -> None:
    img = ctx.require_image()
    if img.fits_header is not None:
        for line in img.fits_header.text().splitlines():
            _log.info("%s", line)
    else:
        _log.info("no FITS header")


@command("jsonmetadata", "jsonmetadata FITS_file [-nostats] [-out=]",
         min_args=1)
def cmd_jsonmetadata(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import read_fits
    from siril_tpu_torch.ops.statistics import (
        STATS_MAIN,
        compute_stats_image,
    )

    pos, flags = parse_flags(args)
    img = read_fits(ctx.path(pos[0]))
    meta = {"width": img.width, "height": img.height, "channels": img.nchans}
    if "nostats" not in flags:
        sts = compute_stats_image(img, options=STATS_MAIN,
                                  device=ctx.device)
        meta["statistics"] = [vars(s) for s in sts]
    out = json.dumps(meta)
    if "out" in flags and flags["out"] is not True:
        with open(ctx.path(flags["out"]), "w") as f:
            f.write(out)
    _log.info("%s", out)


def _typed(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return v


@command("update_key", "update_key [-delete] [-modify] [-comment] key "
         "[value]", min_args=1)
def cmd_update_key(ctx: Session, args: List[str]) -> None:
    img = ctx.require_image()
    pos, flags = parse_flags(args)
    if "delete" in flags or len(pos) == 1:
        img.keywords.extra.pop(pos[0].upper(), None)
        return
    if "comment" in flags:
        img.history.append(f"COMMENT {' '.join(pos)}")
        return
    img.keywords.extra[pos[0].upper()] = _typed(pos[1])


@command("sequpdate_key", "sequpdate_key sequencename key [value]",
         min_args=2)
def cmd_sequpdate_key(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import read_fits, write_fits

    seq = ctx.load_sequence(args[0])
    key = args[1].upper()
    val = _typed(args[2]) if len(args) > 2 else None
    n = 0
    for i in range(seq.number):
        p = seq.frame_path(i)
        if p is None:
            continue
        img = read_fits(p)
        if val is None:
            img.keywords.extra.pop(key, None)
        else:
            img.keywords.extra[key] = val
        write_fits(img, p, bitdepth=img.orig_bitdepth)
        n += 1
    _log.info("sequpdate_key: %d headers updated", n)


@command("seqheader", "seqheader sequencename keyword…", min_args=2)
def cmd_seqheader(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.fits_io import _KEYMAP

    seq = ctx.load_sequence(args[0])
    keys = [k.upper() for k in args[1:]]
    for i in seq.selected_indices():
        kw = seq.read_frame_metadata(int(i))
        vals = []
        for k in keys:
            v = kw.extra.get(k)
            if v is None:
                attr = _KEYMAP.get(k)
                v = getattr(kw, attr, "") if attr else ""
            vals.append(str(v))
        _log.info("%s", f"{i + 1}\t" + "\t".join(vals))


def _gps_keys(kw: dict) -> dict:
    return {k: v for k, v in kw.items()
            if k.startswith("GPS") or k in ("LATITUDE", "LONGITUD",
                                            "SITELAT", "SITELONG")}


@command("gps", "gps [{-ro | -header | line_number}]")
def cmd_gps(ctx: Session, args: List[str]) -> None:
    """GPS keywords of the header (io/gps_parser.c's GPSBOX records live in
    the first rows of supported cameras; the header's are reported)."""
    keys = _gps_keys(ctx.require_image().keywords.extra)
    if keys:
        for k, v in sorted(keys.items()):
            _log.info("%s = %s", k, v)
    else:
        _log.info("No GPS data found in this image")


@command("seqgps", "seqgps sequencename", min_args=1)
def cmd_seqgps(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    found = sum(1 for i in range(seq.number)
                if any(k.startswith("GPS")
                       for k in seq.read_frame_metadata(i).extra))
    _log.info("seqgps: GPS data in %d/%d frames", found, seq.number)


@command("parse", "parse path_template", min_args=1)
def cmd_parse(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.utils.pathparse import parse_path

    _log.info("%s", parse_path(args[0], ctx.require_image()))


@command("boxselect", "boxselect [-clear] [x y w h]")
def cmd_boxselect(ctx: Session, args: List[str]) -> None:
    pos, flags = parse_flags(args)
    if "clear" in flags:
        ctx.selection = None
        return
    if len(pos) >= 4:
        ctx.selection = tuple(int(float(a)) for a in pos[:4])
        _log.info("Selection: %s", ctx.selection)
    elif ctx.selection:
        _log.info("Selection: %s", ctx.selection)
    else:
        _log.info("no selection")


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------


@command("load_seq", "load_seq sequencename", min_args=1)
def cmd_load_seq(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    _log.info("Sequence loaded: %s (%d images)", seq.name, seq.number)


@command("select", "select sequencename from to", min_args=3)
def cmd_select(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    seq.incl[int(args[1]):int(args[2]) + 1] = True
    seq.save()


@command("unselect", "unselect sequencename from to", min_args=3)
def cmd_unselect(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    seq.incl[int(args[1]):int(args[2]) + 1] = False
    seq.save()


@command("setref", "setref sequencename image_number", min_args=2)
def cmd_setref(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    seq.reference_image = int(args[1]) - 1
    seq.save()


@command("getref", "getref sequencename", min_args=1)
def cmd_getref(ctx: Session, args: List[str]) -> None:
    seq = ctx.load_sequence(args[0])
    _log.info("reference image of sequence: %d", seq.get_reference() + 1)


@command("seqclean", "seqclean sequencename [-reg] [-stat] [-sel]",
         min_args=1)
def cmd_seqclean(ctx: Session, args: List[str]) -> None:
    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    clean_all = not flags
    if clean_all or "reg" in flags:
        seq.regparam.clear()
    if clean_all or "stat" in flags:
        seq.stats.clear()
    if clean_all or "sel" in flags:
        seq.incl[:] = True
    seq.save()


@command("merge", "merge seq1 seq2 ... newseq", min_args=3)
def cmd_merge(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import convert_to_sequence

    *names, dest = args
    files = []
    for sn in names:
        files.extend(f for f in ctx.load_sequence(sn)._file_list if f)
    if not files:
        raise CommandError("no frames found in input sequences")
    ctx.sequence = convert_to_sequence(files, dest, ctx.cwd, symlink=False,
                                       device=ctx.device)
    _log.info("Merged %d frames into %s", len(files), dest)


@command("stackall", "stackall [method …]")
def cmd_stackall(ctx: Session, args: List[str]) -> None:
    """``stack`` with the same arguments on every sequence of the working
    directory (in name order)."""
    for s in sorted(globmod.glob(os.path.join(ctx.cwd, "*.seq"))):
        cmd_stack(ctx, [os.path.splitext(os.path.basename(s))[0]]
                  + list(args))


@command("seqstarnet", "seqstarnet sequencename", min_args=1)
def cmd_seqstarnet(ctx: Session, args: List[str]) -> None:
    raise CommandError("starnet integration requires the external StarNet "
                       "binary (not available in this environment)")


@command("seqexport",
         "seqexport sequencename basename [-format=fits|fitseq|ser|tiff|"
         "avi|mp4|mp4-h265|webm] [-fps=] [-quality=] [-normalize] "
         "[-crop=x,y,w,h] [-resize=WxH] [-32b]", min_args=2)
def cmd_seqexport(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.sequence_export import (
        ExportArgs,
        export_sequence,
    )

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    ea = ExportArgs(basename=pos[1] if pos[1].endswith("_")
                    else pos[1] + "_",
                    output=str(flags.get("format", "fits")).lower(),
                    normalize="normalize" in flags,
                    fps=int(_f(flags.get("fps"), 25) or 25),
                    quality=int(_f(flags.get("quality"), 3) or 3),
                    bitdepth=32 if "32b" in flags else 16)
    if isinstance(flags.get("crop"), str):
        ea.crop = tuple(int(v) for v in flags["crop"].split(","))
    if isinstance(flags.get("resize"), str):
        w, h = flags["resize"].lower().split("x")
        ea.resample = (int(w), int(h))
    n = export_sequence(seq, ea, directory=ctx.cwd, device=ctx.device)
    _log.info("seqexport: wrote %d frames as %s", n, ea.output)


# ---------------------------------------------------------------------------
# single files
# ---------------------------------------------------------------------------


@command("calibrate_single", "calibrate_single imagename [-bias=] [-dark=] "
         "[-flat=] [-cc=dark] [-cfa] [-debayer] [-opt] [-prefix=]",
         min_args=1)
def cmd_calibrate_single(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.calibration import calibrate_image

    pos, flags = parse_flags(args)
    p = ctx.path(pos[0])
    img = load_any(p)
    ca = _calib_args_from_flags(ctx, flags, img)
    out = calibrate_image(img, ca, device=ctx.device)
    prefix = ca.prefix or "pp_"
    d, b = os.path.split(p)
    write_fits(out, os.path.join(d, prefix + b))
    _log.info("Saved calibrated image %s", prefix + b)


@command("mirrorx_single", "mirrorx_single imagename", min_args=1)
def cmd_mirrorx_single(ctx: Session, args: List[str]) -> None:
    """Flip a FITS file in place; the loaded image stays (command.c
    process_mirrorx_single)."""
    from siril_tpu_torch.io.conversion import load_any
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.geometry import mirrorx

    pos, _ = parse_flags(args)
    p = ctx.path(pos[0])
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    img = load_any(p)
    write_fits(mirrorx(img, device=ctx.device), p,
               bitdepth=img.orig_bitdepth)
    _log.info("mirrorx: %s", os.path.basename(p))


# ---------------------------------------------------------------------------
# live stacking
# ---------------------------------------------------------------------------


@command("start_ls", "start_ls [-dark=] [-flat=] [-debayer] [-shift]")
def cmd_start_ls(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.livestacking.livestack import (
        LiveStackConfig,
        LiveStacker,
    )

    _, flags = parse_flags(args)
    cfg = LiveStackConfig()
    if isinstance(flags.get("dark"), str):
        cfg.dark = _load_master(ctx, flags["dark"])
        cfg.calibrate = True
    if isinstance(flags.get("flat"), str):
        cfg.flat = _load_master(ctx, flags["flat"])
        cfg.calibrate = True
    cfg.debayer = "debayer" in flags
    # the JAX package's ``"shift" in flags or True``: always the shift route
    cfg.shift_only = True
    ctx.livestacker = LiveStacker(ctx.cwd, cfg, device=ctx.device)
    ctx.livestacker.start()


@command("livestack", "livestack [filename]")
def cmd_livestack(ctx: Session, args: List[str]) -> None:
    ls = ctx.livestacker
    if ls is None:
        raise CommandError("live stacking not started (start_ls)")
    if args:
        ls.process_file(ctx.path(args[0]))
    _log.info("live stack: %d frames accumulated", ls.count)


@command("stop_ls", "stop_ls")
def cmd_stop_ls(ctx: Session, args: List[str]) -> None:
    ls = ctx.livestacker
    if ls is None:
        raise CommandError("live stacking not started")
    ls.stop()
    ls.save_result()
    ctx.livestacker = None

