"""The analysis session's commands — counterpart of
``siril_tpu/cli/commands.py`` (``new``:211, ``set16bits``:246,
``set32bits``:252, ``stat``:368, ``bg``:396, ``bgnoise``:404,
``entropy``:413, ``seqstat``:546, ``find_hot``:682, ``find_cosme``:702,
``cosme``:722, ``grey_flat``:750, ``findstar``:889, ``clearstar``:903,
``synthstar``:1949, ``visu``:2264, ``histo``:2269, ``psf``:2450,
``setmag``:2480, ``unsetmag``:2486, ``light_curve``:2491, ``seqpsf``
:2547, the sequence forms ``seqmtf``:2702, ``seqsubsky``:2713,
``seqcrop``:2732, ``seqresample``:2744, ``seqfind_cosme``:2771,
``seqghs``:2933, and ``icc_assign`` … ``profile``:3216-3300) and of
``siril_tpu/cli/commands2.py`` (``cdg``:57, ``limit``:78, ``seqccm``:281,
``_parse_ght_params``:295, ``seqinvght`` … ``seqlinstretch``:333-360,
``seqprofile``:394, ``seqsetmag``:415, ``sequnsetmag``:421,
``seqfindstar``:455, ``atrous``:526, ``extract``:553, ``ssr``:575,
``detect_streaks``:650).

Pixel work runs on ``Session.device``: the statistics and histograms,
the 24-neighbour median of ``find_cosme``, the Hough vote, the star
finder and the PSF fits, the painting of ``synthstar`` and ``ssr``, the
ICC tone curves, the profile's samples, and every sequence form.  The
reference's behaviours that these commands keep are listed in ROADMAP
§3: ``cosme_cfa`` corrects as ``cosme`` does, ``unclipstars`` rebuilds
every star as ``synthstar`` does, and ``cosme`` takes every point of its
list as hot.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import List

import numpy as np
import torch

from siril_tpu_torch.cli.commands import (
    _f,
    _keep,
    _phot_cfg,
    _prefix,
    _seq_apply,
    _sf_params,
    command,
    parse_flags,
)
from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage

_log = logging.getLogger(__name__)


def _dev(ctx: Session) -> torch.device:
    from siril_tpu_torch.device import resolve_device

    return resolve_device(ctx.device)


def _layer(ctx: Session, img: SirilImage, c: int) -> torch.Tensor:
    """Layer ``c`` of ``img`` on the session's device."""
    return torch.from_numpy(np.ascontiguousarray(img.host()[c])).to(
        _dev(ctx))


# ===========================================================================
# session state
# ===========================================================================


@command("new", "new width height nb_chan", min_args=3)
def cmd_new(ctx: Session, args: List[str]) -> None:
    w, h, c = int(args[0]), int(args[1]), int(args[2])
    ctx.set_image(SirilImage(data=np.zeros((c, h, w), np.float32)), "new")


@command("set16bits", "set16bits")
def cmd_set16bits(ctx: Session, args: List[str]) -> None:
    ctx.force_16bit = True


@command("set32bits", "set32bits")
def cmd_set32bits(ctx: Session, args: List[str]) -> None:
    ctx.force_16bit = False


@command("visu", "visu low high")
def cmd_visu(ctx: Session, args: List[str]) -> None:
    """Display only in the reference: nothing to do without a display."""


# ===========================================================================
# statistics
# ===========================================================================


@command("stat", "stat [main] [-cfa]")
def cmd_stat(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import (
        STATS_BASIC,
        STATS_MAIN,
        compute_stats_image,
        compute_stats_tensor,
    )

    pos, flags = parse_flags(args)
    img = ctx.require_image()
    if "cfa" in flags and img.nchans == 1:
        d = _layer(ctx, img, 0)
        for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            st = compute_stats_tensor(d[dy::2, dx::2], STATS_BASIC)
            _log.info(f"CFA{k}: mean: {st.mean:.6f}, median: "
                      f"{st.median:.6f}, sigma: {st.sigma:.6f}, "
                      f"bgnoise: {st.bgnoise:.6f}")
        return
    opt = STATS_MAIN if (pos and pos[0] == "main") else STATS_BASIC
    for c, s in enumerate(compute_stats_image(img, options=opt,
                                              device=ctx.device)):
        _log.info(
            f"B{c}: mean: {s.mean:.6f}, median: {s.median:.6f}, "
            f"sigma: {s.sigma:.6f}, bgnoise: {s.bgnoise:.6f}, "
            f"min: {s.min:.6f}, max: {s.max:.6f}"
            + (f", mad: {s.mad:.6f}, avgdev: {s.avgdev:.6f}"
               if opt == STATS_MAIN else ""))


@command("bg", "bg")
def cmd_bg(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import STATS_BASIC, compute_stats_image

    for c, s in enumerate(compute_stats_image(
            ctx.require_image(), options=STATS_BASIC, device=ctx.device)):
        _log.info(f"Background value (channel: #{c}): {s.median:.6f}")


@command("bgnoise", "bgnoise")
def cmd_bgnoise(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import STATS_BASIC, compute_stats_image

    for c, s in enumerate(compute_stats_image(
            ctx.require_image(), options=STATS_BASIC, device=ctx.device)):
        _log.info(f"Background noise value (channel: #{c}): "
                  f"{s.bgnoise * 65535:.3f} ({s.bgnoise:.3e})")


@command("entropy", "entropy")
def cmd_entropy(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import histogram256

    img = ctx.require_image()
    for c in range(img.nchans):
        h = histogram256(_layer(ctx, img, c))
        p = h / max(h.sum(), 1)
        p = p[p > 0]
        e = float(-(p * np.log2(p)).sum())
        _log.info(f"Entropy (channel #{c}): {e:.3f}")


@command("histo", "histo channel", min_args=1)
def cmd_histo(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import histogram256

    img = ctx.require_image()
    c = int(float(args[0]))
    h = histogram256(_layer(ctx, img, c))
    path = ctx.path(f"histo_{c}.dat")
    np.savetxt(path, h, fmt="%d")
    _log.info(f"Histogram saved to {os.path.basename(path)}")


@command("seqstat", "seqstat sequencename output [option]", min_args=2)
def cmd_seqstat(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.statistics import STATS_MAIN, compute_stats_image

    seq = ctx.load_sequence(args[0])
    rows = ["image\tchan\tmean\tmedian\tsigma\tbgnoise\tmin\tmax\tmad"]
    for i in seq.selected_indices():
        img = seq.read_frame(int(i))
        for c, s in enumerate(compute_stats_image(
                img, options=STATS_MAIN, device=ctx.device)):
            rows.append(f"{i + 1}\t{c}\t{s.mean:.6f}\t{s.median:.6f}\t"
                        f"{s.sigma:.6f}\t{s.bgnoise:.6f}\t{s.min:.6f}\t"
                        f"{s.max:.6f}\t{s.mad:.6f}")
    with open(ctx.path(args[1]), "w") as f:
        f.write("\n".join(rows) + "\n")
    _log.info(f"Statistics saved to {args[1]}")


@command("cdg", "cdg")
def cmd_cdg(ctx: Session, args: List[str]):
    """Centre of gravity (command.c process_cdg): the pixels above 15.7 %
    of the maximum whose 4 neighbours are too, at least 50 of them."""
    img = ctx.require_image()
    d = torch.from_numpy(img.host()).to(_dev(ctx))
    # numpy's float32 mean over the layers: summed in order, then divided
    # by the count (torch's mean multiplies by its reciprocal)
    lay = d[0]
    for c in range(1, img.nchans):
        lay = lay + d[c]
    if img.nchans > 1:
        lay = lay / torch.tensor(float(img.nchans), device=d.device)
    m = lay > 0.157 * float(lay.max())
    core = m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] \
        & m[1:-1, 2:]
    ys, xs = torch.nonzero(core, as_tuple=True)
    if ys.numel() < 50:
        raise CommandError("not enough significant pixels to compute the "
                           "center of gravity")
    # as numpy types it: float64 moments over a float32 weight sum
    w = lay[1:-1, 1:-1][core]
    tot = float(w.sum())
    cx = float(((xs + 1).double() * w.double()).sum()) / tot
    cy = float(((ys + 1).double() * w.double()).sum()) / tot
    _log.info(f"Center of gravity: ({cx:.2f}, {cy:.2f})")
    return cx, cy


@command("limit", "limit {-clip|-posrescale|-rescale}", min_args=1)
def cmd_limit(ctx: Session, args: List[str]) -> None:
    img = ctx.require_image()
    _, flags = parse_flags(args)
    d = torch.from_numpy(img.host().copy()).to(_dev(ctx))

    def over_max(d):
        # divide by a 0-d tensor: on the card a division by a Python
        # scalar is a multiplication by its reciprocal
        mx = d.max()
        return d / mx if float(mx) > 1.0 else d

    if "clip" in flags:
        d = torch.clamp(d, 0.0, 1.0)
    elif "posrescale" in flags:
        d = over_max(torch.where(d < 0.0, 0.0, d))
    elif "rescale" in flags:
        mn = d.min()
        if float(mn) < 0.0:
            d = d - mn
        d = over_max(d)
    else:
        raise CommandError("limit: one of -clip, -posrescale, -rescale "
                           "required")
    out = img.copy(data=np.ascontiguousarray(d.cpu().numpy()))
    out.log_history("limit")
    _keep(ctx, out)


# ===========================================================================
# cosmetic correction
# ===========================================================================


@command("find_hot", "find_hot filename cold_sigma hot_sigma", min_args=3)
def cmd_find_hot(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.cosmetic import detect_deviant_from_dark

    img = ctx.require_image()
    cold, hot = detect_deviant_from_dark(img.host()[0], float(args[1]),
                                         float(args[2]))
    lst = ctx.path(args[0] if args[0].endswith(".lst") else args[0] + ".lst")
    with open(lst, "w") as f:
        ys, xs = np.nonzero(hot)
        for y, x in zip(ys, xs):
            f.write(f"P {x} {img.height - 1 - y} H\n")
        ys, xs = np.nonzero(cold)
        for y, x in zip(ys, xs):
            f.write(f"P {x} {img.height - 1 - y} C\n")
    _log.info(f"{int(hot.sum())} hot and {int(cold.sum())} cold pixels "
              f"written to {os.path.basename(lst)}")


def _find_cosme(ctx: Session, img: SirilImage, cold_sig: float,
                hot_sig: float):
    """(corrected image, cold count, hot count), every layer on the
    session's device."""
    from siril_tpu_torch.ops.cosmetic import auto_detect_tensor

    out, tot_c, tot_h = [], 0, 0
    for c in range(img.nchans):
        res, cold, hot = auto_detect_tensor(
            _layer(ctx, img, c), sig_hot=hot_sig, sig_cold=cold_sig,
            is_cfa=img.is_cfa())
        out.append(res)
        tot_c += int(cold.sum())
        tot_h += int(hot.sum())
    data = np.ascontiguousarray(torch.stack(out).cpu().numpy())
    return img.copy(data=data), tot_c, tot_h


@command("find_cosme", "find_cosme cold_sigma hot_sigma", min_args=2,
         aliases=("find_cosme_cfa",))
def cmd_find_cosme(ctx: Session, args: List[str]) -> None:
    out, tot_c, tot_h = _find_cosme(ctx, ctx.require_image(),
                                    float(args[0]), float(args[1]))
    _keep(ctx, out)
    _log.info(f"{tot_c} cold and {tot_h} hot pixels corrected")


@command("cosme", "cosme filename", min_args=1, aliases=("cosme_cfa",))
def cmd_cosme(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.cosmetic import apply_cosme_file

    img = ctx.require_image()
    p = ctx.path(args[0] if args[0].endswith(".lst") else args[0] + ".lst")
    if not os.path.exists(p):
        raise CommandError(f"file not found: {args[0]}")
    entries = []
    with open(p) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "P" and len(t) >= 3:
                # the file's y is bottom-up (Siril convention)
                entries.append(("P", int(float(t[1])),
                                img.height - 1 - int(float(t[2]))))
            elif t[0] == "L" and len(t) >= 2:
                entries.append(("L", img.height - 1 - int(float(t[1]))))
            elif t[0] == "C" and len(t) >= 2:
                entries.append(("C", int(float(t[1]))))
    # the JAX package passes is_cfa="cfa" in COMMANDS, which no command
    # name makes true: cosme_cfa corrects as cosme (ROADMAP §3)
    out = apply_cosme_file(img, entries, is_cfa=False, device=ctx.device)
    _keep(ctx, img.copy(data=out))
    _log.info(f"Applied {len(entries)} cosmetic corrections")


@command("seqfind_cosme", "seqfind_cosme sequencename cold hot [-prefix=]",
         min_args=3,
         aliases=("seqfind_cosme_cfa", "seqcosme", "seqcosme_cfa"))
def cmd_seqfind_cosme(ctx: Session, args: List[str]) -> None:
    pos, flags = parse_flags(args)
    cold_sig, hot_sig = float(pos[1]), float(pos[2])
    _seq_apply(ctx, pos[0], _prefix(flags, "cc_"), "seqfind_cosme",
               lambda im: _find_cosme(ctx, im, cold_sig, hot_sig)[0])


@command("grey_flat", "grey_flat")
def cmd_grey_flat(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.calibration import equalize_cfa_flat

    img = ctx.require_image()
    _keep(ctx, img.copy(data=equalize_cfa_flat(img.host())))


# ===========================================================================
# stars
# ===========================================================================


@command("findstar", "findstar [-out=]")
def cmd_findstar(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.registration.starfinder import (
        detect_stars,
        save_star_list_csv,
    )

    _, flags = parse_flags(args)
    img = ctx.require_image()
    layer = 1 if img.nchans == 3 else 0
    stars = detect_stars(_layer(ctx, img, layer), _sf_params(ctx))
    ctx.stars = stars
    _log.info(f"Found {len(stars)} stars in image, channel #{layer}")
    if isinstance(flags.get("out"), str):
        save_star_list_csv(stars, ctx.path(flags["out"]))


@command("clearstar", "clearstar")
def cmd_clearstar(ctx: Session, args: List[str]) -> None:
    ctx.stars = []


@command("seqfindstar", "seqfindstar sequencename [-layer=] [-maxstars=]",
         min_args=1)
def cmd_seqfindstar(ctx: Session, args: List[str]) -> None:
    import concurrent.futures as cf

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    layer = int(_f(flags.get("layer"), 0) or 0)
    frames = [i for i in range(seq.number) if seq.incl[i]]
    # the next frame is read while this one's stars are found
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(seq.read_frame, frames[0]) if frames else None
        for k, i in enumerate(frames):
            img = nxt.result()
            if k + 1 < len(frames):
                nxt = pool.submit(seq.read_frame, frames[k + 1])
            _seqfindstar_frame(ctx, seq, i, img, layer)
    seq.save()


def _seqfindstar_frame(ctx: Session, seq, i: int, img, layer: int) -> None:
    """One frame's stars: its ``.lst`` file and its count in the .seq."""
    from siril_tpu_torch.registration.starfinder import (
        detect_stars,
        save_star_list_csv,
    )

    stars = detect_stars(_layer(ctx, img, min(layer, img.nchans - 1)),
                         _sf_params(ctx))
    save_star_list_csv(stars, ctx.path(f"{seq.name}_{i + 1:05d}.lst"))
    seq.reg(layer).number_of_stars[i] = len(stars)
    _log.info(f"frame {i + 1}: {len(stars)} stars")


@command("ssr", "ssr [factor]")
def cmd_ssr(ctx: Session, args: List[str]) -> None:
    """Star suppression (command.c process_ssr): the pixels within
    max(2·FWHM, 4) px of each star of a layer become its median −
    factor·bgnoise (default 0.1)."""
    from siril_tpu_torch.ops.statistics import (
        STATS_BASIC,
        compute_stats_tensor,
    )
    from siril_tpu_torch.ops.synthstar import star_discs
    from siril_tpu_torch.registration.starfinder import detect_stars

    img = ctx.require_image()
    factor = float(args[0]) if args else 0.1
    out = []
    for c in range(img.nchans):
        lay = _layer(ctx, img, c)
        stars = detect_stars(lay, _sf_params(ctx))
        st = compute_stats_tensor(lay, STATS_BASIC)
        lay[star_discs(stars, img.height, img.width, lay.device)] = \
            st.median - factor * st.bgnoise
        out.append(lay)
        _log.info(f"channel {c}: {len(stars)} stars replaced")
    res = img.copy(data=np.ascontiguousarray(torch.stack(out).cpu().numpy()))
    res.log_history(f"ssr factor={factor}")
    _keep(ctx, res)


@command("synthstar", "synthstar", aliases=("unclipstars",))
def cmd_synthstar(ctx: Session, args: List[str]) -> None:
    """Both names rebuild every star: the JAX package's alias calls the
    same function without ``only_clipped`` (ROADMAP §3)."""
    from siril_tpu_torch.ops.synthstar import resynthesize_stars

    _keep(ctx, resynthesize_stars(ctx.require_image(), device=ctx.device))


@command("detect_streaks", "detect_streaks [-out=csv_file] [length]")
def cmd_detect_streaks(ctx: Session, args: List[str]):
    from siril_tpu_torch.ops.streaks import StreakConf, detect_streaks

    pos, flags = parse_flags(args)
    conf = StreakConf()
    if pos:
        conf.initial_length = int(float(pos[0]))
    tracks = detect_streaks(ctx.require_image().host(), conf,
                            device=ctx.device)
    if not tracks:
        _log.info("No streak detected")
        return []
    for t in tracks:
        _log.info(f"Streak: ({t.start[0]:.0f},{t.start[1]:.0f}) → "
                  f"({t.end[0]:.0f},{t.end[1]:.0f}) "
                  f"length={t.length:.0f}px angle={t.angle_deg:.1f}°")
    out = flags.get("out")
    if isinstance(out, str):
        with open(ctx.path(out), "w") as f:
            f.write("x1,y1,x2,y2,length,angle\n")
            for t in tracks:
                f.write(f"{t.start[0]:.1f},{t.start[1]:.1f},"
                        f"{t.end[0]:.1f},{t.end[1]:.1f},"
                        f"{t.length:.1f},{t.angle_deg:.2f}\n")
        _log.info(f"streaks written to {out}")
    return tracks


# ===========================================================================
# photometry
# ===========================================================================


@command("psf", "psf x y [channel]", min_args=2)
def cmd_psf(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.photometry import image_gain, measure_star
    from siril_tpu_torch.registration.psf import fit_psf_batch, fwhm_from_s

    img = ctx.require_image()
    x0, y0 = float(args[0]), float(args[1])
    chan = int(float(args[2])) if len(args) > 2 else \
        (1 if img.nchans == 3 else 0)
    lay = img.host()[min(chan, img.nchans - 1)]
    box = 30
    bx = int(np.clip(x0 - box // 2, 0, max(img.width - box, 0)))
    by = int(np.clip(y0 - box // 2, 0, max(img.height - box, 0)))
    fit = fit_psf_batch(torch.from_numpy(np.ascontiguousarray(
        lay[None, by:by + box, bx:bx + box])).to(_dev(ctx)))
    fx = float(fwhm_from_s(fit["sx"], fit["beta"])[0])
    fy = float(fwhm_from_s(fit["sy"], fit["beta"])[0])
    sx0 = bx + float(fit["x0"][0])
    sy0 = by + float(fit["y0"][0])
    phot = measure_star(lay, sx0, sy0, fx, _phot_cfg(ctx),
                        image_gain(img.keywords))
    _log.info(f"PSF: x0={sx0:.2f} y0={sy0:.2f} FWHMx={fx:.2f} "
              f"FWHMy={fy:.2f} A={float(fit['A'][0]):.5f} "
              f"B={float(fit['B'][0]):.5f}")
    if phot.valid:
        _log.info(f"Photometry: mag={phot.mag + ctx.magnitude_offset:.3f} "
                  f"±{phot.s_mag:.3f} SNR={phot.snr:.1f}dB")
    else:
        _log.info(f"Photometry invalid: {phot.error}")


@command("setmag", "setmag magnitude", min_args=1)
def cmd_setmag(ctx: Session, args: List[str]) -> None:
    ctx.magnitude_offset = float(args[0])
    _log.info(f"magnitude offset set to {ctx.magnitude_offset}")


@command("unsetmag", "unsetmag")
def cmd_unsetmag(ctx: Session, args: List[str]) -> None:
    ctx.magnitude_offset = 0.0


@command("seqsetmag", "seqsetmag magnitude", min_args=1)
def cmd_seqsetmag(ctx: Session, args: List[str]) -> None:
    ctx.magnitude_offset = float(args[0])
    _log.info(f"magnitude offset set to {ctx.magnitude_offset}")


@command("sequnsetmag", "sequnsetmag")
def cmd_sequnsetmag(ctx: Session, args: List[str]) -> None:
    ctx.magnitude_offset = 0.0


def _nina_stars(ctx: Session, seq, path: str):
    """[target, comparisons…] in the reference frame's pixels, from a NINA
    exoplanet CSV (Type, Ra, Dec; comparison_stars.c)."""
    ref = seq.read_frame(seq.get_reference())
    if ref.wcs is None:
        raise CommandError("-ninastars needs a plate-solved reference "
                           "frame")
    tgt, comps = None, []
    with open(ctx.path(path)) as f:
        for row in csv.DictReader(f):
            x, y = ref.wcs.world2pix(np.array([float(row["Ra"])]),
                                     np.array([float(row["Dec"])]))
            pt = (float(x[0]), float(y[0]))
            if row.get("Type", "").lower() == "target":
                tgt = pt
            else:
                comps.append(pt)
    if tgt is None or not comps:
        raise CommandError("ninastars file has no target/comparisons")
    return [tgt] + comps


@command("light_curve", "light_curve sequencename channel "
         "[-ninastars=file] [-out=] [-aavso] x y x y …", min_args=2)
def cmd_light_curve(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.photometry import light_curve, save_aavso_extended

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    chan = int(float(pos[1]))
    coords = [(float(pos[i]), float(pos[i + 1]))
              for i in range(2, len(pos) - 1, 2)]
    if isinstance(flags.get("ninastars"), str):
        coords = _nina_stars(ctx, seq, flags["ninastars"])
    if len(coords) < 2:
        raise CommandError("light_curve needs a target and at least one "
                           "comparison star")
    out = flags.get("out") if isinstance(flags.get("out"), str) \
        else "light_curve.dat"
    rows = light_curve(seq, coords[0], coords[1:], layer=chan,
                       cfg=_phot_cfg(ctx), out_path=ctx.path(out),
                       device=ctx.device)
    _log.info(f"Light curve: {len(rows)} points written to {out}")
    if "aavso" in flags:
        aout = os.path.splitext(ctx.path(out))[0] + "_aavso.csv"
        n = save_aavso_extended(
            rows, aout, starid=str(flags.get("starid", "object")),
            obscode=str(flags.get("obscode", "XXX")),
            filt=str(flags.get("filter", "V")),
            chart=str(flags.get("chart", "na")))
        _log.info(f"AAVSO extended report: {n} rows → "
                  f"{os.path.basename(aout)}")


@command("seqpsf", "seqpsf sequencename channel x y", min_args=4)
def cmd_seqpsf(ctx: Session, args: List[str]):
    from siril_tpu_torch.ops.photometry import seq_photometry

    seq = ctx.load_sequence(args[0])
    results = seq_photometry(seq, float(args[2]), float(args[3]),
                             layer=int(float(args[1])), cfg=_phot_cfg(ctx),
                             device=ctx.device)
    ok = sum(1 for _, r in results if r is not None and r["phot"].valid)
    for idx, r in results:
        if r is not None and r["phot"].valid:
            _log.info(f"{idx + 1}: x={r['x']:.2f} y={r['y']:.2f} "
                      f"fwhm={r['fwhm']:.2f} mag={r['phot'].mag:.3f}")
    _log.info(f"seqpsf: {ok}/{len(results)} frames measured")
    return results


# ===========================================================================
# inspection
# ===========================================================================


@command("tilt", "tilt", aliases=("seqtilt",))
def cmd_tilt(ctx: Session, args: List[str]):
    from siril_tpu_torch.ops.inspector import sensor_tilt

    try:
        return sensor_tilt(ctx.require_image(), device=ctx.device)
    except ValueError as e:
        raise CommandError(str(e))


@command("inspector", "inspector")
def cmd_inspector(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.inspector import aberration_inspector

    _keep(ctx, aberration_inspector(ctx.require_image()))


@command("fix_xtrans", "fix_xtrans")
def cmd_fix_xtrans(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.inspector import fix_xtrans_af

    _keep(ctx, fix_xtrans_af(ctx.require_image(), device=ctx.device))


def _line(flags: dict, usage: str):
    try:
        return (tuple(float(v) for v in str(flags["from"]).split(",")),
                tuple(float(v) for v in str(flags["to"]).split(",")))
    except (KeyError, ValueError):
        raise CommandError(f"usage: {usage}")


@command("profile", "profile -from=x,y -to=x,y [-layer=] [-filename=]",
         min_args=2)
def cmd_profile(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.inspector import (
        intensity_profile,
        save_profile_plot,
    )

    _, flags = parse_flags(args)
    p0, p1 = _line(flags, "profile -from=x,y -to=x,y")
    layer = int(_f(flags.get("layer"), -1) or -1)
    prof = intensity_profile(
        ctx.require_image(), p0, p1, layer=None if layer < 0 else layer,
        width=int(_f(flags.get("width"), 1) or 1),
        spacing=_f(flags.get("spacing"), 1.0) or 1.0,
        arcsec="arcsec" in flags, device=ctx.device)
    base = flags.get("filename") if isinstance(flags.get("filename"), str) \
        else "profile"
    title = flags.get("title") if isinstance(flags.get("title"), str) \
        else "Intensity profile"
    png = None if "savedat" in flags else ctx.path(base + ".png")
    save_profile_plot(prof, ctx.path(base + ".dat"), png, title=title)
    _log.info(f"profile saved to {base}.dat"
              + ("" if "savedat" in flags else f" / {base}.png"))


@command("seqprofile", "seqprofile sequencename -from=x,y -to=x,y "
         "[-layer=]", min_args=3)
def cmd_seqprofile(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.inspector import (
        intensity_profile,
        save_profile_plot,
    )

    pos, flags = parse_flags(args)
    seq = ctx.load_sequence(pos[0])
    p0, p1 = _line(flags, "seqprofile seq -from=x,y -to=x,y")
    for i in range(seq.number):
        if not seq.incl[i]:
            continue
        prof = intensity_profile(seq.read_frame(i), p0, p1,
                                 device=ctx.device)
        base = ctx.path(f"{seq.name}_profile_{i + 1:05d}")
        save_profile_plot(prof, base + ".dat", base + ".png")
    _log.info("seqprofile: profiles saved")


# ===========================================================================
# ICC profiles
# ===========================================================================


def _icc_spec(ctx: Session, spec: str) -> str:
    return ctx.path(spec) if spec.lower().endswith((".icc", ".icm")) \
        else spec


@command("icc_assign", "icc_assign profile", min_args=1)
def cmd_icc_assign(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.icc import assign_profile

    try:
        _keep(ctx, assign_profile(ctx.require_image(),
                                  _icc_spec(ctx, args[0])))
    except ValueError as e:
        raise CommandError(str(e))


@command("icc_convert_to", "icc_convert_to profile", min_args=1)
def cmd_icc_convert_to(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.icc import convert_to_profile

    try:
        _keep(ctx, convert_to_profile(ctx.require_image(),
                                      _icc_spec(ctx, args[0]),
                                      device=ctx.device))
    except ValueError as e:
        raise CommandError(str(e))


@command("icc_remove", "icc_remove")
def cmd_icc_remove(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.icc import remove_profile

    _keep(ctx, remove_profile(ctx.require_image()))


# ===========================================================================
# wavelets
# ===========================================================================


@command("atrous", "atrous nbr_layers type [-denoise] [-anscombe] "
         "[-bishrink|-threshold] [-soft|-hard] [-k=]", min_args=1)
def cmd_atrous(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.wavelets import (
        WAVELET_BSPLINE,
        WAVELET_LINEAR,
        wavelet_denoise,
    )

    pos, flags = parse_flags(args)
    n = int(float(pos[0]))
    ktype = WAVELET_LINEAR if (len(pos) > 1 and pos[1] == "1") \
        else WAVELET_BSPLINE
    mode = "bishrink"
    if "threshold" in flags or "soft" in flags:
        mode = "soft"
    if "hard" in flags:
        mode = "hard"
    thresholds = [float(flags["k"])] * n if "k" in flags else None
    _keep(ctx, wavelet_denoise(ctx.require_image(), n, thresholds, mode,
                               use_vst="anscombe" in flags, ktype=ktype,
                               device=ctx.device))


@command("extract", "extract NbPlans", min_args=1)
def cmd_extract(ctx: Session, args: List[str]) -> None:
    """Each wavelet detail plane as layer_NN.fit (command.c
    process_extract)."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.wavelets import WAVELET_BSPLINE, wavelet_transform

    img = ctx.require_image()
    n = int(float(args[0]))
    planes = wavelet_transform(img, n, WAVELET_BSPLINE, device=ctx.device)
    for i, p in enumerate(planes[:-1]):
        out = img.copy(data=np.ascontiguousarray(p.cpu().numpy(),
                                                 np.float32))
        write_fits(out, ctx.path(f"layer_{i:02d}{ctx.ext}"),
                   bitdepth=FLOAT_IMG)
    _log.info(f"extract: {n} wavelet planes saved "
              f"(layer_00..layer_{n - 1:02d})")


# ===========================================================================
# the sequence forms
# ===========================================================================


@command("seqmtf", "seqmtf sequencename low mid high [-prefix=]",
         min_args=4)
def cmd_seqmtf(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import MTFParams, apply_mtf

    pos, flags = parse_flags(args)
    p = MTFParams(shadows=float(pos[1]), midtones=float(pos[2]),
                  highlights=float(pos[3]))
    _seq_apply(ctx, pos[0], _prefix(flags, "mtf_"), "seqmtf",
               lambda im: apply_mtf(im, p, device=ctx.device))


@command("seqsubsky", "seqsubsky sequencename {-rbf|degree} [-prefix=]",
         min_args=2)
def cmd_seqsubsky(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.background import (
        BKG_POLY,
        BKG_RBF,
        extract_background,
    )

    pos, flags = parse_flags(args)
    if "rbf" in flags:
        method, degree = BKG_RBF, 0
    else:
        method, degree = BKG_POLY, int(float(pos[1]))
    _seq_apply(ctx, pos[0], _prefix(flags, "bkg_"), "seqsubsky",
               lambda im: extract_background(
                   im, method, degree,
                   smoothing=_f(flags.get("smooth"), 0.5) or 0.5,
                   nb_samples=int(_f(flags.get("samples"), 20) or 20),
                   tolerance=_f(flags.get("tolerance"), 1.0) or 1.0,
                   device=ctx.device))


@command("seqcrop", "seqcrop sequencename x y width height [-prefix=]",
         min_args=5)
def cmd_seqcrop(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import crop

    pos, flags = parse_flags(args)
    x, y, w, h = (int(float(a)) for a in pos[1:5])
    _seq_apply(ctx, pos[0], _prefix(flags, "cropped_"), "seqcrop",
               lambda im: crop(im, x, y, w, h, device=ctx.device))


@command("seqresample", "seqresample sequencename factor [-prefix=]",
         min_args=2)
def cmd_seqresample(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.geometry import resample

    pos, flags = parse_flags(args)
    f = float(pos[1])
    _seq_apply(ctx, pos[0], _prefix(flags, "scaled_"), "seqresample",
               lambda im: resample(im, int(im.width * f),
                                   int(im.height * f), device=ctx.device))


@command("seqghs", "seqghs sequencename -D= [...]", min_args=2,
         aliases=("seqght",))
def cmd_seqghs(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import (
        STRETCH_PAYNE_NORMAL,
        GHTParams,
        apply_ght,
    )

    pos, flags = parse_flags(args)
    p = GHTParams(stretchtype=STRETCH_PAYNE_NORMAL,
                  D=_f(flags.get("d"), 1.0) or 1.0,
                  B=_f(flags.get("b"), 0.0) or 0.0,
                  LP=_f(flags.get("lp"), 0.0) or 0.0,
                  SP=_f(flags.get("sp"), 0.0) or 0.0,
                  HP=_f(flags.get("hp"), 1.0) or 1.0)
    _seq_apply(ctx, pos[0], _prefix(flags, "ghs_"), "seqghs",
               lambda im: apply_ght(im, p, device=ctx.device))


@command("seqccm", "seqccm sequencename m00 … m22 [gamma] [-prefix=]",
         min_args=10)
def cmd_seqccm(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.colors import apply_ccm

    pos, flags = parse_flags(args)
    m = [float(a) for a in pos[1:10]]
    gamma = float(pos[10]) if len(pos) > 10 else 1.0
    _seq_apply(ctx, pos[0], _prefix(flags, "ccm_"), "seqccm",
               lambda im: apply_ccm(im, m, gamma, device=ctx.device))


def _parse_ght_params(args: List[str], stretchtype: int):
    """(sequence, GHTParams, prefix or None) of the seq… GHT forms: -D= or
    the positional D [B LP SP HP], and the colour model flags."""
    from siril_tpu_torch.ops.stretch import GHTParams

    pos, flags = parse_flags(args)
    p = GHTParams(stretchtype=stretchtype)
    p.D = _f(flags.get("d"), None)
    p.B = _f(flags.get("b"), 0.0) or 0.0
    p.LP = _f(flags.get("lp"), 0.0) or 0.0
    p.SP = _f(flags.get("sp"), 0.0) or 0.0
    p.HP = _f(flags.get("hp"), 1.0) or 1.0
    p.BP = _f(flags.get("bp"), 0.0) or 0.0
    rest = pos[1:]
    if p.D is None:
        if not rest:
            raise CommandError("needs -D= or positional D")
        vals = [float(x) for x in rest]
        p.D = vals[0]
        for attr, v in zip(("B", "LP", "SP", "HP"), vals[1:]):
            setattr(p, attr, v)
    if "human" in flags:
        p.payne_colourstretchmodel = 1
    elif "even" in flags:
        p.payne_colourstretchmodel = 2
    elif "sat" in flags:
        p.payne_colourstretchmodel = 3
    prefix = flags.get("prefix") if isinstance(flags.get("prefix"), str) \
        else None
    return pos[0], p, prefix


def _seq_ght(ctx: Session, args: List[str], stretchtype: int, desc: str,
             default_prefix: str) -> None:
    from siril_tpu_torch.ops.stretch import apply_ght

    seqname, p, prefix = _parse_ght_params(args, stretchtype)
    _seq_apply(ctx, seqname, prefix or default_prefix, desc,
               lambda im: apply_ght(im, p, device=ctx.device))


@command("seqinvght", "seqinvght sequencename -D= …", min_args=2)
def cmd_seqinvght(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_PAYNE_INVERSE

    _seq_ght(ctx, args, STRETCH_PAYNE_INVERSE, "seqinvght", "invght_")


@command("seqmodasinh", "seqmodasinh sequencename -D= …", min_args=2)
def cmd_seqmodasinh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_ASINH

    _seq_ght(ctx, args, STRETCH_ASINH, "seqmodasinh", "modasinh_")


@command("seqinvmodasinh", "seqinvmodasinh sequencename -D= …", min_args=2)
def cmd_seqinvmodasinh(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import STRETCH_INVASINH

    _seq_ght(ctx, args, STRETCH_INVASINH, "seqinvmodasinh", "invmodasinh_")


@command("seqlinstretch", "seqlinstretch sequencename -BP= [-prefix=]",
         min_args=2)
def cmd_seqlinstretch(ctx: Session, args: List[str]) -> None:
    from siril_tpu_torch.ops.stretch import linstretch

    pos, flags = parse_flags(args)
    bp = _f(flags.get("bp"), None)
    if bp is None and len(pos) > 1:
        bp = float(pos[1])
    _seq_apply(ctx, pos[0], _prefix(flags, "linstretch_"), "seqlinstretch",
               lambda im: linstretch(im, bp or 0.0, device=ctx.device))
