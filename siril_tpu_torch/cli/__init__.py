"""Command-line entry — counterpart of ``siril_tpu/cli/main.py`` (``-d dir
command …``) with two commands: ``fusedstack``
(``siril_tpu/cli/commands2.py:836``) and ``stack``
(``siril_tpu/cli/commands.py:1197``).

    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] fusedstack \\
        sequencename [rejection] [sig_low sig_high] [-norm=] [-out=] [-noreg]
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] stack \\
        sequencename {rej|mean|med} [type] [sig_low sig_high] [-norm=] \\
        [-weight_from_noise|_wfwhm|_nbstars|_nbstack] [-rejmaps|-rejmap=merged] \\
        [-fastnorm] [-force_norm] [-rgb_equal] [-output_norm] [-16b] [-out=]

Runs on CUDA unless ``--device cpu`` is given.  The other commands of the
reference's table are not ported yet (ROADMAP §1, surfaces).
"""

from __future__ import annotations

import argparse
import logging
import os
import shlex
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.ops.rejection import (
    SIGMEDIAN_MAX_ROUNDS,
    WINSOR_MAX_STEPS,
)
from siril_tpu_torch.ops.stacking import StackResult


class CommandError(Exception):
    """A command's arguments or preconditions are wrong."""


@dataclass
class Session:
    """Working state of one CLI run."""

    cwd: str
    device: Optional[str] = None
    ext: str = ".fit"
    sequence: Optional[Sequence] = None
    image: Optional[SirilImage] = None
    result: Optional[StackResult] = None

    def path(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.cwd, name)

    def load_sequence(self, name: str) -> Sequence:
        """Scan ``name%05d.fit`` files (also ``name_``)."""
        base = name[:-4] if name.endswith(".seq") else name
        for cand in (base, base + "_"):
            if os.path.exists(self.path(cand + ".seq")):
                raise NotImplementedError(
                    f"{cand}.seq: reading .seq sidecars is not ported yet "
                    "(ROADMAP §1, off-path modules: io/seqfile)")
        try:
            return Sequence.scan(base, self.cwd)
        except FileNotFoundError:
            if base.endswith("_"):
                raise
            return Sequence.scan(base + "_", self.cwd)


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


def cmd_fusedstack(ctx: Session, args: List[str]) -> None:
    """Fused register+stack with the sequence resident on the device; no
    intermediate sequences, one upload and one result fetch."""
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops import rejection as rj
    from siril_tpu_torch.ops.normalization import (
        ADDITIVE_SCALING,
        NORM_NAMES,
    )
    from siril_tpu_torch.ops.stacking import StackArgs
    from siril_tpu_torch.pipeline import FusedArgs, fused_preprocess_stack

    pos, flags = parse_flags(args)
    if not pos:
        raise CommandError("usage: fusedstack sequencename [rejection] "
                           "[sig_low sig_high] [-norm=] [-out=]")
    for k in ("bias", "dark", "flat"):
        if k in flags:
            raise NotImplementedError(
                f"fusedstack -{k}=: calibration is not ported yet "
                "(ROADMAP §1, calibration + cosmetic)")
    if flags.get("transf") == "homography":
        raise NotImplementedError(
            "fusedstack -transf=homography: only shift registration is "
            "ported (ROADMAP §1, the warp ladder)")
    seq = ctx.load_sequence(pos[0])
    ctx.sequence = seq
    sa = StackArgs(method="rej")
    rest = pos[1:]
    if rest and not _is_number(rest[0]):
        sa.rejection = rj.REJECTION_NAMES.get(rest[0].lower(), rj.WINSORIZED)
        rest = rest[1:]
    if len(rest) >= 2:
        sa.siglow, sa.sighigh = float(rest[0]), float(rest[1])
    sa.normalize = NORM_NAMES.get(str(flags.get("norm", "addscale")).lower(),
                                  ADDITIVE_SCALING)
    fa = FusedArgs(stack=sa, register="noreg" not in flags)
    try:
        res = fused_preprocess_stack(seq, fa, device=ctx.device)
    except MemoryError as e:
        raise CommandError(str(e))
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else seq.name + "fused"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(res.image, p, bitdepth=FLOAT_IMG)
    ctx.image = res.image
    ctx.result = res
    logging.getLogger(__name__).info("fusedstack: saved %s (%.2fs)",
                                     os.path.basename(p), res.elapsed_s)
    _warn_capped(res)


def _warn_capped(res) -> None:
    if res.capped:
        logging.getLogger(__name__).warning(
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


#: flags of the stack command whose features are not ported yet
_STACK_UNPORTED = {
    "drizzle": "drizzle stacking (ROADMAP §1, off-path modules: "
               "ops/drizzle.py)",
    "upscale": "the x2 up-scale before stacking (ROADMAP §1, off-path "
               "modules: ops/geometry.py)",
    "feather": "seam feathering (ROADMAP §1, stacking beyond rejection)",
    "overlap_norm": "overlap normalization (ROADMAP §1, stacking beyond "
                    "rejection)",
    "maximize": "maximize framing (ROADMAP §1, stacking beyond rejection)",
}


def cmd_stack(ctx: Session, args: List[str]) -> None:
    """Stack a registered sequence: normalization, weights and pixel
    rejection on the device; writes ``<seq>stacked.fit`` (or ``-out=``)
    and, with ``-rejmaps``, ``rejmap_low``/``rejmap_high``."""
    from siril_tpu_torch.core.image import USHORT_IMG
    from siril_tpu_torch.io.fits_io import write_fits
    from siril_tpu_torch.ops.stacking import stack_sequence

    pos, flags = parse_flags(args)
    if not pos:
        raise CommandError("usage: stack seqfilename {sum|min|max|med|rej} "
                           "[type] [sigma_low sigma_high] [-norm=] "
                           "[-weight_from_…] [-out=]")
    for key, what in _STACK_UNPORTED.items():
        if key in flags:
            raise NotImplementedError(f"stack -{key}: {what} is not "
                                      "ported yet")
    for key in flags:
        if key.startswith("filter-"):
            raise NotImplementedError(
                f"stack -{key}: frame filters are not ported yet "
                "(ROADMAP §1, off-path modules: core/filtering.py)")
    seq = ctx.load_sequence(pos[0])
    ctx.sequence = seq
    sa = stack_args_from_flags(pos, flags)
    from siril_tpu_torch.utils.devmem import MEMORY_RATIO

    # setmem → device block budget (commands.py _apply_mem_budget)
    sa.block_mb = max(int(2048 * min(MEMORY_RATIO, 4.0)), 128)
    res = stack_sequence(seq, sa, device=ctx.device)
    name = flags.get("out") if isinstance(flags.get("out"), str) \
        else seq.name + "stacked"
    p = ctx.path(name)
    if not os.path.splitext(p)[1]:
        p += ctx.ext
    write_fits(res.image, p,
               bitdepth=FLOAT_IMG if sa.use_32bit else USHORT_IMG)
    ctx.image = res.image
    ctx.result = res
    logging.getLogger(__name__).info(
        "Stacked %d images, rejected %d/%d px (low/high) in %.2fs → %s",
        len(seq.selected_indices()), *res.total_rejected, res.elapsed_s,
        os.path.basename(p))
    _warn_capped(res)
    if sa.create_rejmaps and res.rejmap_low is not None:
        write_fits(res.rejmap_low, ctx.path("rejmap_low" + ctx.ext))
        if res.rejmap_high is not None:
            write_fits(res.rejmap_high, ctx.path("rejmap_high" + ctx.ext))


COMMANDS: Dict[str, Callable[[Session, List[str]], None]] = {
    "fusedstack": cmd_fusedstack,
    "stack": cmd_stack,
}


def run(argv: Optional[List[str]] = None) -> Session:
    """Parse ``argv``, run the command, and return the session (the last
    result stays in ``session.result``).  Errors propagate."""
    ap = argparse.ArgumentParser(prog="siril_tpu_torch.cli",
                                 description="PyTorch/CUDA port of the "
                                 "siril_tpu CLI (fusedstack, stack)")
    ap.add_argument("-d", "--directory", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command and its arguments")
    a = ap.parse_args(argv)
    if not a.command:
        ap.error("a command is required")
    words = a.command if len(a.command) > 1 else shlex.split(a.command[0])
    fn = COMMANDS.get(words[0].lower())
    if fn is None:
        raise CommandError(f"unknown or not yet ported command "
                           f"'{words[0]}' (ported: {', '.join(COMMANDS)})")
    ctx = Session(cwd=os.path.abspath(a.directory), device=a.device)
    fn(ctx, words[1:])
    return ctx


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        run(argv)
    except CommandError as e:
        logging.getLogger(__name__).error("%s", e)
        return 1
    return 0
