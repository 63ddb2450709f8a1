"""Command-line entry — counterpart of ``siril_tpu/cli/main.py`` (``-d
dir``, ``-s script.ssf`` or one command) over the ported commands
(``cli/commands.py``): requires, cd, setext, close, load, save,
setcompress, convert, link, calibrate, the CFA commands (split_cfa, extract_Ha,
extract_Green, extract_HaOIII, merge_cfa and their seq… forms),
setfindstar, register, seqapplyreg, stack, fusedstack, the astrometry
commands (platesolve, seqplatesolve, conesearch, catsearch, show, disto,
healpix, trixel, online, offline), the post-stack colour session
(stretches, colour ops, subsky, pcc, spcc, geometry) and the enhancement
session: makepsf, rl, wiener, sb, denoise, the filters (gauss, unsharp,
fmedian, clahe, epf, ddp, fixbanding, unpurple, rgradient, fftd, ffti,
linear_match, thresh, threshlo, threshhi, nozero, fill, ffill), wavelet,
wrecons, pm, the arithmetic (iadd, isub, imul, idiv, fadd, fsub, fmul,
fdiv, offset, addmax), the masks (mask_from_channel, mask_from_lum,
mask_from_stars, mask_from_color, mask_invert, mask_blur, mask_threshold,
mask_autostretch, mask_bitpix, mask_feather, mask_fmul, clear_mask) and
seqfixbanding, seqrl, seqwiener, seqsb, seqdenoise, seqatrous.

    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] \\
        -s script.ssf
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] command …

Runs on CUDA unless ``--device cpu`` is given.  The other commands of the
reference's table are not ported yet (ROADMAP §1.7, the surfaces).
"""

from __future__ import annotations

import argparse
import logging
import os
import shlex
from typing import List, Optional

from siril_tpu_torch.cli.commands import (  # noqa: F401 (re-exported)
    COMMANDS,
    parse_flags,
    stack_args_from_flags,
)
from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.cli.parser import execute_script


def run(argv: Optional[List[str]] = None) -> Session:
    """Parse ``argv``, run the script or the command, and return the
    session (the last stack result stays in ``session.result``).  A
    command's errors propagate; a script that stops at a failing command
    raises ``CommandError``."""
    ap = argparse.ArgumentParser(prog="siril_tpu_torch.cli",
                                 description="PyTorch/CUDA port of the "
                                 "siril_tpu CLI")
    ap.add_argument("-d", "--directory", default=".")
    ap.add_argument("-s", "--script", default=None,
                    help="run a .ssf script")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command and its arguments")
    a = ap.parse_args(argv)
    ctx = Session(cwd=os.path.abspath(a.directory), device=a.device)
    if a.script is not None:
        rc = execute_script(ctx, a.script)
        if rc != 0:
            raise CommandError(f"script {a.script} stopped at "
                               f"'{ctx.command_log[-1]['command']}'")
        return ctx
    if not a.command:
        ap.error("a command or -s script is required")
    words = a.command if len(a.command) > 1 else shlex.split(a.command[0])
    cmd = COMMANDS.get(words[0].lower())
    if cmd is None:
        raise CommandError(f"unknown or not yet ported command "
                           f"'{words[0]}' (ported: {', '.join(COMMANDS)})")
    if len(words) - 1 < cmd.min_args:
        raise CommandError(f"usage: {cmd.usage}")
    cmd.fn(ctx, words[1:])
    return ctx


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        run(argv)
    except CommandError as e:
        logging.getLogger(__name__).error("%s", e)
        return 1
    return 0
