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
seqfixbanding, seqrl, seqwiener, seqsb, seqdenoise, seqatrous; the
analysis session (``cli/analysis.py``); the planetary session
(``cli/planetary.py``: seqquality, mpp, register_mpp, stack_mpp, and
``rgbcomp -align``), the image formats (``cli/formats.py``:
convertraw, savetif, savetif8, savetif32, savepng, savejpg, savejxl,
savebmp, savepnm) and the sequence, header, live-stacking and export
commands (``cli/sequence.py``: load_seq, select, unselect, setref,
getref, seqclean, merge, stackall, seqheader, update_key, sequpdate_key,
dumpheader, jsonmetadata, gps, seqgps, parse, boxselect,
calibrate_single, mirrorx_single, seqstarnet, start_ls, livestack,
stop_ls, seqexport) and the session commands (``cli/session.py``: help,
clear, log, pwd, ls / dir, set, get, setmem, setcpu, capabilities, exit,
undo, redo, pyscript, reloadscripts, precompile) — the JAX package's
table of 234 names.

    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] \\
        -s script.ssf
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] command …
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] -p
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] -i
    python -m siril_tpu_torch.cli [-d dir] [--device cuda|cpu] < cmds.txt
    python -m siril_tpu_torch.cli -v

The modes of ``siril_tpu/cli/main.py`` (``build_session``:23, ``main``
:36): ``-p`` is the pipe protocol of the reference's core/pipe.c over
stdio (``ready:`` once, then ``log:``, ``progress:`` and one ``status:
success|error <command>`` line a command; ``cancel`` stops the running
command at once, ``exit`` / ``quit`` end the loop), ``-i`` the
interactive prompt, and commands piped on stdin run one a line.  The
preferences are read from the INI at startup (``run``); ``exit`` ends
each loop.  Every mode runs on CUDA unless ``--device cpu`` is given,
and raises without a card.  ``SIRIL_TPU_TRACE=<dir>`` records a
``torch.profiler`` trace of the run (``utils/trace.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import queue
import shlex
import sys
import threading
from typing import List, Optional, TextIO

from siril_tpu_torch.cli.commands import (  # noqa: F401 (re-exported)
    COMMANDS,
    VERSION,
    parse_flags,
    stack_args_from_flags,
)
from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.cli.parser import execute_script, parse_line, run_logged

_log = logging.getLogger(__name__)


def build_session(workdir: str = ".", device: Optional[str] = None
                  ) -> Session:
    """A session in ``workdir`` with the user's preferences from the INI
    (``build_session``, siril_tpu/cli/main.py:23), active from here on."""
    from siril_tpu_torch.core.settings import Preferences

    ctx = Session(cwd=os.path.abspath(workdir), device=device)
    ctx.prefs = Preferences.load_ini()
    return ctx


def _run_line(ctx: Session, line: str, dev) -> int:
    words = parse_line(line)
    return run_logged(ctx, words, dev) if words else 0


def pipe_loop(ctx: Session, inp: TextIO, out: TextIO) -> int:
    """The pipe protocol (core/pipe.c over a pair of streams): ``ready:``,
    then for each command its ``log:`` and ``progress:`` lines and one
    ``status: success|error <command>`` line.  A thread reads ``inp``:
    ``cancel`` stops the running command at once (its status follows in
    order, then ``status: success cancel``), ``exit`` / ``quit`` or the
    end of the input end the loop, as does the ``exit`` command.  Each
    command's entry goes into ``Session.command_log``."""
    from siril_tpu_torch.core.processing import clear_stop, request_stop
    from siril_tpu_torch.device import resolve_device
    from siril_tpu_torch.utils.log import (
        add_log_hook,
        add_progress_hook,
        remove_log_hook,
        remove_progress_hook,
    )

    dev = resolve_device(ctx.device)
    lock = threading.Lock()
    running = threading.Event()

    def emit(text: str) -> None:
        with lock:
            out.write(text + "\n")
            out.flush()

    def on_log(level, msg):
        emit(f"log: {msg}")

    def on_progress(frac, text):
        emit(f"progress: {frac:.2f}")

    lines: "queue.Queue[Optional[str]]" = queue.Queue()

    def reader():
        try:
            for raw in inp:
                line = raw.strip()
                if line == "cancel" and running.is_set():
                    request_stop()
                lines.put(line)
        finally:
            lines.put(None)

    add_log_hook(on_log)
    add_progress_hook(on_progress)
    try:
        emit("ready:")
        threading.Thread(target=reader, daemon=True).start()
        while True:
            line = lines.get()
            if line is None or line in ("exit", "quit"):
                break
            if not line:
                continue
            if line == "cancel":
                request_stop()
                emit("status: success cancel")
                continue
            clear_stop()
            running.set()
            try:
                rc = _run_line(ctx, line, dev)
            finally:
                running.clear()
            emit(f"status: {'success' if rc == 0 else 'error'} "
                 f"{line.split()[0]}")
            if ctx.stop_requested:
                break
    finally:
        remove_log_hook(on_log)
        remove_progress_hook(on_progress)
        clear_stop()
    return 0


def interactive_loop(ctx: Session, inp: TextIO, out: TextIO) -> int:
    """The ``-i`` prompt: one command a line until ``exit`` or the end of
    the input."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(ctx.device)
    _log.info("siril_tpu_torch interactive console — type commands, "
              "'exit' to quit")
    try:
        while not ctx.stop_requested:
            out.write("> ")
            out.flush()
            line = inp.readline()
            if not line:
                break
            _run_line(ctx, line, dev)
    except KeyboardInterrupt:
        pass
    return 0


def stdin_loop(ctx: Session, inp: TextIO) -> int:
    """Commands piped on stdin, one a line, until ``exit``."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(ctx.device)
    for line in inp:
        if ctx.stop_requested:
            break
        _run_line(ctx, line, dev)
    return 0


def run(argv: Optional[List[str]] = None) -> Optional[Session]:
    """Parse ``argv`` and run its mode; return the session (the last stack
    result stays in ``session.result``), or None for ``-v``.  A single
    command's errors propagate; a script that stops at a failing command
    raises ``CommandError``."""
    from siril_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="siril_tpu_torch.cli",
                                 description="PyTorch/CUDA port of the "
                                 "siril_tpu CLI")
    ap.add_argument("-d", "--directory", default=".")
    ap.add_argument("-s", "--script", default=None,
                    help="run a .ssf script")
    ap.add_argument("-i", "--interactive", action="store_true",
                    help="interactive prompt")
    ap.add_argument("-p", "--pipe", action="store_true",
                    help="pipe mode: commands on stdin, status lines on "
                    "stdout")
    ap.add_argument("-v", "--version", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command and its arguments")
    a = ap.parse_args(argv)
    if a.version:
        print(f"siril_tpu_torch {VERSION}", flush=True)
        return None
    resolve_device(a.device)
    ctx = build_session(a.directory, a.device)
    if a.pipe:
        pipe_loop(ctx, sys.stdin, sys.stdout)
        return ctx
    if a.script is not None:
        rc = execute_script(ctx, a.script)
        if rc != 0:
            raise CommandError(f"script {a.script} stopped at "
                               f"'{ctx.command_log[-1]['command']}'")
        return ctx
    if a.command:
        words = a.command if len(a.command) > 1 else \
            shlex.split(a.command[0])
        cmd = COMMANDS.get(words[0].lower())
        if cmd is None:
            raise CommandError(f"unknown command '{words[0]}'")
        if len(words) - 1 < cmd.min_args:
            raise CommandError(f"usage: {cmd.usage}")
        cmd.fn(ctx, words[1:])
        return ctx
    if a.interactive or sys.stdin.isatty():
        interactive_loop(ctx, sys.stdin, sys.stdout)
    else:
        stdin_loop(ctx, sys.stdin)
    return ctx


def main(argv: Optional[List[str]] = None) -> int:
    from siril_tpu_torch.core.processing import install_sigint_handler
    from siril_tpu_torch.utils.trace import maybe_trace_env, stop_device_trace

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    # Ctrl-C requests a stop: the stack, the sequence engine, the survey
    # and the live stacker end at their next poll (a second one quits)
    install_sigint_handler()
    # SIRIL_TPU_TRACE=<dir>: a torch.profiler trace of the whole run
    maybe_trace_env()
    try:
        run(argv)
    except CommandError as e:
        logging.getLogger(__name__).error("%s", e)
        return 1
    finally:
        stop_device_trace()
    return 0
