"""Script and line parsing, command dispatch — counterpart of
``siril_tpu/cli/parser.py`` (``parse_line``:17, ``execute_command``:31,
``execute_script``:83; reference ``src/core/command_line_processor.c``).

``execute_script`` also keeps, for each command, its wall seconds, the
launches of kernel K1 it made, the stages it timed and, on a card, the
peak device memory it took beyond what was allocated before it
(``peak_mib``) in ``Session.command_log``; ``run_logged`` does the same
for one command line (the ``-p`` and ``-i`` loops).  A script stops at
``exit`` (``Session.stop_requested``).
"""

from __future__ import annotations

import logging
import shlex
import time
from typing import List

from siril_tpu_torch.cli.commands import get_command
from siril_tpu_torch.cli.context import CommandError, Session

_log = logging.getLogger(__name__)


def parse_line(line: str) -> List[str]:
    """Word-split honouring quotes; ``#`` starts a comment."""
    line = line.strip()
    if not line or line.startswith("#"):
        return []
    try:
        lex = shlex.shlex(line, posix=True)
        lex.whitespace_split = True
        lex.commenters = "#"
        return list(lex)
    except ValueError:
        return line.split()


def execute_command(ctx: Session, words: List[str]) -> int:
    """Run one parsed command; 0 on success, 1 on a command error.  Any
    other error (a device error, an option not ported) propagates."""
    if not words:
        return 0
    cmd = get_command(words[0])
    if cmd is None:
        _log.error("Unknown command: '%s' or not implemented yet", words[0])
        return 1
    if len(words) - 1 < cmd.min_args:
        _log.error("Usage: %s", cmd.usage)
        return 1
    from siril_tpu_torch.core.processing import ProcessingCancelled

    try:
        cmd.fn(ctx, words[1:])
        return 0
    except CommandError as e:
        _log.error("%s", e)
        return 1
    except FileNotFoundError as e:
        _log.error("%s: file not found: %s", cmd.name, e)
        return 1
    except ProcessingCancelled:
        _log.error("%s: cancelled", cmd.name)
        return 1


def process_command_line(ctx: Session, line: str) -> int:
    return execute_command(ctx, parse_line(line))


def _reset_peak(dev) -> int:
    """Start a command's peak-memory count; the bytes allocated now."""
    if dev.type != "cuda":
        return 0
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_mib(dev, base: int):
    """MiB at the command's peak beyond ``base``; None off the card."""
    if dev.type != "cuda":
        return None
    import torch

    return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20


def run_logged(ctx: Session, words: List[str], dev) -> int:
    """Run one parsed command on ``dev`` and keep its entry in
    ``Session.command_log``: words, seconds, K1 launches, stages, return
    code, peak MiB on a card."""
    from siril_tpu_torch.device import synchronize
    from siril_tpu_torch.kernels import reject_stack as k1

    before = dict(k1.launches)
    ctx.stages = {}
    base = _reset_peak(dev)
    t = time.perf_counter()
    rc = execute_command(ctx, words)
    synchronize(dev)
    ctx.command_log.append(dict(
        command=" ".join(words), seconds=time.perf_counter() - t,
        launches={v: n - before.get(v, 0) for v, n in k1.launches.items()
                  if n != before.get(v, 0)},
        stages=dict(ctx.stages), rc=rc, peak_mib=_peak_mib(dev, base)))
    return rc


def execute_script(ctx: Session, path: str) -> int:
    """Run a ``.ssf`` script (execute_script, command_line_processor.c:
    246), stopping at the first failing command (returning its code) or
    at ``exit``; else 0."""
    from siril_tpu_torch.device import resolve_device

    dev = resolve_device(ctx.device)
    t0 = time.perf_counter()
    _log.info("Executing script: %s", path)
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if ctx.stop_requested:
                break
            words = parse_line(line)
            if not words:
                continue
            rc = run_logged(ctx, words, dev)
            if rc != 0:
                _log.error("Script aborted at line %d: %s", lineno,
                           line.strip())
                return rc
    _log.info("Script execution finished successfully (%.1f s)",
              time.perf_counter() - t0)
    return 0
