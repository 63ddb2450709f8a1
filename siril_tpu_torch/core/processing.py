"""Processing control: cancellation and the stop signal — counterpart of
``siril_tpu/core/processing.py`` (the reference's
``processing_should_continue``, ``core/processing.h:260-264``, and the
stop path of Ctrl-C).

Long operations poll between units of work and stop by raising
:class:`ProcessingCancelled`: the stack between row blocks
(``ops/stacking.py``), the sequence engine between frames
(``core/engine.py``), the survey stack between blocks
(``parallel/survey.py``) and the live stacker's worker between frames
(``livestacking/livestack.py``).  The flag is one per process; a
multi-rank run polls it on every rank.
"""

from __future__ import annotations

import signal
import sys
import threading

_stop_event = threading.Event()


class ProcessingCancelled(RuntimeError):
    """Raised by a long operation when a stop was requested."""


def request_stop() -> None:
    _stop_event.set()


def clear_stop() -> None:
    _stop_event.clear()


def processing_should_continue() -> bool:
    """processing.h:260-264: poll between frames, blocks or iterations."""
    return not _stop_event.is_set()


def check_cancelled(what: str = "processing") -> None:
    """Raise ProcessingCancelled if a stop was requested."""
    if _stop_event.is_set():
        raise ProcessingCancelled(f"{what} cancelled")


def install_sigint_handler() -> None:
    """The first Ctrl-C requests a stop (the running operation ends at its
    next poll); a second raises KeyboardInterrupt as usual."""
    def handler(signum, frame):
        if _stop_event.is_set():
            raise KeyboardInterrupt
        _stop_event.set()
        print("\nStop requested — finishing current step "
              "(Ctrl-C again to force quit)", file=sys.stderr, flush=True)

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass        # not the main thread (under a test runner, say)
