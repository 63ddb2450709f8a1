"""Log and progress fan-out — counterpart of ``siril_tpu/utils/log.py``
(``get_log_buffer``:17, ``add_log_hook``:23, ``add_progress_hook``:27,
``_emit``:31, ``log_progress``:65; the reference's siril_log_* in
core/siril_log.c).

The port logs through :mod:`logging` under the ``siril_tpu_torch``
logger.  Importing this module installs one handler there (and sets
that logger to INFO when it has no level of its own) which does what the
JAX module's ``_emit`` does with each record: it appends the message to
a ring buffer of ``_MAX_BUFFER`` lines (the sirilpy ``get_siril_log``
store) and hands ``(level, message)`` to every log hook (the ``-p``
pipe's ``log:`` lines).  Progress goes to the progress hooks only
(``progress:`` lines).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

_hooks: List[Callable[[str, str], None]] = []
_progress_hooks: List[Callable[[float, Optional[str]], None]] = []
_lock = threading.Lock()
_MAX_BUFFER = 10000
_buffer: List[str] = []

_LEVELS = {logging.DEBUG: "debug", logging.INFO: "info",
           logging.WARNING: "warning", logging.ERROR: "error",
           logging.CRITICAL: "error"}


def get_log_buffer() -> List[str]:
    """Recent log lines, oldest first."""
    with _lock:
        return list(_buffer)


def add_log_hook(fn: Callable[[str, str], None]) -> None:
    _hooks.append(fn)


def remove_log_hook(fn) -> None:
    if fn in _hooks:
        _hooks.remove(fn)


def add_progress_hook(fn: Callable[[float, Optional[str]], None]) -> None:
    _progress_hooks.append(fn)


def remove_progress_hook(fn) -> None:
    if fn in _progress_hooks:
        _progress_hooks.remove(fn)


def log_progress(frac: float, text: Optional[str] = None) -> None:
    for h in list(_progress_hooks):
        try:
            h(frac, text)
        except Exception:
            pass


class _FanOut(logging.Handler):
    """The ring buffer and the log hooks, fed by every record."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:
            return
        level = _LEVELS.get(record.levelno, "info")
        with _lock:
            _buffer.append(msg)
            if len(_buffer) > _MAX_BUFFER:
                del _buffer[:_MAX_BUFFER // 2]
            hooks = list(_hooks)
        for h in hooks:
            try:
                h(level, msg)
            except Exception:
                pass


def _install() -> None:
    root = logging.getLogger("siril_tpu_torch")
    if not any(isinstance(h, _FanOut) for h in root.handlers):
        root.addHandler(_FanOut())
    if root.level == logging.NOTSET:
        root.setLevel(logging.INFO)


_install()
