"""Undo / redo — counterpart of ``siril_tpu/core/undo.py`` (``UndoStack``
:26, ``MAX_HISTORY``:17; the reference's swap-file undo of
``src/core/undo.c`` with its history ring, siril.h:800).

Whole images (and their masks) spill to ``.npy`` files in the port's own
swap directory; a restored image is ``like.copy(data=…)``, so the current
keywords, WCS and history stay, as in the JAX package.

Which command saves an undo point follows the JAX package command by
command (``UNDO_COMMANDS``): there, ``Session.set_image`` without a name
saves one and a load (with a name) does not (``siril_tpu/cli/context.py:
59-70``).  The port's commands always pass a name, so the session asks
this table instead (``cli/context.Session.set_image``).
"""

from __future__ import annotations

import os
import tempfile
import uuid
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from siril_tpu_torch.core.image import SirilImage

MAX_HISTORY = 20

#: the JAX package's commands whose image replacement saves an undo point
#: (their ``set_image`` calls pass no name); every other command's
#: replacement is a load.  ``tests/test_torch_session.py`` derives the set
#: from the JAX package's command sources and holds this table to it.
UNDO_COMMANDS = frozenset({
    "addmax", "asinh", "atrous", "autoghs", "autostretch", "bgneutralize",
    "binxy", "ccm", "clahe", "cosme", "cosme_cfa", "crop", "ddp", "denoise",
    "epf", "eqcrop", "fadd", "fdiv", "ffill", "ffti", "fill", "find_cosme",
    "find_cosme_cfa", "fix_xtrans", "fixbanding", "fmedian", "fmul", "fsub",
    "gauss", "ght", "grey_flat", "iadd", "icc_assign", "icc_convert_to",
    "icc_remove", "idiv", "imul", "inspector", "invght", "invmodasinh",
    "invmtf", "isub", "limit", "linear_match", "linstretch", "mirrorx",
    "mirrory", "modasinh", "mtf", "neg", "nozero", "offset", "pcc",
    "resample", "rgradient", "rl", "rmgreen", "rotate", "rotatepi", "satu",
    "sb", "seqexport", "spcc", "ssr", "subsky", "synthstar", "thresh",
    "threshhi", "threshlo", "unclipstars", "unpurple", "unsharp", "wiener",
    "wrecons"})


def swap_dir() -> str:
    """The port's swap directory (the JAX package uses
    ``siril_tpu_swap`` beside it)."""
    return os.path.join(tempfile.gettempdir(), "siril_tpu_torch_swap")


@dataclass
class _Entry:
    path: str
    mask_path: Optional[str]
    description: str


class UndoStack:
    def __init__(self, swap: Optional[str] = None):
        self.swap_dir = swap or swap_dir()
        os.makedirs(self.swap_dir, exist_ok=True)
        self._undo: List[_Entry] = []
        self._redo: List[_Entry] = []

    def _spill(self, img: SirilImage, desc: str) -> _Entry:
        p = os.path.join(self.swap_dir, f"{uuid.uuid4().hex}.npy")
        np.save(p, img.host())
        mp = None
        if img.mask is not None:
            mp = p + ".mask.npy"
            np.save(mp, np.asarray(img.mask))
        return _Entry(p, mp, desc)

    def _restore(self, e: _Entry, like: SirilImage) -> SirilImage:
        img = like.copy(data=np.load(e.path))
        if e.mask_path and os.path.exists(e.mask_path):
            img.mask = np.load(e.mask_path)
            img.mask_active = like.mask_active
        return img

    def save_state(self, img: SirilImage, description: str) -> None:
        """Call before a destructive operation (undo_save_state)."""
        self._undo.append(self._spill(img, description))
        while len(self._undo) > MAX_HISTORY:
            self._drop(self._undo.pop(0))
        for e in self._redo:
            self._drop(e)
        self._redo.clear()

    def undo(self, current: SirilImage) -> Optional[SirilImage]:
        if not self._undo:
            return None
        self._redo.append(self._spill(current, "redo point"))
        e = self._undo.pop()
        img = self._restore(e, current)
        self._drop(e)
        return img

    def redo(self, current: SirilImage) -> Optional[SirilImage]:
        if not self._redo:
            return None
        self._undo.append(self._spill(current, "undo point"))
        e = self._redo.pop()
        img = self._restore(e, current)
        self._drop(e)
        return img

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def history(self) -> List[str]:
        return [e.description for e in self._undo]

    def _drop(self, e: _Entry) -> None:
        for p in (e.path, e.mask_path):
            if p and os.path.exists(p):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def clear(self) -> None:
        for e in self._undo + self._redo:
            self._drop(e)
        self._undo.clear()
        self._redo.clear()
