"""CLI session state — counterpart of ``siril_tpu/cli/context.py``
(``Session``:17, ``require_image``:44, ``set_image``:59,
``_find_film``:73, ``load_sequence``:86, ``CommandError``:118): the
working directory, the preferences (``core/settings.py``: the FITS
extension of ``setext``, the 16-bit mode of ``set16bits``, the FITS
compression of ``setcompress``, ``online`` / ``offline``, ``setmem``,
``set``), the star-finder preferences, the photometry settings
(``setphot``), the magnitude offset (``catmag``, ``setmag``), the star
list of ``findstar``, the loaded image and its name, the undo stack, the
current sequence, the last result of a headless run and the live stacker
of ``start_ls``.

A session's preferences are the active ones (``settings.get_settings``)
from the moment it is given them: at its creation, after the INI is
read at startup and after ``set -import=`` (ROADMAP §3, departure 27:
the JAX package's CLI replaces ``ctx.prefs`` after activating the first
object, so neither its INI nor ``set`` reaches ``get_settings()``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import siril_tpu_torch.utils.log  # noqa: F401 (the log fan-out)
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.core.settings import Preferences, set_active
from siril_tpu_torch.ops.photometry import PhotConfig
from siril_tpu_torch.registration.starfinder import StarFinderParams


class CommandError(Exception):
    """A command's arguments or preconditions are wrong."""


#: ``Preferences.comp_type`` by codec (the reference's comp_fits_method)
COMPRESSION_NAMES = ("rice", "gzip1", "gzip2", "hcompress")


@dataclass
class Session:
    """Working state of one CLI run or script."""

    cwd: str = "."
    device: Optional[str] = None
    #: the preferences (``set`` / ``get``); the FITS extension, the
    #: 16-bit mode, the compression and ``online`` are views of them
    prefs: Preferences = field(default_factory=Preferences)
    starfinder: StarFinderParams = field(default_factory=StarFinderParams)
    focal_length: float = 0.0                    # setfindstar -focal=
    pixel_size: float = 0.0                      # setfindstar -pixelsize=
    #: setphot: the aperture photometry settings (catmag)
    phot: PhotConfig = field(default_factory=PhotConfig)
    #: a selection (x, y, w, h) that ``crop`` takes without arguments
    selection: Optional[tuple] = None
    #: catmag / setmag: the absolute magnitude offset
    magnitude_offset: float = 0.0
    #: ``wavelet``: the planes (tensors on the session's device) and the
    #: image they came from, for a later ``wrecons``
    wavelet_planes: Optional[list] = None
    wavelet_img: Optional[SirilImage] = None
    #: pixel-math operands and ``fftd``'s modulus and phase for ``ffti``
    pm_images: Dict[str, SirilImage] = field(default_factory=dict)
    #: ``makepsf``: the PSF that ``rl``, ``wiener`` and ``sb`` take
    psf: Optional[object] = None
    #: ``findstar``: the last star list (``clearstar`` empties it)
    stars: list = field(default_factory=list)
    sequence: Optional[Sequence] = None
    image: Optional[SirilImage] = None
    image_name: str = ""
    #: the last stack command's StackResult
    result: Optional[object] = None
    #: seconds per stage of the last command that keeps them
    stages: dict = field(default_factory=dict)
    #: one entry per script command: words, seconds, K1 launches, stages
    command_log: List[dict] = field(default_factory=list)
    #: ``start_ls``'s running LiveStacker, until ``stop_ls``
    livestacker: Optional[object] = None
    #: the swap-file undo stack (``core/undo.py``), made at the first
    #: undo point
    undo_stack: Optional[object] = None
    undo_enabled: bool = True
    #: the command running now (set by ``cli.commands.Command``): it
    #: decides whether ``set_image`` saves an undo point
    command: str = ""
    #: ``exit``: the script, ``-i`` and ``-p`` loops stop
    stop_requested: bool = False

    def __setattr__(self, name, value):
        # the session's preferences are the active ones, whenever given
        object.__setattr__(self, name, value)
        if name == "prefs":
            set_active(value)

    # ---- views of the preferences (one state with ``set`` / ``get``) ----
    @property
    def ext(self) -> str:
        """``setext``: the FITS extension, with its dot."""
        e = self.prefs.ext
        return e if e.startswith(".") else "." + e

    @ext.setter
    def ext(self, value: str) -> None:
        self.prefs.ext = value

    @property
    def force_16bit(self) -> bool:
        """``set16bits``: ``save`` writes 16 bits and the arithmetic
        commands quantize to u16 (the reference's 16-bit mode)."""
        return bool(self.prefs.force_16bit)

    @force_16bit.setter
    def force_16bit(self, value: bool) -> None:
        self.prefs.force_16bit = bool(value)

    @property
    def compression(self) -> Optional[str]:
        """``setcompress``: the tile codec of ``save`` ("rice", "gzip1",
        "gzip2", "hcompress": ``comp_type`` 0-3, the reference's
        comp_fits_method), or None for uncompressed files (-1)."""
        t = int(self.prefs.comp_type)
        return COMPRESSION_NAMES[t] if 0 <= t < len(COMPRESSION_NAMES) \
            else None

    @compression.setter
    def compression(self, value: Optional[str]) -> None:
        if value is None:
            self.prefs.comp_type = -1
            return
        if value not in COMPRESSION_NAMES:
            raise CommandError(f"unknown compression type '{value}' "
                               f"(one of {', '.join(COMPRESSION_NAMES)})")
        self.prefs.comp_type = COMPRESSION_NAMES.index(value)

    @property
    def online(self) -> bool:
        """``online`` / ``offline``: the live TAP / SIMBAD transport may
        run (recorded fixtures serve queries either way)."""
        return bool(self.prefs.online)

    @online.setter
    def online(self, value: bool) -> None:
        self.prefs.online = bool(value)

    def require_image(self) -> SirilImage:
        if self.image is None:
            raise CommandError("no image loaded (use `load` first)")
        return self.image

    def set_image(self, img: SirilImage, name: str,
                  undo: Optional[bool] = None) -> None:
        """``img`` becomes the loaded image.  The replaced image becomes
        an undo point when ``undo`` is true, or, by default, when the
        running command is one whose replacement saves one in the JAX
        package (``core/undo.UNDO_COMMANDS``)."""
        if undo is None:
            from siril_tpu_torch.core.undo import UNDO_COMMANDS

            undo = self.command in UNDO_COMMANDS
        if undo and self.undo_enabled and self.image is not None and \
                img is not self.image:
            from siril_tpu_torch.core.undo import UndoStack

            if self.undo_stack is None:
                self.undo_stack = UndoStack()
            self.undo_stack.save_state(self.image, "image operation")
        self.image = img
        self.image_name = name

    def path(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.cwd, name)

    def _find_film(self, base: str) -> Optional[str]:
        """A film by its name, with or without its extension."""
        from siril_tpu_torch.io.films import FILM_EXTENSIONS, is_film

        if is_film(base) and os.path.exists(self.path(base)):
            return self.path(base)
        for e in FILM_EXTENSIONS:
            if os.path.exists(self.path(base + e)):
                return self.path(base + e)
        return None

    def load_sequence(self, name: str) -> Sequence:
        """A sequence by name: its ``.seq`` sidecar (also ``name_.seq``,
        the converted name), a ``.ser`` video, a film (an uncompressed AVI
        read by the port itself, any other film through OpenCV), else a
        scan of ``name%05d.fit`` files."""
        from siril_tpu_torch.io.seqfile import read_seqfile

        base = name[:-4] if name.endswith(".seq") else name
        if not os.path.exists(self.path(base + ".seq")) and \
                os.path.exists(self.path(base + "_.seq")):
            base = base + "_"
        if os.path.exists(self.path(base + ".seq")):
            seq = read_seqfile(self.path(base + ".seq"))
        elif os.path.exists(self.path(base + ".ser")) or name.endswith(".ser"):
            seq = Sequence.from_ser(self.path(
                name if name.endswith(".ser") else base + ".ser"))
        elif self._find_film(base) is not None:
            seq = Sequence.from_film(self._find_film(base))
        else:
            try:
                seq = Sequence.scan(base, self.cwd)
            except FileNotFoundError:
                if base.endswith("_"):
                    raise
                seq = Sequence.scan(base + "_", self.cwd)
        self.sequence = seq
        return seq
