"""CLI session state — counterpart of ``siril_tpu/cli/context.py``
(``Session``:17, ``require_image``:44, ``set_image``:59,
``_find_film``:73, ``load_sequence``:86, ``CommandError``:118): the
working directory, the FITS extension, the star-finder preferences, the
FITS compression of ``save`` (``setcompress``), whether remote catalogues
may be queried (``online``), the photometry settings (``setphot``) and the
magnitude offset (``catmag``), the loaded image and its name, the current
sequence and the last result of a headless run.
(The reference's undo stack is not ported: ROADMAP §1.7, the surfaces.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.ops.photometry import PhotConfig
from siril_tpu_torch.registration.starfinder import StarFinderParams


class CommandError(Exception):
    """A command's arguments or preconditions are wrong."""


@dataclass
class Session:
    """Working state of one CLI run or script."""

    cwd: str = "."
    device: Optional[str] = None
    ext: str = ".fit"                            # setext
    starfinder: StarFinderParams = field(default_factory=StarFinderParams)
    focal_length: float = 0.0                    # setfindstar -focal=
    pixel_size: float = 0.0                      # setfindstar -pixelsize=
    #: setcompress: the tile codec of ``save`` ("rice", "gzip1", "gzip2"),
    #: or None for uncompressed files
    compression: Optional[str] = None
    #: ``online`` / ``offline``: the live TAP / SIMBAD transport may run
    #: (recorded fixtures serve queries either way)
    online: bool = False
    #: setphot: the aperture photometry settings (catmag)
    phot: PhotConfig = field(default_factory=PhotConfig)
    #: a selection (x, y, w, h) that ``crop`` takes without arguments
    selection: Optional[tuple] = None
    #: catmag: the absolute magnitude offset
    magnitude_offset: float = 0.0
    #: the arithmetic commands quantize to u16 (the reference's 16-bit
    #: mode)
    force_16bit: bool = False
    #: ``wavelet``: the planes (tensors on the session's device) and the
    #: image they came from, for a later ``wrecons``
    wavelet_planes: Optional[list] = None
    wavelet_img: Optional[SirilImage] = None
    #: pixel-math operands and ``fftd``'s modulus and phase for ``ffti``
    pm_images: Dict[str, SirilImage] = field(default_factory=dict)
    #: ``makepsf``: the PSF that ``rl``, ``wiener`` and ``sb`` take
    psf: Optional[object] = None
    sequence: Optional[Sequence] = None
    image: Optional[SirilImage] = None
    image_name: str = ""
    #: the last stack command's StackResult
    result: Optional[object] = None
    #: seconds per stage of the last command that keeps them
    stages: dict = field(default_factory=dict)
    #: one entry per script command: words, seconds, K1 launches, stages
    command_log: List[dict] = field(default_factory=list)

    def require_image(self) -> SirilImage:
        if self.image is None:
            raise CommandError("no image loaded (use `load` first)")
        return self.image

    def set_image(self, img: SirilImage, name: str) -> None:
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
