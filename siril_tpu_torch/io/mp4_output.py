"""MP4 / WebM video export — counterpart of ``siril_tpu/io/mp4_output.py``
(``_FOURCC_PREF``:24-28, ``Mp4Writer``:31; the reference's
``src/io/mp4_output.c``, which encodes through libav* with CRF quality).

The encoder is OpenCV's ``cv2.VideoWriter`` (its ffmpeg backend), the
codec taken from the same preference list per format; dimensions are
rounded down to even values (the x264 requirement).  Where OpenCV is not
installed the writer raises a ``RuntimeError`` naming the cv2 module; it
never writes another format instead.
"""

from __future__ import annotations

import os

import numpy as np

# export_format values mirroring sequence_export.c EXPORT_MP4/MP4_H265/WEBM
MP4 = "mp4"
MP4_H265 = "mp4-h265"
WEBM_VP9 = "webm"

_FOURCC_PREF = {
    MP4: ("avc1", "mp4v"),
    MP4_H265: ("hvc1", "hev1", "mp4v"),
    WEBM_VP9: ("VP90", "VP80"),
}


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "MP4 / WebM export needs OpenCV (the cv2 module), which is not "
            "installed") from exc
    return cv2


class Mp4Writer:
    """mp4_struct (mp4_output.h:10) over cv2.VideoWriter."""

    def __init__(self, filename: str, width: int, height: int,
                 fps: int = 25, nb_layers: int = 1, quality: int = 3,
                 fmt: str = MP4):
        cv2 = _cv2()
        if fps <= 0:
            fps = 25
        self.dst_w = width - (width % 2)
        self.dst_h = height - (height % 2)
        self.nb_layers = nb_layers
        self.fmt = fmt
        self.filename = filename
        self._writer = None
        for fourcc in _FOURCC_PREF[fmt]:
            w = cv2.VideoWriter(filename, cv2.VideoWriter_fourcc(*fourcc),
                                float(fps), (self.dst_w, self.dst_h))
            if w.isOpened():
                self._writer = w
                self.fourcc = fourcc
                break
            w.release()
        if self._writer is None:
            raise RuntimeError(f"no usable encoder for {fmt}")
        # quality 1..5 as a hint to the backend (the reference maps it to
        # a CRF, mp4_output.c:49-51; many OpenCV builds ignore the knob)
        try:
            self._writer.set(cv2.VIDEOWRITER_PROP_QUALITY,
                             float(20 * max(1, min(5, quality))))
        except Exception:
            pass
        self.nframes = 0

    def add_frame(self, img) -> None:
        """mp4_add_frame: float (C, H, W) → an 8-bit BGR frame."""
        data = np.asarray(img.data if hasattr(img, "data") else img)
        u8 = np.clip(data * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if u8.shape[0] == 1:
            bgr = np.repeat(u8[0][..., None], 3, axis=2)
        else:
            bgr = u8[:3].transpose(1, 2, 0)[..., ::-1]
        self._writer.write(
            np.ascontiguousarray(bgr[:self.dst_h, :self.dst_w]))
        self.nframes += 1

    def close(self, aborted: bool = False) -> int:
        """mp4_close: finish the container; an aborted file is removed."""
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        if aborted and os.path.exists(self.filename):
            os.unlink(self.filename)
        return self.nframes
