"""SirilInterface — counterpart of ``siril_tpu/pythonmodule/connection.py``
(the reference's python_module/sirilpy/connection.py:42): the sirilpy
surface in process, over the port's ``cli.context.Session``.

Pixels cross this boundary as numpy arrays (``SirilImage.host()``); the
image ops of the commands run on the session's device, and
``set_image_pixeldata`` checks that device first (no card and no
``device="cpu"``: it raises, as every entry point does).  The undo
points, the log buffer and progress (``utils/log.py``) and the
configuration (``get_siril_config``, over the session's preferences) are
the session's.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from siril_tpu_torch.cli.context import CommandError, Session
from siril_tpu_torch.cli.parser import execute_command
from siril_tpu_torch.core.image import SirilImage


_log = logging.getLogger(__name__)


class SirilError(Exception):
    pass


@dataclass
class ImageStats:
    total: int
    ngoodpix: int
    mean: float
    median: float
    sigma: float
    avgdev: float
    mad: float
    sqrtbwmv: float
    min: float
    max: float
    normvalue: float
    bgnoise: float


class SirilInterface:
    """Drive the framework from Python scripts (sirilpy-compatible)."""

    def __init__(self, session: Optional[Session] = None):
        self._ctx = session
        self.connected = False

    # ---- lifecycle (connection.py connect/disconnect) ----
    def connect(self, workdir: str = ".") -> bool:
        if self._ctx is None:
            self._ctx = Session(cwd=os.path.abspath(workdir))
        self.connected = True
        return True

    def disconnect(self) -> None:
        self.connected = False

    def is_image_loaded(self) -> bool:
        return self._ctx is not None and self._ctx.image is not None

    def is_sequence_loaded(self) -> bool:
        return self._ctx is not None and self._ctx.sequence is not None

    @property
    def ctx(self) -> Session:
        if self._ctx is None:
            raise SirilError("not connected (call connect())")
        return self._ctx

    # ---- commands ----
    def cmd(self, *args) -> None:
        """Run any Siril command (sirilpy cmd())."""
        words = [str(a) for a in args]
        rc = execute_command(self.ctx, words)
        if rc != 0:
            raise CommandError(f"command failed: {' '.join(words)}")

    # ---- pixel data ----
    def get_image_pixeldata(self, channel: Optional[int] = None
                            ) -> np.ndarray:
        """(H, W) or (C, H, W) float32 array of the loaded image."""
        img = self._require_image()
        data = img.host()
        if channel is not None:
            return data[channel].copy()
        return data.copy() if data.shape[0] > 1 else data[0].copy()

    def set_image_pixeldata(self, data: np.ndarray) -> None:
        """Replace the loaded image's pixels (an undo point, as
        ``set_image`` without a name in the JAX package)."""
        from siril_tpu_torch.core.image import ensure_chw
        from siril_tpu_torch.device import resolve_device

        resolve_device(self.ctx.device)
        img = self._require_image()
        self.ctx.set_image(img.copy(data=ensure_chw(np.asarray(data))),
                           self.ctx.image_name, undo=True)

    def get_seq_frame_pixeldata(self, frame: int,
                                channel: Optional[int] = None) -> np.ndarray:
        seq = self._require_seq()
        data = seq.read_frame(frame).host()
        if channel is not None:
            return data[channel]
        return data if data.shape[0] > 1 else data[0]

    # ---- image metadata ----
    def get_image_shape(self) -> Tuple[int, int, int]:
        img = self._require_image()
        return (img.nchans, img.height, img.width)

    def get_image_filename(self) -> str:
        return self.ctx.image_name

    def get_image_keywords(self):
        return self._require_image().keywords

    def get_image_header(self) -> Optional[str]:
        """The source FITS header's text (the JAX package keeps it as
        ``header_text``; the port keeps the parsed header)."""
        h = self._require_image().fits_header
        return None if h is None else h.text()

    def get_image_history(self) -> List[str]:
        return list(self._require_image().history)

    def get_image_stats(self, channel: int = 0) -> ImageStats:
        from siril_tpu_torch.ops.statistics import STATS_MAIN, compute_stats_np

        img = self._require_image()
        s = compute_stats_np(img.host()[channel], STATS_MAIN)
        return ImageStats(total=int(s.total), ngoodpix=int(s.ngoodpix),
                          mean=s.mean, median=s.median, sigma=s.sigma,
                          avgdev=s.avgdev, mad=s.mad, sqrtbwmv=s.sqrtbwmv,
                          min=s.min, max=s.max, normvalue=s.normvalue,
                          bgnoise=s.bgnoise)

    # ---- sequence accessors ----
    def get_seq(self):
        return self._require_seq()

    def get_seq_frame_count(self) -> int:
        return self._require_seq().number

    def get_seq_regdata(self, frame: int, channel: int = 0) -> dict:
        seq = self._require_seq()
        reg = seq.reg(channel)
        return {"fwhm": float(reg.fwhm[frame]),
                "weighted_fwhm": float(reg.weighted_fwhm[frame]),
                "roundness": float(reg.roundness[frame]),
                "quality": float(reg.quality[frame]),
                "background_lvl": float(reg.background_lvl[frame]),
                "number_of_stars": int(reg.number_of_stars[frame]),
                "H": reg.H[frame].tolist()}

    def get_seq_stats(self, frame: int, channel: int = 0):
        return self._require_seq().get_frame_stats(channel, frame)

    def set_seq_frame_incl(self, frame: int, incl: bool) -> None:
        seq = self._require_seq()
        seq.incl[frame] = incl
        seq.needs_saving = True

    # ---- stars / psf ----
    def get_stars(self):
        """Stars from the last findstar run (or detect now)."""
        stars = getattr(self.ctx, "stars", None)
        if not stars:
            img = self._require_image()
            stars = self._detect(img.host()[1 if img.nchans == 3 else 0])
            self.ctx.stars = stars
        return stars

    def _detect(self, layer: np.ndarray, params=None):
        """Stars of one (H, W) layer, detected on the session's device."""
        import torch

        from siril_tpu_torch.device import resolve_device
        from siril_tpu_torch.registration.starfinder import detect_stars

        dev = resolve_device(self.ctx.device)
        return detect_stars(torch.from_numpy(np.ascontiguousarray(
            layer, np.float32)).to(dev), params)

    # ---- WCS ----
    def has_wcs(self) -> bool:
        img = self._require_image()
        return img.wcs is not None

    def pix2radec(self, x: float, y: float) -> Tuple[float, float]:
        img = self._require_image()
        if img.wcs is None:
            raise SirilError("image is not plate-solved")
        ra, dec = img.wcs.pix2world(np.array([x]), np.array([y]))
        return float(ra[0]), float(dec[0])

    def radec2pix(self, ra: float, dec: float) -> Tuple[float, float]:
        img = self._require_image()
        if img.wcs is None:
            raise SirilError("image is not plate-solved")
        x, y = img.wcs.world2pix(np.array([ra]), np.array([dec]))
        return float(x[0]), float(y[0])

    # ---- masks / selection ----
    def get_image_mask(self) -> Optional[np.ndarray]:
        img = self._require_image()
        return None if img.mask is None else np.array(img.mask)

    def set_image_mask(self, mask: Optional[np.ndarray]) -> None:
        img = self._require_image()
        img.mask = None if mask is None else np.asarray(mask, np.float32)
        img.mask_active = mask is not None

    def get_selection(self):
        return self.ctx.selection

    def set_selection(self, x: int, y: int, w: int, h: int) -> None:
        self.ctx.selection = (x, y, w, h)

    # ---- undo ----
    def undo_save_state(self, description: str = "python script") -> None:
        from siril_tpu_torch.core.undo import UndoStack

        if self.ctx.undo_stack is None:
            self.ctx.undo_stack = UndoStack()
        self.ctx.undo_stack.save_state(self._require_image(), description)

    def undo(self) -> None:
        self.cmd("undo")

    # ---- misc ----
    def log(self, message: str) -> None:
        _log.info("%s", message)

    def get_siril_version(self) -> str:
        from siril_tpu_torch.cli.commands import VERSION

        return VERSION

    def image_lock(self):
        """Context manager kept for sirilpy compatibility (in-process:
        the command engine serializes operations already)."""
        import contextlib

        return contextlib.nullcontext()

    # ---- internals ----
    def _require_image(self) -> SirilImage:
        img = self.ctx.image
        if img is None:
            raise SirilError("no image loaded")
        return img

    def _require_seq(self):
        seq = self.ctx.sequence
        if seq is None:
            raise SirilError("no sequence loaded")
        return seq

    # ------------------------------------------------------------------
    # extended sirilpy surface (connection.py:1847-5981)
    # ------------------------------------------------------------------

    # ---- logging variants (sirilpy log colors map to levels) ----
    def log_error(self, message: str) -> None:
        _log.error("%s", message)

    def log_warning(self, message: str) -> None:
        _log.warning("%s", message)

    def log_info(self, message: str) -> None:
        self.log(message)

    def log_status(self, message: str) -> None:
        self.log(message)

    def log_bold(self, message: str) -> None:
        self.log(message)

    def get_siril_log(self, n_lines: int = 0) -> List[str]:
        from siril_tpu_torch.utils.log import get_log_buffer

        buf = get_log_buffer()
        return buf[-n_lines:] if n_lines else list(buf)

    # ---- progress (GUI progress bar → stderr in headless) ----
    def update_progress(self, message: str, progress: float) -> None:
        from siril_tpu_torch.utils.log import log_progress

        log_progress(progress, message)

    def reset_progress(self) -> None:
        from siril_tpu_torch.utils.log import log_progress

        log_progress(-1.0, None)

    # ---- messageboxes: headless auto-acknowledge, logged ----
    def confirm_messagebox(self, title: str, message: str,
                           confirm_label: str = "OK") -> bool:
        self.log(f"[{title}] {message} → auto-confirmed (headless)")
        return True

    def error_messagebox(self, message: str, *a) -> bool:
        self.log_error(message)
        return True

    def info_messagebox(self, message: str, *a) -> bool:
        self.log(message)
        return True

    def warning_messagebox(self, message: str, *a) -> bool:
        self.log_warning(message)
        return True

    # ---- thread claim (reference CMD_CLAIM_THREAD; in-process no-op) ----
    def _claim_thread(self) -> bool:
        return True

    def _release_thread(self) -> None:
        pass

    def is_cli(self) -> bool:
        return True

    def command_error_message(self, rc) -> str:
        return f"command returned {rc}"

    # ---- paths / config ----
    def get_siril_wd(self) -> str:
        return os.path.abspath(self.ctx.cwd)

    def get_siril_configdir(self) -> str:
        return os.path.expanduser("~/.config/siril_tpu")

    def get_siril_userdatadir(self) -> str:
        return os.path.expanduser("~/.local/share/siril_tpu")

    def get_siril_systemdatadir(self) -> str:
        import siril_tpu

        return os.path.join(os.path.dirname(siril_tpu_torch.__file__), "data")

    def get_siril_config(self, group: str, key: str):
        if (group, key) == ("core", "extension"):
            return self.ctx.ext
        if group == "core" and key == "wd":
            return self.ctx.cwd
        return getattr(self.ctx.prefs, key, None)

    # ---- full-image / frame models ----
    def get_image(self, with_pixels: bool = True) -> SirilImage:
        img = self._require_image()
        return img if with_pixels else img.copy(
            data=np.zeros((img.nchans, 1, 1), np.float32))

    def get_seq_frame(self, frame: int, with_pixels: bool = True):
        seq = self._require_seq()
        if with_pixels:
            return seq.read_frame(frame)
        return seq.read_frame_metadata(frame)

    def get_seq_frame_filename(self, frame: int) -> Optional[str]:
        return self._require_seq().frame_path(frame)

    def get_seq_frame_header(self, frame: int) -> str:
        seq = self._require_seq()
        h = seq.read_frame(frame).fits_header
        return "" if h is None else h.text()

    def get_seq_imgdata(self, frame: int) -> dict:
        seq = self._require_seq()
        # the port's sequences keep no per-frame date or airmass (the JAX
        # package's are None and 0 for a sequence of files)
        dates = getattr(seq, "date_obs", [])
        airmass = getattr(seq, "airmass", [])
        return {"filenum": int(seq.filenum[frame]),
                "incl": bool(seq.incl[frame]),
                "date_obs": dates[frame] if frame < len(dates) else None,
                "airmass": float(airmass[frame])
                if frame < len(airmass) else 0.0,
                "rx": int(seq.rx), "ry": int(seq.ry)}

    def set_seq_frame_pixeldata(self, frame: int, data: np.ndarray,
                                prefix: Optional[str] = None) -> None:
        """Overwrite one frame of a file-list sequence, or save it with a
        new ``prefix`` for a to-be-created sequence (sirilpy:2161)."""
        from siril_tpu_torch.core.image import ensure_chw
        from siril_tpu_torch.io.fits_io import write_fits

        seq = self._require_seq()
        path = seq.frame_path(frame)
        if path is None:
            raise SirilError("sequence frames are not individually "
                             "writable (SER/FITSEQ)")
        img = seq.read_frame(frame)
        out = img.copy(data=ensure_chw(np.asarray(data, np.float32)))
        if prefix:
            d, base = os.path.split(path)
            path = os.path.join(d, prefix + base)
        write_fits(out, path, bitdepth=out.orig_bitdepth)
        seq.close_readers()

    def get_image_fits_header(self, return_as: str = "str") -> str:
        return self.get_image_header() or ""

    def get_image_unknown_keys(self) -> str:
        img = self._require_image()
        return "\n".join(f"{k} = {v}"
                         for k, v in img.keywords.extra.items())

    def set_image_metadata_from_header_string(self, header: str) -> None:
        img = self._require_image()
        for line in header.splitlines():
            if "=" not in line:
                continue
            k, _, v = line.partition("=")
            v = v.split("/")[0].strip().strip("'\" ")
            for conv in (int, float):
                try:
                    v = conv(v)
                    break
                except ValueError:
                    pass
            img.keywords.extra[k.strip().upper()] = v

    def set_image_filename(self, name: str) -> None:
        self.ctx.image_name = name

    # ---- ICC ----
    def get_image_iccprofile(self) -> Optional[bytes]:
        img = self._require_image()
        return getattr(img, "icc_profile", None)

    def set_image_iccprofile(self, profile: Optional[bytes]) -> None:
        self._require_image().icc_profile = profile

    # ---- selection-based star / stats ----
    def get_selection_star(self, channel: Optional[int] = None):
        import torch

        from siril_tpu_torch.device import resolve_device
        from siril_tpu_torch.registration.psf import (
            fit_psf_batch,
            stars_from_fit,
        )

        img = self._require_image()
        sel = self.ctx.selection
        if not sel:
            raise SirilError("no selection")
        x, y, w, h = sel
        chan = channel if channel is not None else (1 if img.nchans == 3
                                                    else 0)
        patch = img.host()[chan, y:y + h, x:x + w].astype(np.float32)
        dev = resolve_device(self.ctx.device)
        fit = fit_psf_batch(torch.from_numpy(np.ascontiguousarray(
            patch[None])).to(dev))
        return stars_from_fit(fit, np.array([x]), np.array([y]),
                              max(w, h))[0]

    def get_selection_stats(self, channel: int = 0) -> ImageStats:
        from siril_tpu_torch.ops.statistics import STATS_MAIN, compute_stats_np

        img = self._require_image()
        sel = self.ctx.selection
        if not sel:
            raise SirilError("no selection")
        x, y, w, h = sel
        s = compute_stats_np(img.host()[channel, y:y + h, x:x + w],
                             STATS_MAIN)
        return ImageStats(total=int(s.total), ngoodpix=int(s.ngoodpix),
                          mean=s.mean, median=s.median, sigma=s.sigma,
                          avgdev=s.avgdev, mad=s.mad, sqrtbwmv=s.sqrtbwmv,
                          min=s.min, max=s.max, normvalue=s.normvalue,
                          bgnoise=s.bgnoise)

    def get_image_stars(self):
        return self.get_stars()

    # ---- plots (sirilpy xy_plot → siril_plot equivalent) ----
    def xy_plot(self, plot_data) -> bool:
        """Accepts sirilpy PlotData-like dicts or (x, y) tuples; saves a
        .dat (and .png when matplotlib is available)."""
        import time as _t

        base = os.path.join(self.ctx.cwd,
                            f"plot_{int(_t.monotonic() * 1000) & 0xFFFFFF}")
        if isinstance(plot_data, dict):
            if plot_data.get("series"):            # wire PlotData payload
                s0 = plot_data["series"][0]
                xs, ys = s0.get("x", []), s0.get("y", [])
            else:
                xs = plot_data.get("x", [])
                ys = plot_data.get("y", [])
            title = plot_data.get("title", "plot")
        else:
            xs, ys = plot_data
            title = "plot"
        with open(base + ".dat", "w") as f:
            f.write(f"# {title}\n")
            for a, b in zip(xs, ys):
                f.write(f"{a} {b}\n")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(8, 5))
            plt.plot(xs, ys)
            plt.title(title)
            plt.savefig(base + ".png", dpi=100)
            plt.close()
        except ImportError:
            pass
        self.log(f"plot saved: {base}.dat")
        return True

    # ---- background samples (sirilpy:1918-2048, 3862) ----
    def set_image_bgsamples(self, points, show_samples: bool = False,
                            recalculate: bool = True) -> None:
        """Store background samples; like the reference, sample stats
        are (re)computed from the image patch around each position
        (background_extraction.c sample semantics)."""
        def as_dict(p):
            if isinstance(p, dict):
                return dict(p)
            if hasattr(p, "position"):
                return {"position": tuple(p.position),
                        "median": tuple(getattr(p, "median", (0, 0, 0))),
                        "mean": float(getattr(p, "mean", 0.0)),
                        "min": float(getattr(p, "min", 0.0)),
                        "max": float(getattr(p, "max", 0.0)),
                        "size": int(getattr(p, "size", 25)),
                        "valid": bool(getattr(p, "valid", True))}
            return {"position": (float(p[0]), float(p[1]))}
        samples = [as_dict(p) for p in points]
        img = self.ctx.image
        # one device→host fetch shared by all samples (host() inside the
        # loop would re-fetch the full image once per sample)
        data = None
        for s in samples:
            s.setdefault("size", 25)
            s.setdefault("valid", True)
            if (recalculate or "median" not in s) and img is not None:
                if data is None:
                    data = img.host()
                x, y = s["position"]
                half = int(s["size"]) // 2
                y0 = max(int(round(y)) - half, 0)
                x0 = max(int(round(x)) - half, 0)
                patch = data[:, y0:y0 + s["size"], x0:x0 + s["size"]]
                if patch.size:
                    med = [float(np.median(patch[c]))
                           for c in range(patch.shape[0])]
                    med += [0.0] * (3 - len(med))
                    s["median"] = tuple(med[:3])
                    s["mean"] = float(patch.mean())
                    s["min"] = float(patch.min())
                    s["max"] = float(patch.max())
            s.setdefault("median", (0.0, 0.0, 0.0))
            s.setdefault("mean", 0.0)
            s.setdefault("min", 0.0)
            s.setdefault("max", 0.0)
        self.ctx.bg_samples = samples

    def get_image_bgsamples(self):
        return getattr(self.ctx, "bg_samples", [])

    def clear_image_bgsamples(self) -> None:
        self.ctx.bg_samples = []

    # ---- overlay polygons (sirilpy:4075-4361; headless store) ----
    def overlay_add_polygon(self, polygon):
        polys = getattr(self.ctx, "overlay_polygons", None)
        if polys is None:
            polys = self.ctx.overlay_polygons = {}
        pid = (max(polys) + 1) if polys else 1
        polys[pid] = polygon
        if isinstance(polygon, dict):
            polygon["polygon_id"] = pid
        else:
            try:
                polygon.polygon_id = pid
            except AttributeError:
                pass
        return polygon

    def overlay_delete_polygon(self, polygon_id: int) -> None:
        getattr(self.ctx, "overlay_polygons", {}).pop(polygon_id, None)

    def overlay_clear_polygons(self) -> None:
        self.ctx.overlay_polygons = {}

    def overlay_get_polygon(self, polygon_id: int):
        return getattr(self.ctx, "overlay_polygons", {}).get(polygon_id)

    def overlay_get_polygons_list(self):
        return list(getattr(self.ctx, "overlay_polygons", {}).values())

    # ---- mask polygons (sirilpy:5937-5980) ----
    def _polygon_mask(self, points) -> np.ndarray:
        img = self._require_image()
        h, w = img.height, img.width
        yy, xx = np.mgrid[0:h, 0:w]
        # even-odd rule point-in-polygon, vectorized over the image
        inside = np.zeros((h, w), bool)
        pts = [(float(p[0]), float(p[1])) for p in points]
        n = len(pts)
        for i in range(n):
            x1, y1 = pts[i]
            x2, y2 = pts[(i + 1) % n]
            cond = ((y1 > yy) != (y2 > yy)) & \
                (xx < (x2 - x1) * (yy - y1) / (y2 - y1 + 1e-12) + x1)
            inside ^= cond
        return inside.astype(np.float32)

    def mask_add_polygon(self, points) -> None:
        img = self._require_image()
        m = self._polygon_mask(points)
        img.mask = m if img.mask is None else np.maximum(img.mask, m)

    def mask_subtract_polygon(self, points) -> None:
        img = self._require_image()
        if img.mask is None:
            return
        img.mask = np.clip(img.mask - self._polygon_mask(points), 0, 1)

    def set_image_mask_state(self, active: bool) -> None:
        self._require_image().mask_active = bool(active)

    def get_image_mask_state(self) -> bool:
        return bool(getattr(self._require_image(), "mask_active", False))

    # ---- file-level helpers (sirilpy:4362-4814, 5389) ----
    def load_image_from_file(self, path: str) -> SirilImage:
        from siril_tpu_torch.io.conversion import load_any

        return load_any(path if os.path.isabs(path)
                        else os.path.join(self.ctx.cwd, path))

    def save_image_file(self, img: SirilImage, path: str,
                        bitdepth: Optional[int] = None,
                        header: Optional[str] = None) -> None:
        from siril_tpu_torch.io.fits_io import write_fits

        if header:
            for line in header.splitlines():
                if "=" not in line:
                    continue
                k, _, v = line.partition("=")
                v = v.split("/")[0].strip().strip("'\" ")
                img.keywords.extra[k.strip().upper()] = v
        p = path if os.path.isabs(path) else os.path.join(self.ctx.cwd, path)
        write_fits(img, p, bitdepth=bitdepth or img.orig_bitdepth)

    def analyse_image_from_file(self, path: str) -> dict:
        """Image culling metrics (siril_pythonmodule ANALYSE_IMAGE_FILE):
        noise + star stats + dimensions."""
        from siril_tpu_torch.ops.statistics import STATS_MAIN, compute_stats_np
        from siril_tpu_torch.registration.starfinder import StarFinderParams

        img = self.load_image_from_file(path)
        s = compute_stats_np(img.host()[0], STATS_MAIN)
        try:
            stars = self._detect(img.host()[0], StarFinderParams())
        except Exception:
            stars = []
        fwhms = [st.fwhmx for st in stars if st.fwhmx > 0]
        rnds = [st.fwhmy / st.fwhmx for st in stars if st.fwhmx > 0]
        from siril_tpu_torch.pythonmodule.wire_formats import _ts

        return {"shape": (img.nchans, img.height, img.width),
                "mean": s.mean, "median": s.median, "bgnoise": s.bgnoise,
                "fwhm": float(np.median(fwhms)) if fwhms else 0.0,
                "wfwhm": float(np.median(fwhms)) if fwhms else 0.0,
                "nbstars": len(stars),
                "roundness": float(np.median(rnds)) if rnds else 0.0,
                "imagetype": 0,
                "timestamp": _ts(img.keywords.date_obs),
                "channels": img.nchans, "height": img.height,
                "width": img.width, "filter": img.keywords.filter}

    def create_new_seq(self, name: str, files: Sequence[str]):
        from siril_tpu_torch.core.sequence import Sequence as Seq

        paths = [f if os.path.isabs(f) else os.path.join(self.ctx.cwd, f)
                 for f in files]
        # .seq sidecars resolve frames by the `<name><NNNNN>.<ext>`
        # convention (io/seqfile.c) — derive the real prefix from the
        # files so the sequence survives a save/reload round-trip
        import re as _re

        m = _re.match(r"(.*?)(\d+)\.\w+$", os.path.basename(paths[0]))
        if m and m.group(1) != name:
            self.log_warning(f"create_new_seq: using file prefix "
                             f"'{m.group(1)}' as the sequence name "
                             f"(files must match <name><NNNNN>.<ext>)")
            name = m.group(1)
        seq = Seq.from_files(paths, name=name)
        seq.save()
        self.ctx.sequence = seq
        return seq

    # ---- undo extensions ----
    def redo(self) -> None:
        self.cmd("redo")

    def clear_undo_history(self) -> None:
        self.ctx.undo_stack = None

    # ---- display-state holders (GUI-only in the reference; kept as
    # session state so scripts round-trip: sirilpy:4942-5292) ----
    def get_siril_slider_state(self):
        return getattr(self.ctx, "_slider_state", (0, 65535, 0))

    def set_siril_slider_mode(self, mode) -> None:
        lo, hi, _ = self.get_siril_slider_state()
        self.ctx._slider_state = (lo, hi, mode)

    def set_siril_slider_lohi(self, lo: float, hi: float) -> None:
        _, _, mode = self.get_siril_slider_state()
        self.ctx._slider_state = (lo, hi, mode)

    def get_siril_stf(self):
        return getattr(self.ctx, "_stf", 0) or 0

    def set_siril_stf(self, stf) -> None:
        self.ctx._stf = stf

    def get_siril_stf_linked(self) -> bool:
        return bool(getattr(self.ctx, "_stf_linked", True))

    def set_siril_stf_linked(self, linked: bool) -> None:
        self.ctx._stf_linked = bool(linked)

    def get_siril_panzoom(self):
        return getattr(self.ctx, "_panzoom", (0.0, 0.0, 1.0))

    def set_siril_pan(self, x: float, y: float) -> None:
        _, _, z = self.get_siril_panzoom()
        self.ctx._panzoom = (x, y, z)

    def set_siril_zoom(self, zoom: float) -> None:
        x, y, _ = self.get_siril_panzoom()
        self.ctx._panzoom = (x, y, zoom)

    def get_siril_active_vport(self) -> int:
        return 0

    def get_siril_display_iccprofile(self) -> Optional[bytes]:
        return None

    def open_dialog(self, *a, **kw):
        raise SirilError("dialogs are not available headless")

    def get_seq_distodata(self, channel: int = 0) -> dict:
        return {"index": 0, "velocity": (0.0, 0.0)}

    def export_sequence_avi(self, path: str, fps: float = 25.0) -> int:
        """Export the loaded sequence as an uncompressed AVI (the
        reference's AVI export, avi_pipp)."""
        from siril_tpu_torch.io.avi import export_avi

        p = path if os.path.isabs(path) else os.path.join(self.ctx.cwd, path)
        return export_avi(self._require_seq(), p, fps)

    def export_sequence_video(self, basename: str, fmt: str = "mp4",
                              fps: int = 25, quality: int = 3) -> int:
        """Export the loaded sequence as MP4/WebM/AVI/SER/FITSEQ/TIFF
        (sequence_export.c headless surface)."""
        from siril_tpu_torch.io.sequence_export import ExportArgs, export_sequence

        return export_sequence(
            self._require_seq(),
            ExportArgs(output=fmt, basename=basename, fps=fps,
                       quality=quality),
            directory=self.ctx.cwd)
