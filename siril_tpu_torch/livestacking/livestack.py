"""Live stacking — counterpart of ``siril_tpu/livestacking/livestack.py``
(``LiveStackConfig``:28, ``LiveStacker``:40; the reference's
``src/livestacking/``): watch a directory for new frames, calibrate,
debayer, register (by phase-correlation shifts or by stars) and add each
frame to a running sum.

A watcher thread polls the directory (``poll_s``) and a worker thread
takes the queued files one at a time; ``process_file`` also runs
synchronously (the ``livestack <file>`` command).  The frame is uploaded
once: calibration (``ops.calibration.calibrate_tensor``), the demosaic
(``ops.demosaic.debayer_tensor``), the alignment and the sum run on the
stacker's device (CUDA unless "cpu"), and the float64 running sum stays
there (the JAX package keeps it on the host, livestack.py:131); only the
result comes back to be written.  The worker stops between frames when
a stop is requested (``core.processing``).
"""

from __future__ import annotations

import glob
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
from siril_tpu_torch.core.processing import processing_should_continue
from siril_tpu_torch.device import DeviceLike, resolve_device, synchronize

_log = logging.getLogger(__name__)


@dataclass
class LiveStackConfig:
    calibrate: bool = False
    bias: Optional[SirilImage] = None
    dark: Optional[SirilImage] = None
    flat: Optional[SirilImage] = None
    debayer: bool = False
    use_registration: bool = True       # star registration; else shift
    shift_only: bool = True
    out_name: str = "live_stack_result.fit"
    poll_s: float = 1.0


class LiveStacker:
    def __init__(self, directory: str,
                 config: Optional[LiveStackConfig] = None,
                 device: DeviceLike = None):
        self.dir = os.path.abspath(directory)
        self.cfg = config or LiveStackConfig()
        self.device = resolve_device(device)
        self.q: "queue.Queue" = queue.Queue()
        #: the float64 running sum, on ``device``
        self.acc: Optional[torch.Tensor] = None
        self.count = 0
        self.failed = 0
        self.ref_stars = None
        self.ref_layer = None
        self._ref_plane: Optional[torch.Tensor] = None
        self._seen = set()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._worker: Optional[threading.Thread] = None
        self._calib_state = None
        self._lock = threading.RLock()
        #: milliseconds of each processed frame (read to sum, synchronized)
        self.frame_ms: List[float] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        """start_ls: files already in the directory are ignored; only new
        arrivals are stacked."""
        for f in self._list_frames():
            self._seen.add(f)
        self._stop.clear()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._watcher.start()
        self._worker.start()
        _log.info("Live stacking started, watching %s", self.dir)

    def stop(self) -> None:
        self._stop.set()
        if self._watcher:
            self._watcher.join(timeout=5)
        self.q.put(None)
        if self._worker:
            self._worker.join(timeout=30)
        _log.info("Live stacking stopped (%d frames stacked, %d failed)",
                  self.count, self.failed)

    def _list_frames(self):
        out = []
        for ext in ("*.fit", "*.fits", "*.fts"):
            out.extend(glob.glob(os.path.join(self.dir, ext)))
        return [f for f in out
                if not os.path.basename(f).startswith("live_stack")]

    def _watch(self) -> None:
        while not self._stop.is_set():
            for f in sorted(self._list_frames()):
                if f not in self._seen:
                    self._seen.add(f)
                    self.q.put(f)
            time.sleep(self.cfg.poll_s)

    # ------------------------------------------------------------------
    def _work(self) -> None:
        while True:
            item = self.q.get()
            try:
                if item is None or self._stop.is_set() or \
                        not processing_should_continue():
                    return
                try:
                    self.process_file(item)
                except Exception as e:
                    self.failed += 1
                    _log.error("livestack: %s failed: %s",
                               os.path.basename(item), e)
            finally:
                self.q.task_done()

    def process_file(self, path: str) -> None:
        from siril_tpu_torch.io.conversion import load_any

        t = time.perf_counter()
        img = load_any(path)
        self.process_frame(img, os.path.basename(path), t0=t)

    def process_frame(self, img: SirilImage, name: str = "",
                      t0: Optional[float] = None) -> None:
        with self._lock:
            self._process(img, name)
            synchronize(self.device)
        self.frame_ms.append(
            (time.perf_counter() - (t0 or time.perf_counter())) * 1e3)

    def _process(self, img: SirilImage, name: str) -> None:
        from siril_tpu_torch.ops.calibration import (
            CalibArgs,
            calibrate_tensor,
            prepare_calibration,
        )

        cfg = self.cfg
        x = torch.from_numpy(img.host()).to(self.device)
        if cfg.calibrate and (cfg.bias or cfg.dark or cfg.flat):
            if self._calib_state is None:
                ca = CalibArgs(bias=cfg.bias, dark=cfg.dark, flat=cfg.flat,
                               use_cosmetic=cfg.dark is not None,
                               is_cfa=img.is_cfa())
                self._calib_state = prepare_calibration(ca, img,
                                                        self.device)
            x = calibrate_tensor(x, self._calib_state)
        if cfg.debayer and img.is_cfa():
            from siril_tpu_torch.ops.demosaic import debayer_tensor

            x = debayer_tensor(x, img)
        if self.acc is None:
            self.acc = x.double()
            self.count = 1
            if cfg.use_registration:
                self._init_reference(x)
            _log.info("livestack: reference frame set (%s)", name)
            return
        aligned = self._align(x)
        if aligned is None:
            self.failed += 1
            _log.error("livestack: %s could not be aligned, skipped", name)
            return
        self.acc += aligned
        self.count += 1
        if self.count % 5 == 0 or self.count < 5:
            self._report()
            self.save_result()

    def _init_reference(self, x: torch.Tensor) -> None:
        from siril_tpu_torch.registration.starfinder import detect_stars

        self.ref_layer = min(1, x.shape[0] - 1)
        if not self.cfg.shift_only:
            self.ref_stars = detect_stars(x[self.ref_layer])
        self._ref_plane = x[self.ref_layer]

    def _align(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if not cfg.use_registration:
            return x
        if cfg.shift_only:
            from siril_tpu_torch.registration.shift import (
                decode_phasecorr_peaks,
                phase_correlate_device,
            )

            h, w = x.shape[1:]
            d = decode_phasecorr_peaks(phase_correlate_device(
                self._ref_plane, x[self.ref_layer][None]), h, w)[0]
            dx, dy = int(round(d[0])), int(round(d[1]))
            sy0, sy1 = max(dy, 0), min(h + dy, h)
            sx0, sx1 = max(dx, 0), min(w + dx, w)
            if sy1 <= sy0 or sx1 <= sx0:
                return None
            out = torch.zeros_like(x)
            out[:, sy0:sy1, sx0:sx1] = x[:, sy0 - dy:sy1 - dy,
                                         sx0 - dx:sx1 - dx]
            return out
        from siril_tpu_torch.ops.interp import warp_homography
        from siril_tpu_torch.registration.matching import match_stars
        from siril_tpu_torch.registration.starfinder import detect_stars

        m = match_stars(self.ref_stars, detect_stars(x[self.ref_layer]))
        if m is None:
            return None
        return warp_homography(x, m.H, x.shape[1:], clamp=True)

    # ------------------------------------------------------------------
    def result(self) -> Optional[SirilImage]:
        """The mean so far, clipped to [0, 1], fetched to the host."""
        with self._lock:
            if self.acc is None:
                return None
            mean = torch.clamp(self.acc / max(self.count, 1), 0.0, 1.0)
            img = SirilImage(data=mean.float().cpu().numpy())
        img.keywords.stackcnt = self.count
        img.log_history(f"Live stack of {self.count} frames")
        return img

    def save_result(self) -> None:
        from siril_tpu_torch.io.fits_io import write_fits

        img = self.result()
        if img is not None:
            write_fits(img, os.path.join(self.dir, self.cfg.out_name),
                       bitdepth=FLOAT_IMG)

    def _report(self) -> None:
        """The running mean's background and noise, in the log; the
        statistics of its first layer run where the sum lies
        (``compute_stats_tensor``; the JAX package fetches the mean and
        takes them in numpy, livestack.py:207-214)."""
        from siril_tpu_torch.ops.statistics import (
            STATS_BASIC,
            compute_stats_tensor,
        )

        with self._lock:
            if self.acc is None:
                return
            mean = torch.clamp(self.acc[0] / max(self.count, 1), 0.0,
                               1.0).float()
        st = compute_stats_tensor(mean, STATS_BASIC)
        _log.info("livestack: %d frames, bg %.5f, noise %.2e", self.count,
                  st.median, st.bgnoise)
