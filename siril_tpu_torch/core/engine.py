"""Per-frame sequence engine — counterpart of ``siril_tpu/core/engine.py``
(``SeqArgs``:46, ``SeqResult``:63, ``_AsyncWriter``:70, ``run_sequence``
:101; reference ``core/processing.c:78`` generic_sequence_worker and
``io/seqwriter.c``).

Frames stream through three stages: a thread pool reads ``prefetch``
frames ahead, the ``image`` hook transforms each one (calibration,
registration), and WRITER_THREADS writer threads write the results with
at most ``max_inflight_writes`` frames queued.  A frame is written at its
``orig_bitdepth`` unless the command sets one (engine.py:123-125), so
frames read from 16-bit files are written as 16-bit.

Hooks: ``prepare(ctx)``, ``image(ctx, index, img)`` → SirilImage or None.
A frame that fails to read, or for which the hook returns None (a
frame's own fault: too few stars to match, no exposure to scale the
dark by), is left out of the output and unselected in the input
(processing.h:100-102).  An exception from a hook is never taken for a
frame's fault: it stops the run, whatever raised it (the device, a
library, the code).  A stop request (``core/processing.py``) is polled
between frames (engine.py:138-144): the frames done are written, the
run's input keeps its selection, and ``ProcessingCancelled`` is raised
(engine.py:192-193).  Each frame done reports its share of the run to
the progress hooks (``utils/log.log_progress``, engine.py:179: the
``-p`` pipe's ``progress:`` lines).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from siril_tpu_torch.core.processing import (
    ProcessingCancelled,
    processing_should_continue,
)
from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.utils.log import log_progress

_log = logging.getLogger(__name__)


@dataclass
class SeqArgs:
    seq: Sequence
    description: str = "Processing"
    prefix: str = ""
    prepare: Optional[Callable] = None
    image: Optional[Callable] = None
    prefetch: int = 4                 # frames read ahead
    max_inflight_writes: int = 8      # seqwriter backpressure
    output_bitdepth: Optional[int] = None
    user: dict = field(default_factory=dict)
    #: seconds per stage: the engine adds "read" (waiting for a frame)
    #: and "write" (the writer threads' busy time, summed); hooks add
    #: their own
    stage_s: dict = field(default_factory=dict)


@dataclass
class SeqResult:
    new_seq: Optional[Sequence] = None
    processed: int = 0
    failed: List[int] = field(default_factory=list)
    user: dict = field(default_factory=dict)
    stage_s: dict = field(default_factory=dict)


#: writer threads of a run: a frame's encode (numpy) and write release the
#: GIL, so a few frames are written at once
WRITER_THREADS = 3


class _AsyncWriter:
    """Writer threads behind a bounded queue (io/seqwriter.c)."""

    def __init__(self, max_inflight: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=max_inflight)
        self.errors: List[str] = []
        self.failed_tags: List[int] = []
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(WRITER_THREADS)]
        for t in self.threads:
            t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            fn, a, tag = item
            try:
                fn(*a)
            except Exception as e:      # reported as a failed frame
                self.errors.append(f"{type(e).__name__}: {e}")
                if tag is not None:
                    self.failed_tags.append(tag)

    def submit(self, fn, *a, tag=None):
        self.q.put((fn, a, tag))

    def close(self):
        for _ in self.threads:
            self.q.put(None)
        for t in self.threads:
            t.join()


def run_sequence(args: SeqArgs) -> SeqResult:
    seq = args.seq
    indices = seq.selected_indices()
    n = len(indices)
    res = SeqResult()
    ctx = args.user
    if args.prepare is not None:
        args.prepare(ctx)

    writer = _AsyncWriter(args.max_inflight_writes)
    out_dir = seq.directory
    out_name = f"{args.prefix}{seq.name}" if args.prefix \
        else f"{seq.name}_out"
    out_paths: dict = {}
    stage_s = args.stage_s
    lock = threading.Lock()

    def add(name, t):
        dt = time.perf_counter() - t
        with lock:
            stage_s[name] = stage_s.get(name, 0.0) + dt

    def write_one(pos, idx, img):
        # one FITS file a frame, whatever the input sequence's kind: a SER
        # video or a FITS cube gives ``<prefix><name><num>.fit`` files too
        # (the JAX package declares SeqArgs.output_ser and never reads it)
        from siril_tpu_torch.io.fits_io import write_fits

        t = time.perf_counter()
        num = int(seq.filenum[idx])
        path = os.path.join(out_dir,
                            f"{out_name}{num:0{seq.fixed_len}d}.fit")
        bd = args.output_bitdepth if args.output_bitdepth is not None \
            else img.orig_bitdepth
        write_fits(img, path, bitdepth=bd)
        out_paths[pos] = path
        add("write", t)

    pool = cf.ThreadPoolExecutor(max_workers=max(args.prefetch, 1))
    futures = {p: pool.submit(seq.read_frame, int(indices[p]))
               for p in range(min(args.prefetch, n))}

    def abort():
        pool.shutdown(wait=False)
        writer.close()

    cancelled = False
    try:
        for pos in range(n):
            idx = int(indices[pos])
            if not processing_should_continue():
                cancelled = True
                break
            t = time.perf_counter()
            try:
                img = futures.pop(pos).result()
            except Exception as e:
                _log.error("%s: frame %d read failed: %s", args.description,
                           idx, e)
                res.failed.append(idx)
                img = None
            add("read", t)
            nxt = pos + args.prefetch
            if nxt < n:
                futures[nxt] = pool.submit(seq.read_frame, int(indices[nxt]))
            if img is None:
                continue
            out = args.image(ctx, idx, img) if args.image else img
            if out is None:
                res.failed.append(idx)
                continue
            res.processed += 1
            writer.submit(write_one, pos, idx, out, tag=idx)
            log_progress((pos + 1) / n)
    except BaseException:
        abort()
        raise
    pool.shutdown(wait=True, cancel_futures=cancelled)
    t = time.perf_counter()
    writer.close()
    add("write wait", t)
    if cancelled:
        _log.error("%s: cancelled after %d/%d frames", args.description,
                   res.processed, n)
        raise ProcessingCancelled(args.description)
    if writer.errors:
        _log.error("%s: write errors: %s", args.description,
                   writer.errors[:3])
        for tag in writer.failed_tags:
            if tag not in res.failed:
                res.failed.append(tag)
                res.processed = max(res.processed - 1, 0)
    # skip-and-unselect: failing frames drop out of the input selection
    if res.failed:
        for idx in res.failed:
            if 0 <= idx < len(seq.incl):
                seq.incl[idx] = False
    if out_paths:
        ordered = [out_paths[p] for p in sorted(out_paths)]
        res.new_seq = Sequence.from_files(ordered, name=out_name,
                                          directory=out_dir)
    res.user = ctx
    res.stage_s = stage_s
    return res
