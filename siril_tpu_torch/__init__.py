"""siril_tpu_torch — the PyTorch/CUDA port of siril_tpu.

The JAX package ``siril_tpu`` stays the reference; this package sits beside
it, mirrors its module paths, and imports neither ``jax`` nor anything of
``siril_tpu``.  Hot device work runs on a CUDA card by default; callers pass
``device="cpu"`` to run the plain PyTorch versions (the tests do).

Ported so far: the standard preprocessing script through the CLI's
script runner (``cli/``: convert, link, calibrate, register, seqapplyreg,
stack, on ``.seq`` sequences; ``ops/calibration.py``, ``ops/cosmetic.py``,
``registration/global_reg.py``, ``core/engine.py``, ``io/seqfile.py``), the
``fusedstack`` path with calibration (``pipeline.fused_preprocess_stack``,
shift registration) and the staged ``stack`` command
(``ops/stacking.stack_sequence``), with the rejection stack — every
rejection mode and the weighted mean — as a hand-written CUDA kernel
(``kernels/reject_stack.py``, ``csrc/reject_stack.cu``); one-shot-colour
sessions (``ops/demosaic.py``); drizzle (``ops/drizzle.py``); FITS of
BITPIX 8, 16, 32, −32 and −64 with tiled compression (``io/fits_io.py``,
``io/fits_compress.py``, ``native/``), SER videos and FITS cubes
(``io/ser.py``, ``core/sequence.py``); and later slices (ROADMAP):
astrometry, the post-stack, enhancement and analysis sessions, the
planetary session (``planetary/``, ``registration/shift.py``), the
image formats for ``convert`` (camera raw, DNG, XISF, IRIS ``.pic``,
TIFF / PNG / BMP / PNM in ``io/image_formats.py``), multi-device
stacking over ``torch.distributed`` (``parallel/``), live stacking
(``livestacking/``), the sequence export and the sequence and header
commands (``cli/sequence.py``); and the session surface: the preferences
(``core/settings.py``, the active ones being the session's), undo and
redo (``core/undo.py``), the operation descriptors (``core/opdesc.py``),
the session commands (``cli/session.py``), the CLI's ``-p`` / ``-i`` /
stdin modes, the log and progress fan-out (``utils/log.py``), the
sirilpy wire protocol and ``pyscript`` (``pythonmodule/``), the stage
timers and the ``torch.profiler`` device trace (``utils/trace.py``), the
compute probe and the FITS comparator (``tools/``), the plots
(``utils/splot.py``), the script repository and the update check.  The
command table is the JAX package's, 234 names.
"""
