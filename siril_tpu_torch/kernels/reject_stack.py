"""Kernel K1 — fused normalize + reject + mean over an (N, P) frame stack,
for every rejection mode (K1a window modes, K1b SIGMEDIAN, K1c LINEARFIT,
K1d GESDT) and the weighted mean (K1e), written in CUDA C++ for Hopper
(``csrc/reject_stack.cu``).

Replaces the TPU kernel ``siril_tpu/pallas/reject_stack.py::
pallas_reject_mean`` (:763).  Bound on an H100: the function reads the
stack once (plus the weights) and writes 12 bytes per pixel (~90 µs for a
main-path block of 24 × 2.8 Mpix float32); see the source's header for
its two paths (registers up to 32 frames, and up to 48 or 64 for some
modes; tiles of columns in shared memory past that).  Any frame count
works: where a tile of 32 columns fits no block's shared memory (past
1698 frames, or 875 with a weighted mean), the tiles live in a global
scratch buffer that this wrapper allocates.

``reject_mean`` takes a CPU tensor to the plain version
(``ops/stacking.reject_stack_plain``) and a CUDA tensor to the kernel,
built with nvcc at first use and bound through ctypes.  There is no
fallback from one to the other.  ``launches`` counts the calls that
launched the kernel, by variant: on the register path "K1e" for a
weighted mean, else "K1a" (window modes), "K1b", "K1c" or "K1d"; past it
"K1col", the column kernel, for every mode.
``capped_pixels`` counts, for either version, the SIGMEDIAN pixels whose
loop stopped at ``SIGMEDIAN_MAX_ROUNDS`` while still replacing values and
the winsorized clipping rounds whose σ iteration stopped at
``WINSOR_MAX_STEPS`` before σ settled.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from siril_tpu_torch.kernels import build
from siril_tpu_torch.ops.rejection import (
    GESDT,
    LINEARFIT,
    SIGMEDIAN,
    check_rtype,
    linearfit_constants,
)
from siril_tpu_torch.ops.stacking import reject_stack_plain

#: kernel-launching calls by variant, K1a … K1e and K1col, since the last
#: reset
launches = dict.fromkeys(("K1a", "K1b", "K1c", "K1d", "K1e", "K1col"), 0)
#: per device, an int64 scalar: loops stopped at their mode's bound
_capped = {}


def variant(rtype: int, weighted: bool, n: int) -> str:
    """The K1 variant a call of ``n`` frames runs: past the register path
    (the library's ``siril_reject_stack_register_path``) the column kernel
    (K1col), else K1e for a weighted mean, else by mode.  Builds the
    library at first use."""
    if not _library().siril_reject_stack_register_path(n, int(rtype),
                                                        int(weighted)):
        return "K1col"
    if weighted:
        return "K1e"
    return {SIGMEDIAN: "K1b", LINEARFIT: "K1c", GESDT: "K1d"}.get(rtype,
                                                                  "K1a")


def reset_counts() -> None:
    """Set every launch count and the capped-pixel count to 0."""
    for key in launches:
        launches[key] = 0
    for t in _capped.values():
        t.zero_()


def _capped_counter(device: torch.device) -> torch.Tensor:
    if device not in _capped:
        _capped[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _capped[device]


def capped_pixels() -> int:
    """Loops stopped at their bound since the last reset: SIGMEDIAN pixels
    still replacing values after ``SIGMEDIAN_MAX_ROUNDS`` rounds, and
    winsorized rounds whose σ had not settled after ``WINSOR_MAX_STEPS``
    steps.  The reference would have run them further.  Waits for the
    card."""
    return sum(int(t) for t in _capped.values())


#: bytes of global scratch a call may use (about; at least 128 columns)
SCRATCH_BYTES = 512 << 20

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # stack, i16, n, p
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,          # scale, offset, mul
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,      # weights, strides
    ctypes.c_void_p,                                            # critical
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,  # rtype, mode, sig
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,  # n_full, max_out, m_x, 1/m_dx2
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,          # mean, rejl, rejh
    ctypes.c_void_p, ctypes.c_int,                              # scratch, cols
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # capped, queue, stream
]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's entry points."""
    lib.siril_reject_stack.argtypes = _ARGTYPES
    lib.siril_reject_stack.restype = ctypes.c_int
    for name in ("siril_reject_stack_needs_scratch",
                 "siril_reject_stack_register_path"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    lib = build.load("reject_stack")
    if lib.siril_reject_stack.argtypes is None:
        bind(lib)
    return lib


def _check(stack, scale, offset, mul, weights, critical, rtype,
           max_outliers):
    if stack.dim() != 2:
        raise ValueError(f"stack must be (N, P), got {tuple(stack.shape)}")
    if stack.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"stack must be float32 or int16, got {stack.dtype}")
    n, p = stack.shape
    for name, v in (("scale", scale), ("offset", offset), ("mul", mul)):
        if v.dtype != torch.float32 or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},)")
        if v.device != stack.device:
            raise ValueError(f"{name} is on {v.device}, stack on "
                             f"{stack.device}")
    if weights is not None:
        if weights.dtype != torch.float32 or weights.dim() != 2 or \
                weights.shape[0] != n or weights.shape[1] not in (1, p):
            raise ValueError(f"weights must be float32 of shape ({n}, {p}) "
                             f"or ({n}, 1), got {tuple(weights.shape)}")
        if weights.device != stack.device:
            raise ValueError(f"weights are on {weights.device}, stack on "
                             f"{stack.device}")
    check_rtype(rtype)
    if rtype == GESDT:
        if critical is None or len(critical) < max(int(max_outliers), 1):
            raise ValueError("GESDT needs a λ table of at least "
                             "max(max_outliers, 1) entries")


def reject_mean(stack: torch.Tensor, scale: torch.Tensor,
                offset: torch.Tensor, mul: torch.Tensor, *, rtype: int,
                mode: int, siglow: float, sighigh: float,
                weights: Optional[torch.Tensor] = None, critical=None,
                n_full: int = 0, max_outliers: int = 0):
    """(N, P) float32 or raw int16 stack and (N,) per-frame coefficients →
    (mean f32, rej_low i32, rej_high i32), each (P,).

    ``weights``: (N, P), or (N, 1) per frame (passed to the kernel with a
    pixel stride of 0), for the weighted mean.  ``critical``: the GESDT λ
    table (``rejection.gesdt_critical_values``); ``n_full``: the frame
    count of the LINEARFIT constants and the GESDT budget (default N)."""
    _check(stack, scale, offset, mul, weights, critical, rtype,
           max_outliers)
    n, p = stack.shape
    n_full = int(n_full) or n
    if stack.device.type == "cpu":
        return reject_stack_plain(stack, scale, offset, mul, rtype=rtype,
                                  mode=mode, siglow=siglow, sighigh=sighigh,
                                  weights=weights, critical=critical,
                                  n_full=n_full, max_outliers=max_outliers,
                                  capped=_capped_counter(stack.device))
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    if not (stack.is_contiguous() and scale.is_contiguous()
            and offset.is_contiguous() and mul.is_contiguous()):
        raise ValueError("reject_mean needs contiguous tensors")
    if p >= 2 ** 31:
        raise ValueError("reject_mean takes fewer than 2**31 pixels a call")
    dev = stack.device
    lib = _library()
    w_ptr, w_sn, w_sp = None, 0, 0
    if weights is not None:
        w = weights.expand(n, p)
        w_ptr, w_sn, w_sp = w.data_ptr(), w.stride(0), w.stride(1)
    crit = None
    if rtype == GESDT:
        crit = torch.as_tensor(critical, dtype=torch.float32,
                               device=dev).contiguous()
    m_x, inv_mdx2 = linearfit_constants(n_full)
    scratch, cols = None, 0
    if lib.siril_reject_stack_needs_scratch(n, int(rtype),
                                            int(weights is not None)):
        cols = max(128, min(p, SCRATCH_BYTES // (2 * n * 4)) // 128 * 128)
        words = (n + 31) // 32
        scratch = torch.empty((2 * n + 2 * words) * cols,
                              dtype=torch.float32, device=dev)
    # the counter of pixels or tiles handed out, set to 0 on the stream
    # before the kernel.  crit, scratch and queue may be freed on return
    # while the kernel runs: the caching allocator hands their memory only
    # to later work on this stream, which runs after the kernel
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    mean = torch.empty(p, dtype=torch.float32, device=dev)
    rejl = torch.empty(p, dtype=torch.int32, device=dev)
    rejh = torch.empty(p, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.siril_reject_stack(
            stack.data_ptr(), int(stack.dtype == torch.int16), n, p,
            scale.data_ptr(), offset.data_ptr(), mul.data_ptr(),
            w_ptr, w_sn, w_sp, None if crit is None else crit.data_ptr(),
            int(rtype), int(mode), float(siglow), float(sighigh), n_full,
            int(max_outliers), m_x, inv_mdx2, mean.data_ptr(),
            rejl.data_ptr(), rejh.data_ptr(),
            None if scratch is None else scratch.data_ptr(), cols,
            _capped_counter(dev).data_ptr(), queue.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"reject_stack kernel launch failed: CUDA "
                           f"error {rc}")
    launches[variant(rtype, weights is not None, n)] += 1
    return mean, rejl, rejh
