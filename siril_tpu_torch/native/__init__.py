"""Host C++ of the port, built at first use and bound through ctypes —
counterpart of the Rice part of ``siril_tpu/native/__init__.py``
(signatures :82-88, ``rice_encode_tiles_i16``:170,
``rice_decode_tiles_i16``:193).

``rice.cpp`` is compiled with the host compiler (``g++ -O3 -fopenmp``)
into ``siril_tpu_torch/_build/`` (gitignored), named by a hash of its
source.  A failed build raises: the Python RICE coder of
``io/fits_compress.py`` is the plain version the tests hold this one
against, and no path falls back to it (its per-bit loop takes minutes on
a 4096² frame).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "rice.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()
                              ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"librice-{digest}.so")


def build() -> str:
    """Compile ``rice.cpp`` unless it is built; returns the library."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            i64 = ctypes.c_int64
            i64p = ctypes.POINTER(i64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i16p = ctypes.POINTER(ctypes.c_int16)
            so.rice_encode_tiles_i16.argtypes = [i16p, i64, i64, u8p, i64,
                                                 i64p, i64p]
            so.rice_encode_tiles_i16.restype = i64
            so.rice_decode_tiles_i16.argtypes = [u8p, i64p, i64p, i64, i64,
                                                 i16p]
            so.rice_decode_tiles_i16.restype = None
            _lib = so
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rice_encode_tiles_i16(data: np.ndarray
                          ) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """RICE_1 streams (BYTEPIX 2, blocks of 32) of the rows of an
    (ntiles, tile_pix) int16 array: (heap, offsets, lengths)."""
    d = np.ascontiguousarray(data, np.int16)
    ntiles, tile_pix = d.shape
    cap = int(d.nbytes * 2 + ntiles * 64)
    heap = np.empty(cap, np.uint8)
    offsets = np.empty(ntiles, np.int64)
    lengths = np.empty(ntiles, np.int64)
    total = lib().rice_encode_tiles_i16(
        _ptr(d, ctypes.c_int16), ntiles, tile_pix, _ptr(heap, ctypes.c_uint8),
        cap, _ptr(offsets, ctypes.c_int64), _ptr(lengths, ctypes.c_int64))
    if total < 0:
        raise RuntimeError("rice_encode_tiles_i16: heap too small")
    return heap[:total].tobytes(), offsets, lengths


def rice_decode_tiles_i16(heap: bytes, offsets: np.ndarray,
                          lengths: np.ndarray, tile_pix: int) -> np.ndarray:
    """The (ntiles, tile_pix) int16 rows of RICE_1 streams."""
    hb = np.frombuffer(heap, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lengths, np.int64)
    out = np.empty((len(offs), tile_pix), np.int16)
    lib().rice_decode_tiles_i16(
        _ptr(hb, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), len(offs), tile_pix,
        _ptr(out, ctypes.c_int16))
    return out
