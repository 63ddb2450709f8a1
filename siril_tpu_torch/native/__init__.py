"""Host C++ of the port, built at first use and bound through ctypes —
counterpart of the Rice and raw-decoder parts of
``siril_tpu/native/__init__.py`` (signatures :82-100,
``rice_encode_tiles_i16``:170, ``rice_decode_tiles_i16``:193,
``decode_nikon``:172, ``decode_ljpeg``:192, ``decode_panasonic``:273).

``rice.cpp`` (the RICE_1 tile coder) and ``decoders.cpp`` (the lossless
JPEG, Nikon Huffman and Panasonic decoders of camera raw, and the PNG row
filters of ``io/image_formats.py``) are compiled
with the host compiler (``g++ -O3``, Rice with OpenMP) into
``siril_tpu_torch/_build/`` (gitignored), each named by a hash of its
source.  A failed build raises, and so does a stream that does not
decode: the Python coders of ``io/fits_compress.py``, ``io/dng.py`` and
``io/rawfile.py`` are the plain versions the tests hold these against,
and no path falls back to them (their per-bit loops take minutes on a
full frame).  The JAX package falls back to them instead
(``siril_tpu/native/__init__.py:1-7``).
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
DEC_SRC = os.path.join(_HERE, "decoders.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_dec_lib = None


def library_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()
                              ).hexdigest()[:12]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(src: str) -> str:
    """Compile ``src`` unless it is built; returns the library."""
    out = library_path(src)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build(SRC))
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


def decoders_lib() -> ctypes.CDLL:
    global _dec_lib
    with _lock:
        if _dec_lib is None:
            so = ctypes.CDLL(build(DEC_SRC))
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i32p = ctypes.POINTER(i32)
            so.decode_ljpeg.argtypes = [u8p, i64, u16p, i64, i32p, i32p,
                                        i32p]
            so.decode_ljpeg.restype = ctypes.c_int
            so.decode_nikon.argtypes = [u8p, i64, i32, i32, i32, u16p, i32,
                                        u16p]
            so.decode_nikon.restype = ctypes.c_int
            so.decode_panasonic.argtypes = [u8p, i64, i32, i32, i32, u16p]
            so.decode_panasonic.restype = ctypes.c_int
            so.png_unfilter.argtypes = [u8p, i64, i64, i32, u8p]
            so.png_unfilter.restype = ctypes.c_int
            _dec_lib = so
        return _dec_lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: the stream does not decode (code {rc})")


def decode_ljpeg(data: bytes) -> Tuple[np.ndarray, int]:
    """A lossless-JPEG (SOF3) stream → ((h, w·ncomp) uint16, ncomp)."""
    i = data.find(b"\xff\xc3")
    if i < 0 or i + 10 > len(data):
        raise ValueError("lossless JPEG: no SOF3 header")
    h = int.from_bytes(data[i + 5:i + 7], "big")
    w = int.from_bytes(data[i + 7:i + 9], "big")
    nc = data[i + 9]
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(max(h * w * nc, 1), np.uint16)
    ow, oh, onc = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    _check(decoders_lib().decode_ljpeg(
        _ptr(buf, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint16),
        out.size, ctypes.byref(ow), ctypes.byref(oh), ctypes.byref(onc)),
        "lossless JPEG")
    n = oh.value * ow.value * onc.value
    return out[:n].reshape(oh.value, ow.value * onc.value), onc.value


def decode_nikon(data: bytes, width: int, height: int, tree: int,
                 vpred: np.ndarray, split: int) -> np.ndarray:
    """A Nikon-compressed NEF strip → (height, width) pre-curve uint16."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(height * width, np.uint16)
    vp = np.ascontiguousarray(vpred, np.uint16)
    _check(decoders_lib().decode_nikon(
        _ptr(buf, ctypes.c_uint8), len(data), width, height, tree,
        _ptr(vp, ctypes.c_uint16), split, _ptr(out, ctypes.c_uint16)),
        "Nikon NEF")
    return out.reshape(height, width)


def decode_panasonic(data: bytes, width: int, height: int,
                     load_flags: int = 0x2008) -> np.ndarray:
    """A Panasonic RW2 v4 bitstream → (height, width) uint16."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(height * width, np.uint16)
    _check(decoders_lib().decode_panasonic(
        _ptr(buf, ctypes.c_uint8), len(data), width, height, load_flags,
        _ptr(out, ctypes.c_uint16)), "Panasonic RW2")
    return out.reshape(height, width)


def png_unfilter(data: bytes, height: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """The (height, rowbytes) uint8 rows of an inflated PNG image, each
    row's filter undone."""
    if len(data) < height * (rowbytes + 1):
        raise ValueError("PNG: image data shorter than its header says")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    _check(decoders_lib().png_unfilter(
        _ptr(buf, ctypes.c_uint8), height, rowbytes, max(int(bpp), 1),
        _ptr(out, ctypes.c_uint8)), "PNG")
    return out
