"""SER video container reader/writer — counterpart of
``siril_tpu/io/ser.py`` (``SerHeader``:56, ``SerFile``:116,
``SerWriter``:211, ``ticks_to_iso``:253, ``iso_to_ticks``:263; reference
``src/io/ser.c``).

A 178-byte little-endian header (``ser.h:49``), the raw frames (rows
top-down, planes interleaved), and an optional trailer of per-frame
int64 timestamps in 100 ns ticks since 0001-01-01.  As in the reference,
the LittleEndian field keeps its de-facto meaning: 0 little-endian, 1
big-endian (``ser.h:70-80``).  Frames are memory-mapped; host code.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

from siril_tpu_torch.core.image import (
    BYTE_IMG,
    USHORT_IMG,
    Keywords,
    SirilImage,
)

SER_HEADER_LEN = 178
_FILE_ID = b"LUCAM-RECORDER"

# ColorID values (ser.h:51-63)
SER_MONO = 0
SER_BAYER_RGGB = 8
SER_BAYER_GRBG = 9
SER_BAYER_GBRG = 10
SER_BAYER_BGGR = 11
SER_BAYER_CYYM = 16
SER_BAYER_YCMY = 17
SER_BAYER_YMCY = 18
SER_BAYER_MYYC = 19
SER_RGB = 100
SER_BGR = 101

_BAYER_NAMES = {
    SER_BAYER_RGGB: "RGGB",
    SER_BAYER_GRBG: "GRBG",
    SER_BAYER_GBRG: "GBRG",
    SER_BAYER_BGGR: "BGGR",
}

# .NET ticks (100ns) between 0001-01-01 and 1970-01-01
_EPOCH_TICKS = 621355968000000000


@dataclass
class SerHeader:
    lu_id: int = 0
    color_id: int = SER_MONO
    big_endian: int = 0          # de-facto meaning (0=LE)
    width: int = 0
    height: int = 0
    bit_depth: int = 16          # bits per plane (1..16)
    frame_count: int = 0
    observer: str = ""
    instrument: str = ""
    telescope: str = ""
    date: int = 0                # local ticks
    date_utc: int = 0            # UTC ticks
    timestamps: List[int] = field(default_factory=list)

    @property
    def planes(self) -> int:
        return 3 if self.color_id in (SER_RGB, SER_BGR) else 1

    @property
    def bytes_per_sample(self) -> int:
        return 2 if self.bit_depth > 8 else 1

    @property
    def frame_nbytes(self) -> int:
        return self.width * self.height * self.planes * self.bytes_per_sample


def _pack_header(h: SerHeader) -> bytes:
    def s40(s: str) -> bytes:
        return s.encode("latin-1", "replace")[:40].ljust(40, b"\x00")

    return (
        _FILE_ID
        + struct.pack("<iiiiiiI", h.lu_id, h.color_id, h.big_endian,
                      h.width, h.height, h.bit_depth, h.frame_count)
        + s40(h.observer) + s40(h.instrument) + s40(h.telescope)
        + struct.pack("<QQ", h.date, h.date_utc)
    )


def _unpack_header(buf: bytes) -> SerHeader:
    if len(buf) < SER_HEADER_LEN:
        raise ValueError("truncated SER header")
    lu_id, color_id, endian, w, hgt, depth, count = struct.unpack_from("<iiiiiiI", buf, 14)
    obs = buf[42:82].rstrip(b"\x00 ").decode("latin-1", "replace")
    ins = buf[82:122].rstrip(b"\x00 ").decode("latin-1", "replace")
    tel = buf[122:162].rstrip(b"\x00 ").decode("latin-1", "replace")
    date, date_utc = struct.unpack_from("<QQ", buf, 162)
    if depth <= 0 or depth > 16:
        depth = 16 if depth == 0 else depth
    return SerHeader(lu_id=lu_id, color_id=color_id, big_endian=endian,
                     width=w, height=hgt, bit_depth=depth, frame_count=count,
                     observer=obs, instrument=ins, telescope=tel,
                     date=date, date_utc=date_utc)


class SerFile:
    """Random-access SER reader.  Reference: ser_open_file / ser_read_frame."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            # a file id other than LUCAM-RECORDER is tolerated
            self.header = _unpack_header(f.read(SER_HEADER_LEN))
        h = self.header
        filesize = os.path.getsize(self.path)
        max_frames = (filesize - SER_HEADER_LEN) // max(h.frame_nbytes, 1)
        if h.frame_count <= 0 or h.frame_count > max_frames:
            h.frame_count = int(max_frames)
        # trailer timestamps
        ts_off = SER_HEADER_LEN + h.frame_count * h.frame_nbytes
        n_ts = (filesize - ts_off) // 8
        if n_ts >= h.frame_count:
            ts = np.fromfile(self.path, dtype="<u8", count=h.frame_count, offset=ts_off)
            h.timestamps = ts.tolist()
        dt = (">u2" if h.big_endian else "<u2") if h.bytes_per_sample == 2 else "u1"
        self._dtype = np.dtype(dt)
        self._mm = np.memmap(
            self.path, dtype=self._dtype, mode="r", offset=SER_HEADER_LEN,
            shape=(h.frame_count, h.height, h.width, h.planes),
        )

    @property
    def frame_count(self) -> int:
        return self.header.frame_count

    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def nchans(self) -> int:
        return self.header.planes

    def read_frame_raw(self, index: int) -> np.ndarray:
        """(H, W, planes) raw integer data, top-down (SER convention)."""
        return np.asarray(self._mm[index])

    def read_frame(self, index: int) -> SirilImage:
        """Frame as SirilImage (C,H,W) float32 [0,1]."""
        raw = self.read_frame_raw(index)
        h = self.header
        maxval = float((1 << h.bit_depth) - 1)
        data = raw.astype(np.float32) / np.float32(maxval)
        if h.color_id == SER_BGR:
            data = data[:, :, ::-1]
        data = np.ascontiguousarray(np.moveaxis(data, 2, 0))
        kw = Keywords()
        kw.instrume = h.instrument
        kw.telescop = h.telescope
        kw.observer = h.observer
        kw.row_order = "TOP-DOWN"
        if h.color_id in _BAYER_NAMES:
            kw.bayer_pattern = _BAYER_NAMES[h.color_id]
        if h.timestamps and index < len(h.timestamps):
            kw.date_obs = ticks_to_iso(h.timestamps[index])
        return SirilImage(
            data=data, keywords=kw,
            orig_bitdepth=USHORT_IMG if h.bytes_per_sample == 2 else BYTE_IMG)

    def read_region(self, chan: int, frame: int, y0: int, y1: int) -> np.ndarray:
        """Rows [y0,y1) of a channel of a frame, float32 [0,1] top-down."""
        h = self.header
        raw = np.asarray(self._mm[frame, y0:y1, :, chan])
        maxval = float((1 << h.bit_depth) - 1)
        return raw.astype(np.float32) / np.float32(maxval)

    def close(self) -> None:
        self._mm = None

    @property
    def fps(self) -> Optional[float]:
        ts = self.header.timestamps
        if len(ts) >= 2 and ts[-1] > ts[0]:
            return (len(ts) - 1) / ((ts[-1] - ts[0]) / 1e7)
        return None


class SerWriter:
    """Sequential/random SER writer.  Reference: ser_create_file /
    ser_write_frame_from_fit (io/ser.c)."""

    def __init__(self, path: Union[str, os.PathLike], width: int, height: int,
                 color_id: int = SER_MONO, bit_depth: int = 16,
                 observer: str = "", instrument: str = "", telescope: str = ""):
        self.path = os.fspath(path)
        self.header = SerHeader(
            color_id=color_id, width=width, height=height,
            bit_depth=bit_depth, frame_count=0,
            observer=observer, instrument=instrument, telescope=telescope,
        )
        self._f = open(self.path, "wb")
        self._f.write(_pack_header(self.header))
        self._timestamps: List[int] = []

    def write_frame(self, img: SirilImage, timestamp_ticks: Optional[int] = None) -> None:
        h = self.header
        data = img.host()           # (C,H,W) [0,1]
        if h.color_id in (SER_RGB, SER_BGR):
            if data.shape[0] != 3:
                raise ValueError("RGB SER requires 3-channel frames")
            inter = np.moveaxis(data, 0, 2)
            if h.color_id == SER_BGR:
                inter = inter[:, :, ::-1]
        else:
            inter = np.moveaxis(data[:1], 0, 2)
        maxval = float((1 << h.bit_depth) - 1)
        q = np.rint(np.clip(inter, 0.0, 1.0) * maxval)
        if h.bytes_per_sample == 2:
            raw = q.astype("<u2")
        else:
            raw = q.astype("u1")
        self._f.write(raw.tobytes())
        h.frame_count += 1
        if timestamp_ticks is not None:
            self._timestamps.append(timestamp_ticks)

    def write_raw(self, frames: np.ndarray) -> None:
        """Frames already quantized: (N, H, W) or (N, H, W, planes)
        integer samples at the writer's bit depth, written as they are."""
        h = self.header
        dt = "<u2" if h.bytes_per_sample == 2 else "u1"
        a = np.asarray(frames)
        a = a.reshape(a.shape[0], h.height, h.width, h.planes)
        self._f.write(np.ascontiguousarray(a, dtype=dt).tobytes())
        h.frame_count += a.shape[0]

    def close(self) -> None:
        if self._timestamps and len(self._timestamps) == self.header.frame_count:
            for t in self._timestamps:
                self._f.write(struct.pack("<Q", t))
            self.header.date_utc = self._timestamps[0]
        # rewrite header with final frame count
        self._f.seek(0)
        self._f.write(_pack_header(self.header))
        self._f.close()


def ticks_to_iso(ticks: int) -> str:
    """SER .NET ticks → ISO 8601 UTC string (siril_date.c equivalent)."""
    import datetime

    us = (ticks - _EPOCH_TICKS) / 10.0
    dt = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc) + \
        datetime.timedelta(microseconds=us)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]


def iso_to_ticks(iso: str) -> int:
    import datetime

    s = iso.replace("Z", "+00:00")
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    return _EPOCH_TICKS + int((dt - epoch).total_seconds() * 1e7)
